"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="tinyllama-1.1b", family="dense", arch_type="transformer",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        d_ff=5632, vocab_size=32000, rope_theta=10000.0,
        source="arXiv:2401.02385; hf")
    s = base.ShardingProfile(seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=2, d_ff=128, vocab_size=512,
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256),
        sharding=b.sharding)
