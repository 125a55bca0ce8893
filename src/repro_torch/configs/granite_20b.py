"""granite-20b — llama-arch, code, MQA kv=1 [arXiv:2405.04324; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="granite-20b", family="dense", arch_type="transformer",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152, rope_theta=10000.0,
        source="arXiv:2405.04324; hf")
    s = base.ShardingProfile(fsdp=True, seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=1, d_ff=256, vocab_size=512,
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256))
