"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="llama3.2-3b", family="dense", arch_type="transformer",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256, rope_theta=500000.0,
        source="hf:meta-llama/Llama-3.2-1B; unverified")
    s = base.ShardingProfile(seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=96, num_heads=6,
                              num_kv_heads=2, d_ff=192, vocab_size=512,
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256),
        sharding=b.sharding)
