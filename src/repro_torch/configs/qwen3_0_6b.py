"""qwen3-0.6b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="qwen3-0.6b", family="dense", arch_type="transformer",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=3072, vocab_size=151936, head_dim=128, qk_norm=True,
        rope_theta=1000000.0, source="hf:Qwen/Qwen3-8B; hf")
    s = base.ShardingProfile(seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=2, d_ff=128, vocab_size=512,
                              head_dim=16, dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256),
        sharding=b.sharding)
