"""qwen2-vl-7b — M-RoPE, dynamic resolution (stub frontend) [arXiv:2409.12191; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="qwen2-vl-7b", family="vlm", arch_type="qwen2vl",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064, rope_theta=1000000.0,
        mrope_sections=(16, 24, 24),
        source="arXiv:2409.12191; hf")
    s = base.ShardingProfile(seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=2, d_ff=128, vocab_size=512,
                              head_dim=16, mrope_sections=(2, 3, 3),
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256),
        sharding=b.sharding)
