"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", arch_type="transformer",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        d_ff=1536, vocab_size=151936, head_dim=128, qk_norm=True,
        rope_theta=1000000.0,
        moe=base.MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
        source="hf:Qwen/Qwen3-30B-A3B; hf")
    s = base.ShardingProfile(fsdp=True, seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=2, d_ff=64, vocab_size=512,
                              head_dim=16,
                              moe=base.MoEConfig(num_experts=4, top_k=2,
                                                 d_ff_expert=64),
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256))
