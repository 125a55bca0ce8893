"""arctic-480b — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="arctic-480b", family="moe", arch_type="transformer",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000, rope_theta=10000.0,
        moe=base.MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                           dense_residual=True),
        source="hf:Snowflake/snowflake-arctic-base; hf")
    s = base.ShardingProfile(fsdp=True, seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=2, d_ff=96, vocab_size=512,
                              moe=base.MoEConfig(num_experts=4, top_k=2,
                                                 d_ff_expert=96,
                                                 dense_residual=True),
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256))
