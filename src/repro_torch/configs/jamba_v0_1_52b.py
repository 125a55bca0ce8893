"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", arch_type="jamba",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536, rope_theta=0.0,
        attn_layer_period=8, attn_layer_offset=4,
        moe=base.MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                           layer_period=2),
        mamba=base.MambaConfig(d_state=16, d_conv=4, expand=2),
        sub_quadratic=True, source="arXiv:2403.19887; hf")
    s = base.ShardingProfile(fsdp=True, seq_shard_activations=True,
                             context_parallel_decode=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=8, d_model=64, num_heads=4,
                              num_kv_heads=2, d_ff=128, vocab_size=512,
                              attn_layer_period=4, attn_layer_offset=1,
                              moe=base.MoEConfig(num_experts=4, top_k=2,
                                                 d_ff_expert=128,
                                                 layer_period=2),
                              dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256))
