"""rwkv6-3b — Finch, data-dependent decay, attention-free [arXiv:2404.05892; hf]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="rwkv6-3b", family="ssm", arch_type="rwkv6",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=8960, vocab_size=65536, rope_theta=0.0, act="relu_sq",
        sub_quadratic=True, source="arXiv:2404.05892; hf")
    s = base.ShardingProfile(seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, d_model=128, num_heads=2,
                              num_kv_heads=2, d_ff=256, vocab_size=512,
                              dtype="float32", remat=False,
                              loss_chunk=256),
        sharding=b.sharding)
