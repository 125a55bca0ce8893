"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="whisper-base", family="audio", arch_type="whisper",
        num_layers=6, encoder_layers=6, d_model=512, num_heads=8,
        num_kv_heads=8, d_ff=2048, vocab_size=51865, rope_theta=0.0,
        act="gelu", tie_embeddings=True,
        source="arXiv:2212.04356; unverified")
    s = base.ShardingProfile(seq_shard_activations=True)
    return base.ArchBundle(model=m, sharding=s)


def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(num_layers=2, encoder_layers=2, d_model=64,
                              num_heads=4, num_kv_heads=4, d_ff=128,
                              vocab_size=512, dtype="float32", remat=False,
                              attn_chunk=64, loss_chunk=256),
        sharding=b.sharding)
