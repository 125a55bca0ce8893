"""Configuration dataclasses (counterpart of ``repro.configs.base``).

Each ``configs/<id>.py`` builds a ``ModelConfig`` for the published
configuration (``full()``) and a reduced one for CPU tests (``smoke()``).
The fields are the JAX package's, so a config reads the same in both; the
only difference is that ``activation_dtype`` maps the dtype string to a
torch dtype.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    layer_period: int = 1           # MoE every `period` layers (jamba: 2)
    router_dtype: str = "float32"

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


MAMBA_HEAD_P = 64  # channels of an SSD head (models.mamba's scan)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        """The SSD heads of ``MAMBA_HEAD_P`` channels."""
        return self.d_inner(d_model) // MAMBA_HEAD_P


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | audio | vlm | hybrid
    arch_type: str                 # transformer | rwkv6 | jamba | whisper | qwen2vl | dlrm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) splits
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"              # mlp activation: silu (swiglu) | gelu | relu_sq
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    attn_layer_period: int = 1     # jamba: 1 attention layer per N (others: every)
    attn_layer_offset: int = 0
    # whisper (enc-dec) ------------------------------------------------------
    encoder_layers: int = 0        # >0 -> enc-dec model
    # dlrm -------------------------------------------------------------------
    dlrm_bottom_mlp: tuple[int, ...] = ()
    dlrm_top_mlp: tuple[int, ...] = ()
    dlrm_num_tables: int = 0
    dlrm_num_sparse: int = 0       # lookups per table per sample
    dlrm_rows_per_table: int = 0
    dlrm_num_dense: int = 0
    # numerics / memory ------------------------------------------------------
    dtype: str = "bfloat16"        # activation / param compute dtype
    remat: bool = True             # per-layer activation checkpointing
    attn_chunk: int = 1024         # KV-block size for chunked (flash-style) attention
    loss_chunk: int = 8192         # token-chunk for memory-efficient CE
    sub_quadratic: bool = False    # True for ssm/hybrid: long_500k allowed
    source: str = ""               # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def layer_types(self) -> tuple[str, ...]:
        """Per-layer mixer type: 'attn' or 'mamba' (jamba interleave)."""
        if self.arch_type != "jamba":
            return ("attn",) * self.num_layers
        return tuple("attn" if i % self.attn_layer_period == self.attn_layer_offset
                     else "mamba" for i in range(self.num_layers))

    @property
    def ffn_types(self) -> tuple[str, ...]:
        """Per-layer FFN type: 'dense' or 'moe'."""
        if not self.moe.enabled:
            return ("dense",) * self.num_layers
        period = self.moe.layer_period
        return tuple("moe" if period == 1 or i % period == period - 1 else "dense"
                     for i in range(self.num_layers))

    @property
    def activation_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> dict[str, int]:
        """Returns {'total': N, 'active': N_active, 'embedding': E}."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        if self.arch_type == "dlrm":
            bot, top = list(self.dlrm_bottom_mlp), list(self.dlrm_top_mlp)
            dense = sum(a * b + b for a, b in zip(bot[:-1], bot[1:], strict=True))
            dense += sum(a * b + b for a, b in zip(top[:-1], top[1:], strict=True))
            emb = self.dlrm_num_tables * self.dlrm_rows_per_table * bot[-1]
            return {"total": dense + emb, "active": dense + emb, "embedding": emb}
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = d * nq * h + 2 * d * nkv * h + nq * h * d  # q,k,v,o
        if self.qk_norm:
            per_layer_attn += 2 * h
        dense_ffn = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        moe_ffn = 0
        if self.moe.enabled:
            e, fe = self.moe.num_experts, self.moe.d_ff_expert
            moe_ffn = e * 3 * d * fe + d * e  # experts + router
            if self.moe.dense_residual:
                moe_ffn += dense_ffn
        mamba_per_layer = 0
        if self.arch_type == "jamba":
            di, ds = self.mamba.d_inner(d), self.mamba.d_state
            mamba_per_layer = (d * 2 * di + di * self.mamba.d_conv
                               + di * (2 * ds + 1) + di + di * d)
        if self.arch_type == "rwkv6":
            # time-mix (r,k,v,g,o + decay/lora) + channel-mix
            per_layer_attn = 5 * d * d + 2 * d * 64 + d
            dense_ffn = 2 * d * self.d_ff
        total = active = emb
        for lt, ft in zip(self.layer_types, self.ffn_types, strict=True):
            mix = per_layer_attn if lt == "attn" else mamba_per_layer
            total += mix + 2 * d
            active += mix + 2 * d
            if ft == "moe":
                total += moe_ffn
                act_ffn = (self.moe.top_k * 3 * d * self.moe.d_ff_expert
                           + d * self.moe.num_experts)
                if self.moe.dense_residual:
                    act_ffn += dense_ffn
                active += act_ffn
            else:
                total += dense_ffn
                active += dense_ffn
        if self.encoder_layers:
            enc = self.encoder_layers * (per_layer_attn + dense_ffn + 2 * d)
            cross = self.num_layers * (per_layer_attn + d)  # decoder cross-attn
            total += enc + cross
            active += enc + cross
        return {"total": total, "active": active, "embedding": emb}


@dataclass(frozen=True)
class CheckpointConfig:
    enabled: bool = True
    directory: str = "/tmp/repro_ckpt"
    dense_interval: int = 10       # tier-M: dense params every K steps (relaxed)
    sparse_every_step: bool = True # tier-E: embedding undo logs every step
    async_write: bool = True
    max_undo_logs: int = 64        # ring of undo logs kept before GC
    writer_deadline_s: float = 0.0 # 0 = no deadline (relaxed ckpt "stop" knob)
    pool_backend: str = "pmem"     # pool backend: pmem | dram | remote | sharded
    pool_addr: str = ""            # remote backend: unix:/path or tcp:host:port
    pool_shards: str = ""          # sharded backend: comma list of node addrs
    pool_placement: str = ""       # sharded: explicit pins "dom=idx,dom=idx"
    pool_tenant: str = "default"   # remote backend: tenant namespace on the node
    pool_quota: int = 0            # remote/sharded: byte quota (per node)
    pool_compress: str = "zlib"    # pool-side compression: none | zlib | int8
    pool_rebalance: float = 0.0    # sharded: rebalancing high watermark (0 = off)
    pool_secret: str = ""          # tcp transports: HMAC hello shared secret
    pool_replica: int = -1         # sharded: read-replica shard (-1 = none)
    pool_replica_every: int = 1    # refresh the replica every K committed steps
    pool_ckpt_replica: int = -1    # sharded: checkpoint-domain replica shard
    pool_manifest_quorum: bool = False  # sharded: 2-of-3 manifest quorum
    pool_timeout: Optional[float] = None  # rescale wire deadlines (None = defaults)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    embed_learning_rate: float = 0.1   # paper: SGD-class on embeddings
    optimizer: str = "adamw"           # dense tier
    embed_optimizer: str = "sgd"       # sparse tier (additive -> relaxed exact)
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    relaxed_lookup: bool = True        # paper's relaxed embedding lookup
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    """One cell of the reference's (arch x shape) grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ShardingProfile:
    """How the arch maps onto the (pod, data, model) mesh (the reference's
    fields; ``launch.dryrun.build_rules`` reads ``fsdp`` and
    ``seq_shard_activations``)."""
    tp: bool = True                 # shard heads/ffn over "model"
    fsdp: bool = False              # shard weights over "data" too (huge archs)
    vocab_shard: bool = True        # embedding pool rows over "model"
    expert_parallel: bool = True    # MoE experts over "model"
    seq_shard_activations: bool = False  # Megatron-SP residual stream
    context_parallel_decode: bool = False  # long_500k: shard cache seq over "data"
    lookup_strategy: str = "auto"   # near_data | table_gather | auto


@dataclass(frozen=True)
class ArchBundle:
    """Everything the launcher needs for one --arch id."""
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    sharding: ShardingProfile = field(default_factory=ShardingProfile)
