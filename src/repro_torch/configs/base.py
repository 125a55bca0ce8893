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


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


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
    def activation_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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
class ArchBundle:
    """Everything the launcher needs for one --arch id."""
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
