"""Config registry: ``get_arch("<id>")`` / ``get_arch("<id>", smoke=True)``.

The DLRM ids and every LM id of the JAX package are registered: the dense
transformers, the MoE transformers, RWKV-6, jamba (mamba and attention,
MoE), qwen2-vl-7b (M-RoPE, vision embeds) and whisper-base (encoder and
decoder, the head tied to the token table).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (DTYPES, ArchBundle, CheckpointConfig,
                                      MambaConfig, ModelConfig, MoEConfig,
                                      TrainConfig)

__all__ = [
    "ARCH_IDS", "ArchBundle", "CheckpointConfig", "DLRM_IDS", "DTYPES",
    "LM_IDS", "MambaConfig", "ModelConfig", "MoEConfig", "TrainConfig", "get_arch",
]

DLRM_IDS = ["dlrm-rm1", "dlrm-rm2", "dlrm-rm3", "dlrm-rm4"]
LM_IDS = ["tinyllama-1.1b", "qwen3-0.6b", "llama3.2-3b", "granite-20b",
          "qwen3-moe-235b-a22b", "arctic-480b", "rwkv6-3b", "jamba-v0.1-52b",
          "qwen2-vl-7b", "whisper-base"]
ARCH_IDS = LM_IDS + DLRM_IDS

_MOD = {i: "repro_torch.configs." + i.replace("-", "_").replace(".", "_")
        for i in ARCH_IDS}


def get_arch(arch_id: str, smoke: bool = False) -> ArchBundle:
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch {arch_id!r}; the port registers {ARCH_IDS}")
    mod = importlib.import_module(_MOD[arch_id])
    return mod.smoke() if smoke else mod.full()
