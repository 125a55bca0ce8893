"""Uniform model API: arch_type -> ModelApi(init, loss, init_cache, prefill,
decode_step).

Every arch type of the JAX package: the DLRM, the transformer stack (dense
and MoE), qwen2-vl (the transformer stack with M-RoPE and vision embeds),
jamba, RWKV-6 and whisper (encoder and decoder). ``prefill`` and
``decode_step`` take the family's extras as keywords: qwen2-vl's
``vision_embeds`` and ``positions3``, whisper's ``frames`` or its cross
K/V ``xkv`` (the reference's ``_whisper_prefill`` / ``_whisper_decode``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.models import dlrm, rwkv6, transformer, whisper


@dataclass(frozen=True)
class ModelApi:
    init: Callable          # (generator, cfg) -> params
    loss: Callable          # (params, cfg, batch) -> scalar
    init_cache: Optional[Callable] = None   # (cfg, B, Smax, device) -> caches
    prefill: Optional[Callable] = None      # (params, cfg, tokens, caches, **extras)
    decode_step: Optional[Callable] = None  # (params, cfg, tokens, pos, caches, **extras)


_REGISTRY: dict[str, ModelApi] = {
    "transformer": ModelApi(
        init=transformer.init_lm, loss=transformer.lm_loss,
        init_cache=transformer.init_kv_cache,
        prefill=transformer.prefill, decode_step=transformer.decode_step),
    "qwen2vl": ModelApi(
        init=transformer.init_lm, loss=transformer.lm_loss,
        init_cache=transformer.init_kv_cache,
        prefill=transformer.prefill, decode_step=transformer.decode_step),
    "jamba": ModelApi(
        init=transformer.init_lm, loss=transformer.lm_loss,
        init_cache=transformer.init_kv_cache,
        prefill=transformer.prefill, decode_step=transformer.decode_step),
    "rwkv6": ModelApi(
        init=rwkv6.init_lm, loss=rwkv6.lm_loss, init_cache=rwkv6.init_kv_cache,
        prefill=rwkv6.prefill, decode_step=rwkv6.decode_step),
    "whisper": ModelApi(
        init=whisper.init_lm, loss=whisper.lm_loss, init_cache=whisper.init_kv_cache,
        prefill=whisper.prefill, decode_step=whisper.decode_step),
    "dlrm": ModelApi(init=dlrm.init_dlrm, loss=dlrm.bce_loss),
}


def get_api(cfg) -> ModelApi:
    if cfg.arch_type not in _REGISTRY:
        raise NotImplementedError(
            f"the port has no {cfg.arch_type!r} model yet (ported: {list(_REGISTRY)})")
    return _REGISTRY[cfg.arch_type]
