"""Uniform model API: arch_type -> ModelApi(init, loss).

Only the DLRM entry is ported; the LM families come with their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import dlrm


@dataclass(frozen=True)
class ModelApi:
    init: Callable          # (generator, cfg) -> params
    loss: Callable          # (params, cfg, batch) -> scalar


_REGISTRY: dict[str, ModelApi] = {
    "dlrm": ModelApi(init=dlrm.init_dlrm, loss=dlrm.bce_loss),
}


def get_api(cfg) -> ModelApi:
    if cfg.arch_type not in _REGISTRY:
        raise NotImplementedError(
            f"the port has no {cfg.arch_type!r} model yet (ported: {list(_REGISTRY)})")
    return _REGISTRY[cfg.arch_type]
