"""Shared model building blocks (counterpart of ``repro.models.layers``).

Params are nested dicts of tensors. Random draws come from an explicit
``torch.Generator`` and land on its device; they cannot reproduce the JAX
package's ``jax.random`` streams, so parity tests load the JAX params
through ``repro_torch.interop``.
"""
from __future__ import annotations

import math

import torch


def uniform_init(gen: torch.Generator, shape, scale: float, dtype):
    return torch.empty(shape, dtype=dtype, device=gen.device) \
        .uniform_(-scale, scale, generator=gen)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype):
    scale = math.sqrt(1.0 / d_in)
    return uniform_init(gen, (d_in, d_out), scale, dtype)
