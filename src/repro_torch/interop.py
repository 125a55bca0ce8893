"""Param trees between the two packages, through numpy.

Torch cannot reproduce ``jax.random`` draws, so tests that compare the
packages start both from the JAX package's params: the JAX side passes its
tree through ``np.asarray``, and ``params_from_numpy`` turns it into the
port's tensors. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device):
    """Nested dict/list of arrays -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays (bf16 widens to f32, exactly:
    numpy has no bf16 type of its own)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)
