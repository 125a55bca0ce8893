"""Gradient compression for the data-parallel sync (counterpart of
``repro.distributed.compression``).

Per-tensor int8 quantisation and top-k sparsification with error
feedback: compressing the gradient sync trades accumulation noise for
collective time. ``compressed_psum`` is the drop-in for the sum over a
mesh axis. The trainer's dense sync (``train_loop.sync_dense_``) does
the plain sum and does not call it, as the reference's trainer does not.
As in the reference, the sum moves the dequantised f32 tensors: the
arithmetic is the compressed one, the bytes on the wire are not fewer.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def int8_compress(g):
    """(q int8, scale): ``g / scale`` rounded half to even and clipped to
    [-127, 127], the scale ``max|g| / 127 + 1e-12`` in g's dtype."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.to(torch.float32) * scale


def topk_compress(g, k: int):
    """(idx, vals, shape): the flat indices of the ``k`` largest |g| (in
    descending order) and g's values there."""
    flat = g.reshape(-1)
    _, idx = torch.topk(torch.abs(flat), k)
    return idx, flat[idx], tuple(g.shape)


def topk_decompress(idx, vals, shape):
    n = 1
    for d in shape:
        n *= d
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def compressed_psum(g, mesh, axis, mode: str = "int8"):
    """The sum of ``g`` over the ranks along ``axis`` of ``mesh``: each
    rank's tensor int8-quantised and dequantised first (``mode`` "int8"),
    or as it is (any other mode)."""
    if mode == "int8":
        q, scale = int8_compress(g)
        return mesh.all_reduce(int8_decompress(q, scale), axis)
    return mesh.all_reduce(g, axis)


class ErrorFeedback:
    """Residual accumulator: e_{t+1} = g_t + e_t - decode(encode(g_t + e_t)),
    the code top-k of ``k_frac`` of each leaf's elements."""

    def init(self, params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def apply(self, grads, errors, k_frac: float = 0.05):
        """(sent, new errors), trees like ``grads``."""
        sent, new_e = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(errors), strict=True):
            tot = g.to(torch.float32) + e
            k = max(1, int(tot.numel() * k_frac))
            s = topk_decompress(*topk_compress(tot, k))
            sent.append(s)
            new_e.append(tot - s)
        it_s, it_e = iter(sent), iter(new_e)
        return (tree_map(lambda _: next(it_s), grads),
                tree_map(lambda _: next(it_e), grads))
