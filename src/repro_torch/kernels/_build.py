"""Builds the port's CUDA kernels with nvcc and binds them through ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C entry
point, ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout.
The hash covers the sources and the flags, so an edited source is rebuilt
and an unchanged one is reused. ``build()`` starts one nvcc for each
missing library, all at once. Nothing is compiled when a module is
imported: the first launch builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# name -> (C symbol, argtypes); every entry returns an int status (0 = ok)
KERNELS = {
    # pass, table, dtype, idx, seg, out, partial, desc, n, num_bags, dim,
    # stream
    "embedding_bag": ("embedding_bag_launch",
                      [_I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    # table, dtype, idx, delta, n, dim, elements a chunk, stream
    "scatter_update": ("scatter_update_launch", [_P, _I, _P, _P, _I, _I, _I, _P]),
    # table, dtype, idx, delta, old, n, dim, elements a chunk, stream
    "scatter_update_logged": ("scatter_update_logged_launch",
                              [_P, _I, _P, _P, _P, _I, _I, _I, _P]),
    # table, idx, out, n, row bytes, bytes a chunk, stream
    "gather_rows": ("gather_rows_launch", [_P, _P, _P, _I, _I64, _I, _P]),
    # q, k, v, o, lse (may be null), dtype, B, Sq, Sk, Hq, Hkv, D, q/k/v
    # strides (batch, seq, head), causal, q_offset, stream
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 7 + [_I64] * 9 + [_I, _I, _P]),
    # the same arguments, f16 and bf16 only (tensor cores)
    "flash_attention_tc": ("flash_attention_tc_launch",
                           [_P] * 5 + [_I] * 7 + [_I64] * 9 + [_I, _I, _P]),
    # pass, q, k, v, o, do, lse, delta, dq, dk, dv, dtype, B, Sq, Sk, Hq,
    # Hkv, D, causal, q_offset, stream
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_I] + [_P] * 10 + [_I] * 9 + [_P]),
    # pass, q, k, v, o, do, lse, delta, dq, dk, dv, dk_part, dv_part, dtype,
    # B, Sq, Sk, Hq, Hkv, D, causal, q_offset, stream
    "flash_attention_bwd_tc": ("flash_attention_bwd_tc_launch",
                               [_I] + [_P] * 12 + [_I] * 9 + [_P]),
    # r, k, v, logw, u, s0 (may be null), y, s_fin, dtype, B, S, H, r/k/v/logw
    # strides (batch, seq, head), stream
    "wkv6": ("wkv6_launch", [_P] * 8 + [_I] * 4 + [_I64] * 12 + [_P]),
    # r, k, v, logw, u, s0, dy, ds_fin (s0, ds_fin may be null), dr, dk, dv,
    # dlogw, du_part, du, ds0 (may be null), states scratch, dtype, B, S, H,
    # r/k/v/logw strides (batch, seq, head), stream
    "wkv6_bwd": ("wkv6_bwd_launch", [_P] * 16 + [_I] * 4 + [_I64] * 12 + [_P]),
}

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or under CUDA_HOME)")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compiles every named kernel (all by default) not built yet, one nvcc
    each, in parallel.

    Returns the compiler's output (with ``-Xptxas -v``: registers, shared
    memory, spills) for each library built; raises if any build failed.
    """
    todo = [n for n in (KERNELS if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)      # atomic: concurrent builders never clash
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def entry(name: str):
    """The ctypes function of kernel ``name``, built and loaded on first use."""
    with _lock:
        if name not in _loaded:
            build((name,))
            symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _loaded[name] = fn
        return _loaded[name]


def launch(name: str, device: torch.device, *args) -> None:
    """Calls kernel ``name`` on ``device``'s current stream; raises on error."""
    fn = entry(name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with status {rc}")
