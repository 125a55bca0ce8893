"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card, since a CUDA kernel
has no CPU mode. This file imports no JAX, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import zipf_indices
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import gather_rows as gr
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scatter_update as su


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 45])
def test_embedding_bag_matches_plain(cuda, rng, dtype, D):
    R, B, N = 1000, 64, 700
    table = torch.randn((R, D), device=cuda).to(dtype)
    idx = torch.from_numpy(zipf_indices(rng, (N,), R)).to(cuda)
    # bags 0, 2, 4, ... only: the odd ones stay empty
    seg_np = np.sort(rng.integers(0, B // 2, N) * 2).astype(np.int32)
    seg = torch.from_numpy(seg_np).to(cuda)
    before = eb.launches
    got = ops.embedding_bag(table, idx, seg, B)
    assert eb.launches == before + 1
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, idx, seg, B),
                               rtol=1e-5, atol=1e-5)
    assert not got[1::2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_update_matches_plain(cuda, rng, dtype):
    """Row 0 real and pads present: bitwise equal, no update lost."""
    R, D = 1000, 32
    table = torch.randn((R, D), device=cuda).to(dtype)
    ids = np.concatenate([[0, 0], zipf_indices(rng, (600,), R)]).astype(np.int32)
    uniq, comb = ops.combine_duplicates(torch.from_numpy(ids).to(cuda),
                                        torch.randn((602, D), device=cuda))
    assert uniq[0].item() == 0 and (uniq < 0).any().item()
    want = ref.scatter_update_ref(table.clone(), uniq, comb)
    before = su.launches
    ops.scatter_update(table, uniq, comb)
    assert su.launches == before + 1
    assert torch.equal(table, want)


@pytest.mark.gpu
def test_combine_duplicates_matches_cpu(cuda, rng):
    ids = np.concatenate([[0], zipf_indices(rng, (999,), 500)]).astype(np.int32)
    delta = rng.standard_normal((1000, 32)).astype(np.float32)
    cu, cc = ops.combine_duplicates(torch.from_numpy(ids).to(cuda),
                                    torch.from_numpy(delta).to(cuda))
    hu, hc = ops.combine_duplicates(torch.from_numpy(ids), torch.from_numpy(delta))
    assert torch.equal(cu.cpu(), hu)
    torch.testing.assert_close(cc.cpu(), hc, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 45, 1])
def test_gather_rows_matches_plain(cuda, rng, dtype, D):
    """Bitwise; D=45 (f16/bf16: 90-byte rows) takes the narrow-chunk path."""
    R, N = 1000, 777
    table = torch.randn((R, D), device=cuda).to(dtype)
    idx = torch.from_numpy(zipf_indices(rng, (N,), R)).to(cuda)
    before = gr.launches
    got = ops.gather_rows(table, idx)
    assert gr.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, ref.gather_rows_ref(table, idx))
