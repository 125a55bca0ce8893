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
from repro_torch.kernels import flash_attention as fa
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 1, 4, 2, 16), (2, 17, 8, 2, 16),
                                          (1, 130, 32, 4, 64), (2, 100, 16, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(cuda, dtype, B, S, Hq, Hkv, D, causal):
    """f32 within 2e-5; f16/bf16 within one output rounding (torch's
    defaults), since the kernel sums in another order."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = {"rtol": 2e-5, "atol": 2e-5} if dtype == torch.float32 else {}
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
def test_flash_attention_cache_prefix_and_offset(cuda):
    """k, v read in place from a cache prefix; queries at positions 5..13."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kc, vc = (torch.randn((2, 32, 4, 64), generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((2, 9, 32, 64), generator=g, device=cuda).to(torch.bfloat16)
    got = ops.flash_attention(q, kc[:, :14], vc[:, :14], q_offset=5)
    want = ref.flash_attention_ref(q, kc[:, :14], vc[:, :14], q_offset=5)
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(
        got, ops.flash_attention(q, kc[:, :14].contiguous(),
                                 vc[:, :14].contiguous(), q_offset=5), rtol=0, atol=0)


@pytest.mark.gpu
def test_flash_attention_refuses_unsupported_head_size(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        ops.flash_attention(q, q, q)
