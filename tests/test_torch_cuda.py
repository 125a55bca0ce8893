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
from repro_torch.kernels import wkv6 as wk


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
    assert eb.launches == before + eb.PASSES
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, idx, seg, B),
                               rtol=1e-5, atol=1e-5)
    assert not got[1::2].any()


def _bag_in_runs(table, idx, seg, num_bags, whole, run):
    """The kernel's order, written out: a bag of at most ``whole`` items
    summed in item order in f32; a longer one in runs of ``run`` items from
    its first, each run in item order, then the runs in run order."""
    rows = table.float()[idx.long()]
    out = torch.zeros((num_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    bounds = torch.searchsorted(seg, torch.arange(num_bags + 1, device=seg.device,
                                                  dtype=torch.int32)).tolist()
    for b in range(num_bags):
        total = torch.zeros_like(out[b])
        step = whole if bounds[b + 1] - bounds[b] <= whole else run
        for r0 in range(bounds[b], bounds[b + 1], step):
            acc = torch.zeros_like(out[b])
            for j in range(r0, min(r0 + step, bounds[b + 1])):
                acc = acc + rows[j]
            total = total + acc
        out[b] = total
    return out


@pytest.mark.gpu
# d 32 bf16 reads two elements a thread, d 2,048 16 bytes (128 bags)
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 32), (torch.float32, 2048),
                                     (torch.bfloat16, 2048)])
def test_embedding_bag_long_bags(cuda, rng, dtype, D):
    """One bag of 1,203 items (38 runs), bags of 32, 80, 81 and 161 items
    around the run lengths, empty bags between and after them (128 bags):
    equal to the plain version within 1e-5, bitwise equal to the kernel's
    own order written out, +0 in the empty bags, and bitwise equal on
    repeat. The rows are of the size of the LM step's row gradients (1e-3),
    whose duplicates this combines; the plain version on the card sums with
    atomics, in no fixed order."""
    sizes = [3, 0, 1203, 0, 80, 81, 0, 161, 1, 32] + [0] * 118
    seg_np = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    R = 500
    table = (torch.randn((R, D), device=cuda) * 1e-3).to(dtype)
    idx = torch.from_numpy(zipf_indices(rng, (seg_np.size,), R)).to(cuda)
    seg = torch.from_numpy(seg_np).to(cuda)
    got = ops.embedding_bag(table, idx, seg, len(sizes))
    again = ops.embedding_bag(table, idx, seg, len(sizes))
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, idx, seg, len(sizes)),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, _bag_in_runs(table, idx, seg, len(sizes), eb.WHOLE,
                                         eb.RUN))
    assert torch.equal(got, again)
    empty = torch.tensor([n == 0 for n in sizes], device=cuda)
    assert not got[empty].any()


def _route_counts(mod):
    return mod.launches, mod.wide_launches, mod.narrow_launches


def _assert_one_launch(mod, before, wide):
    """One more launch of ``mod``'s kernel, counted on its 16-byte route
    when ``wide``, else on its narrow one."""
    n, w, nw = before
    assert _route_counts(mod) == (n + 1, w + wide, nw + (not wide))


WIDTHS = [1, 45, 32, 2047, 2048, 2560]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", WIDTHS)
def test_scatter_update_matches_plain(cuda, rng, dtype, D):
    """Row 0 real and pads present: bitwise equal, no update lost, the same
    bits again on a second copy; rows whose bytes are a multiple of 16 take
    the 16-byte route, the ragged ones the narrow route."""
    R = 1000
    table = torch.randn((R, D), device=cuda).to(dtype)
    ids = np.concatenate([[0, 0], zipf_indices(rng, (600,), R)]).astype(np.int32)
    uniq, comb = ops.combine_duplicates(torch.from_numpy(ids).to(cuda),
                                        torch.randn((602, D), device=cuda))
    assert uniq[0].item() == 0 and (uniq < 0).any().item()
    want = ref.scatter_update_ref(table.clone(), uniq, comb)
    again = table.clone()
    before = _route_counts(su)
    ops.scatter_update(table, uniq, comb)
    _assert_one_launch(su, before, D * table.element_size() % 16 == 0)
    assert torch.equal(table, want)
    ops.scatter_update(again, uniq, comb)
    assert torch.equal(again, table)


def _pads_anywhere(rng, case):
    """(R, D, ids) of a case: real rows unique, pads (-1) among them."""
    if case == "empty":
        return 10, 32, np.zeros(0, np.int32)
    if case == "pads only":
        return 9, 16, np.full(7, -1, np.int32)
    R, D, N = {"interleaved": (8000, 32, 5000), "interleaved wide": (900, 2048, 600),
               "many rounds": (3_000_000, 1, 2_500_000)}[case]
    ids = rng.permutation(R)[:N].astype(np.int32)
    ids[rng.random(N) < 0.5] = -1
    return R, D, ids


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["interleaved", "interleaved wide", "many rounds",
                                  "pads only", "empty"])
def test_scatter_update_pads_anywhere(cuda, rng, dtype, case):
    """Pads (-1) anywhere among the real slots, not only trailing: only the
    real rows change, bitwise as the plain version, the same bits on a
    second copy; 2,500,000 slots make each block stage several rounds; a
    call of pads only launches and changes nothing; an empty call does not
    launch."""
    R, D, ids = _pads_anywhere(rng, case)
    idx = torch.from_numpy(ids).to(cuda)
    table = torch.randn((R, D), device=cuda).to(dtype)
    delta = torch.randn((ids.size, D), device=cuda)
    want = ref.scatter_update_ref(table.clone(), idx, delta)
    again = table.clone()
    before = _route_counts(su)
    ops.scatter_update(table, idx, delta)
    if ids.size:
        _assert_one_launch(su, before, D * table.element_size() % 16 == 0)
    else:
        assert _route_counts(su) == before
    assert torch.equal(table, want)
    ops.scatter_update(again, idx, delta)
    assert torch.equal(again, table)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_scatter_update_misaligned_view(cuda, rng, dtype):
    """A table whose base is one element into its buffer (2-byte aligned for
    16-bit types, 4 for f32) refuses the 16-byte route: the narrow route
    updates it bitwise and leaves the element before it alone."""
    R, D = 300, 2048
    flat = torch.randn(R * D + 1, device=cuda).to(dtype)
    table = flat[1:].view(R, D)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    ids = rng.permutation(R)[:200].astype(np.int32)
    ids[::3] = -1
    idx = torch.from_numpy(ids).to(cuda)
    delta = torch.randn((200, D), device=cuda)
    want = ref.scatter_update_ref(table.clone(), idx, delta)
    head = flat[0].clone()
    before = _route_counts(su)
    ops.scatter_update(table, idx, delta)
    _assert_one_launch(su, before, False)
    assert torch.equal(table, want) and torch.equal(flat[0], head)


def _logged_counts():
    return su.launches_logged, su.wide_launches_logged, su.narrow_launches_logged


def _check_logged(table, idx, delta, wide):
    """The logged update of ``table`` in place against its plain version:
    the table and the undo rows bitwise, the pads' undo rows all-zero bits,
    one launch counted on the 16-byte route when ``wide``, else on the
    narrow one (none for N = 0), and the same bits again on a second copy."""
    bits = torch.int32 if table.element_size() == 4 else torch.int16
    want_t, want_old = ref.scatter_update_logged_ref(table.clone(), idx, delta)
    again = table.clone()
    n, w, nw = _logged_counts()
    _, old = ops.scatter_update_logged(table, idx, delta)
    if idx.numel():
        assert _logged_counts() == (n + 1, w + wide, nw + (not wide))
    else:
        assert _logged_counts() == (n, w, nw)
    assert old.dtype == table.dtype and old.shape == (idx.numel(), table.shape[1])
    assert torch.equal(table.view(bits), want_t.view(bits))
    assert torch.equal(old.view(bits), want_old.view(bits))
    assert not old[idx < 0].view(bits).any()
    _, old_again = ops.scatter_update_logged(again, idx, delta)
    assert torch.equal(again.view(bits), table.view(bits))
    assert torch.equal(old_again.view(bits), old.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", WIDTHS)
def test_scatter_update_logged_matches_plain(cuda, rng, dtype, D):
    """Row 0 real and pads present: the table and the undo rows bitwise
    equal to the plain version's (the pads' rows +0, from torch.empty), the
    same bits again on a second copy; rows whose bytes are a multiple of 16
    take the 16-byte route, the ragged ones the narrow route."""
    R = 1000
    table = torch.randn((R, D), device=cuda).to(dtype)
    ids = np.concatenate([[0, 0], zipf_indices(rng, (600,), R)]).astype(np.int32)
    uniq, comb = ops.combine_duplicates(torch.from_numpy(ids).to(cuda),
                                        torch.randn((602, D), device=cuda))
    assert uniq[0].item() == 0 and (uniq < 0).any().item()
    _check_logged(table, uniq, comb, D * table.element_size() % 16 == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["interleaved", "interleaved wide", "many rounds",
                                  "pads only", "empty"])
def test_scatter_update_logged_pads_anywhere(cuda, rng, dtype, case):
    """Pads (-1) anywhere among the real slots: only the real rows change
    and every pad logs a zero row, bitwise as the plain version; 2,500,000
    slots make each block stage several rounds; a call of pads only
    launches, logs zeros and changes nothing; an empty call does not
    launch."""
    R, D, ids = _pads_anywhere(rng, case)
    idx = torch.from_numpy(ids).to(cuda)
    table = torch.randn((R, D), device=cuda).to(dtype)
    delta = torch.randn((ids.size, D), device=cuda)
    _check_logged(table, idx, delta, D * table.element_size() % 16 == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_scatter_update_logged_misaligned_view(cuda, rng, dtype):
    """A table one element into its buffer refuses the 16-byte route: the
    narrow route updates and logs it bitwise and leaves the element before
    it alone."""
    R, D = 300, 2048
    flat = torch.randn(R * D + 1, device=cuda).to(dtype)
    table = flat[1:].view(R, D)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    ids = rng.permutation(R)[:200].astype(np.int32)
    ids[::3] = -1
    head = flat[0].clone()
    _check_logged(table, torch.from_numpy(ids).to(cuda), torch.randn((200, D), device=cuda),
                  False)
    assert torch.equal(flat[0], head)


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
@pytest.mark.parametrize("D", WIDTHS)
def test_gather_rows_matches_plain(cuda, rng, dtype, D):
    """Bitwise, and again on a second call; rows whose bytes are a multiple
    of 16 take the 16-byte route, the others (D=45 in f16/bf16: 90-byte
    rows) the narrow route."""
    R, N = 1000, 777
    table = torch.randn((R, D), device=cuda).to(dtype)
    idx = torch.from_numpy(zipf_indices(rng, (N,), R)).to(cuda)
    before = _route_counts(gr)
    got = ops.gather_rows(table, idx)
    _assert_one_launch(gr, before, D * table.element_size() % 16 == 0)
    assert got.dtype == dtype and torch.equal(got, ref.gather_rows_ref(table, idx))
    assert torch.equal(ops.gather_rows(table, idx), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_gather_rows_misaligned_view(cuda, rng, dtype):
    """A table one element into its buffer refuses the 16-byte route; the
    narrow route copies it bitwise."""
    R, D = 300, 2048
    flat = torch.randn(R * D + 1, device=cuda).to(dtype)
    table = flat[1:].view(R, D)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    idx = torch.from_numpy(zipf_indices(rng, (500,), R)).to(cuda)
    before = _route_counts(gr)
    got = ops.gather_rows(table, idx)
    _assert_one_launch(gr, before, False)
    assert torch.equal(got, ref.gather_rows_ref(table, idx))
    assert torch.equal(ops.gather_rows(table, idx), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,N", [(torch.bfloat16, 8, 300_000),
                                       (torch.float32, 1, 2_500_000)])
def test_gather_rows_many_slots(cuda, rng, dtype, D, N):
    """Zipf ids, so many duplicates, and more granules of 32 slots than the
    persistent grid has warps: some warps walk two (300,000 slots), every
    warp several (2,500,000). Bitwise, and again on a second call."""
    R = 50_000
    table = torch.randn((R, D), device=cuda).to(dtype)
    idx = torch.from_numpy(zipf_indices(rng, (N,), R)).to(cuda)
    got = ops.gather_rows(table, idx)
    assert torch.equal(got, ref.gather_rows_ref(table, idx))
    assert torch.equal(ops.gather_rows(table, idx), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 1, 4, 2, 16), (2, 17, 8, 2, 16),
                                          (1, 130, 32, 4, 64), (2, 100, 16, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(cuda, dtype, B, S, Hq, Hkv, D, causal):
    """f32 within 2e-5; f16/bf16 within one output rounding (torch's
    defaults), since the kernel sums in another order. f16 and bf16 run on
    the tensor-core route (its launch count says so) and repeat bitwise."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before, before_tc = fa.launches, fa.tc_launches
    got = ops.flash_attention(q, k, v, causal=causal)
    tc = dtype != torch.float32
    assert (fa.launches, fa.tc_launches) == (before + 1, before_tc + tc)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = {"rtol": 2e-5, "atol": 2e-5} if dtype == torch.float32 else {}
    torch.testing.assert_close(got, want, **tol)
    if tc:
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.gpu
def test_flash_attention_cache_prefix_and_offset(cuda):
    """k, v read in place from a cache prefix; queries at positions 5..13."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kc, vc = (torch.randn((2, 32, 4, 64), generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((2, 9, 32, 64), generator=g, device=cuda).to(torch.bfloat16)
    before_tc = fa.tc_launches
    got = ops.flash_attention(q, kc[:, :14], vc[:, :14], q_offset=5)
    assert fa.tc_launches == before_tc + 1        # the tensor-core route
    want = ref.flash_attention_ref(q, kc[:, :14], vc[:, :14], q_offset=5)
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(
        got, ops.flash_attention(q, kc[:, :14].contiguous(),
                                 vc[:, :14].contiguous(), q_offset=5), rtol=0, atol=0)


# The tensor-core forward against its plain emulation
# (ref.flash_attention_ref(..., p_dtype=dtype): P carried as two terms of the
# input type): both round the same f32 value to within a few units in the
# 24th bit, so they agree within one unit in the last place of the output
# type (2^-7 of the value in bf16, 2^-10 in f16; atol 1e-5 near 0).
TC_FWD_EMUL_TOL = {torch.bfloat16: (2**-7, 1e-5), torch.float16: (2**-10, 1e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tc_lse_and_emulation(cuda, dtype, D, causal):
    """The f16/bf16 forward: 100 queries at positions 30..129 over 130 keys,
    GQA 8/2. Its log-sum-exp within 1e-5 of the plain version's, its output
    within one unit in the last place of the split-P emulation, both bitwise
    on repeat."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((2, 100, 8, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, 130, 2, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = {"causal": causal, "q_offset": 30}
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    o2, lse2 = ops.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _, lse_want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, lse_want, rtol=1e-5, atol=1e-5)
    rtol, atol = TC_FWD_EMUL_TOL[dtype]
    torch.testing.assert_close(o, ref.flash_attention_ref(q, k, v, p_dtype=dtype, **kw),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_flash_attention_tc_refuses_misaligned_inputs(cuda):
    """The tensor-core route's TMA copies need 16-byte bases and strides;
    a base 2 bytes off raises, where the f32 route's 4-element rule would
    pass it."""
    flat = torch.randn(2 * 8 * 4 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(2, 8, 4, 64)
    assert q.data_ptr() % 16
    k = torch.randn((2, 8, 2, 64), device=cuda).to(torch.bfloat16)
    before = (fa.launches, fa.tc_launches)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, k, k)
    assert (fa.launches, fa.tc_launches) == before


@pytest.mark.gpu
def test_flash_attention_refuses_unsupported_head_size(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        ops.flash_attention(q, q, q)


def _wkv_inputs(dev, B, S, H, dtype, with_s0, seed=0):
    """r, k, v in ``dtype``; logw spread over the whole clamp range
    [-5, -1e-4]; u and s0 f32 (s0 None when not ``with_s0``)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    r, k, v = (rand(B, S, H, 64, scale=0.5).to(dtype) for _ in range(3))
    logw = torch.clamp(-torch.exp(rand(B, S, H, 64, scale=1.5) - 1.0), -5.0, -1e-4)
    u = rand(H, 64, scale=0.3)
    s0 = rand(B, H, 64, 64, scale=0.1) if with_s0 else None
    return r, k, v, logw, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 31, 63, 64, 65, 100, 1024, 4096])
@pytest.mark.parametrize("B,H", [(1, 1), (2, 2), (4, 40)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_matches_plain(cuda, dtype, S, B, H, with_s0):
    """y and the final state within 3e-4 (the tolerance the Pallas kernel
    is held to in tests/test_kernels.py), ragged last chunks and S = 1
    included; one launch a call, on the decode route exactly when S = 1."""
    r, k, v, logw, u, s0 = _wkv_inputs(cuda, B, S, H, dtype, with_s0)
    before, before_dec = wk.launches, wk.decode_launches
    y, s_fin = ops.wkv6(r, k, v, logw, u, s0)
    assert wk.launches == before + 1
    assert wk.decode_launches == before_dec + (S == 1)
    y_want, s_want = ref.wkv6_ref(r, k, v, logw, u, s0)
    assert y.dtype == s_fin.dtype == torch.float32
    torch.testing.assert_close(y, y_want, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(s_fin, s_want, rtol=3e-4, atol=3e-4)


@pytest.mark.gpu
def test_wkv6_state_in_place_strided_and_repeatable(cuda):
    """r, k, v read through head strides (views of a wider tensor); the
    final state written over s0 (the cache update); two runs bitwise equal."""
    B, S, H = 2, 37, 3
    _, _, _, logw, u, s0 = _wkv_inputs(cuda, B, S, H, torch.bfloat16, True)
    wide = torch.randn((B, S, H, 3 * 64), device=cuda).to(torch.bfloat16)
    r, k, v = wide[..., :64], wide[..., 64:128], wide[..., 128:]
    assert not r.is_contiguous()
    y_want, s_want = ref.wkv6_ref(r, k, v, logw, u, s0)
    y, _ = ops.wkv6(r, k, v, logw, u, s0.clone())
    state = s0.clone()
    y2, s_fin = ops.wkv6(r, k, v, logw, u, state, s_out=state)
    assert s_fin is state
    torch.testing.assert_close(y2, y_want, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(state, s_want, rtol=3e-4, atol=3e-4)
    assert torch.equal(y, y2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(2, 2), (4, 40)])
def test_wkv6_decode_steps_chain_to_one_call(cuda, dtype, B, H):
    """17 decode-route calls, each carrying the state on through s_out,
    give the y rows and the final state of one S = 17 call (chunked route)
    within 3e-4."""
    S = 17
    r, k, v, logw, u, s0 = _wkv_inputs(cuda, B, S, H, dtype, True)
    y_one, s_one = ops.wkv6(r, k, v, logw, u, s0)
    state = s0.clone()
    before = wk.decode_launches
    rows = [ops.wkv6(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], logw[:, t:t + 1],
                     u, state, s_out=state)[0] for t in range(S)]
    assert wk.decode_launches == before + S
    torch.testing.assert_close(torch.cat(rows, dim=1), y_one, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(state, s_one, rtol=3e-4, atol=3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 100, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_repeats_bitwise(cuda, S, dtype):
    """Both routes (S = 1: decode; else chunked) give the same bits twice:
    every sum has a fixed order and no atomics."""
    x = _wkv_inputs(cuda, 4, S, 40, dtype, True)
    y1, s1 = ops.wkv6(*x)
    y2, s2 = ops.wkv6(*x)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.gpu
def test_wkv6_refuses_rows_it_cannot_copy(cuda):
    """The kernels copy rows 16 bytes at a time: a sequence stride of 196
    bf16 elements (392 bytes) or a start 4 bytes in raises, with no slower
    route."""
    B, S, H = 2, 8, 3
    _, _, _, logw, u, _ = _wkv_inputs(cuda, B, S, H, torch.bfloat16, False)
    wide = torch.zeros((B, S, H * 64 + 4), device=cuda).to(torch.bfloat16)
    odd = wide[..., :H * 64].view(B, S, H, 64)        # sequence stride 392 bytes
    with pytest.raises(ValueError, match="16-byte"):
        ops.wkv6(odd, odd, odd, logw, u)
    flat = torch.zeros(B * S * H * 64 + 1, device=cuda)
    shifted = flat[1:].view(B, S, H, 64)              # starts 4 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        ops.wkv6(shifted, shifted, shifted, logw, u)


@pytest.mark.gpu
def test_wkv6_refuses_other_head_sizes(cuda):
    r = torch.zeros((1, 4, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="want r"):
        ops.wkv6(r, r, r, r, torch.zeros((2, 32), device=cuda))


def _on_fresh_thread(fn):
    """fn() on a new host thread, which has made no runtime call yet; what
    it returned, or raises what it raised."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:   # re-raised on the caller's thread
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["wkv6", "flash_attention_tc"])
def test_tma_forwards_launch_from_a_fresh_thread(cuda, kernel):
    """The two forwards that encode TMA tensor maps (wkv6's chunked kernel,
    flash attention's tensor-core route) launch from a thread that has made
    no runtime call yet, as autograd's device thread may be, and give the
    main thread's bits. The encoder needs a current context, which such a
    thread lacks until the wrapper sets the device."""
    if kernel == "wkv6":
        x = _wkv_inputs(cuda, 2, 100, 4, torch.bfloat16, True)
        counter, call = "launches", lambda: ops.wkv6(*x)
        mod = wk
    else:
        g = torch.Generator(device=cuda).manual_seed(0)
        q, k, v = (torch.randn((2, 130, h, 64), generator=g, device=cuda)
                   .to(torch.bfloat16) for h in (8, 2, 2))
        counter, call = "tc_launches", lambda: ops.flash_attention(q, k, v)
        mod = fa
    torch.cuda.synchronize()
    before = getattr(mod, counter)
    got = _on_fresh_thread(lambda: (call(), torch.cuda.synchronize())[0])
    assert getattr(mod, counter) == before + 1
    want = call()
    got, want = (tuple(t) if isinstance(t, tuple) else (t,) for t in (got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


# the wkv6 backward's tolerance, scaled by each gradient's largest magnitude:
# the kernel and its plain version are both f32, the sums in other orders
# (and the kernel's multiply-adds fused); dr, dk and dv in bf16 (f16) also
# carry one rounding of their own, 2^-8 (2^-11) relative
WKV6_BWD_TOL = 1e-4
WKV6_BWD_OUT_RTOL = {torch.float32: 0.0, torch.float16: 2**-11, torch.bfloat16: 2**-8}


def _wkv_bwd_inputs(dev, B, S, H, dtype, with_state, seed=0):
    r, k, v, logw, u, s0 = _wkv_inputs(dev, B, S, H, dtype, with_state, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((B, S, H, 64), generator=g, device=dev)
    ds_fin = torch.randn((B, H, 64, 64), generator=g, device=dev) if with_state else None
    return r, k, v, logw, u, s0, dy, ds_fin


# the backward kernel against the plain emulation of its arithmetic
# (ref.wkv6_bwd_ref(..., tf32="split")): both round the same tensor-core
# operands to TF32 hi + lo, so they differ only in the order of the sums and
# in the kernel's exponentials (ex2.approx); chip_smoke.py phase 15 prints
# the largest gap in an f32 output (about 1e-6 of the gradient's largest
# magnitude on an H100), so 1e-5 of it. dr, dk, dv in f16 or bf16 also carry
# their own rounding (WKV6_BWD_OUT_RTOL).
WKV6_BWD_EMUL_TOL = 1e-5


def _assert_wkv_grads_close(got, want, dtype, tol=WKV6_BWD_TOL):
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want,
                          strict=True):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == (dtype if name in ("dr", "dk", "dv") else torch.float32)
        rtol = WKV6_BWD_OUT_RTOL[g.dtype]
        torch.testing.assert_close(g.float(), w, rtol=rtol,
                                   atol=tol * w.abs().max().item() + 1e-30,
                                   msg=lambda m, name=name: f"{name}: {m}")


def _wkv_bwd_twice(x):
    """Two calls of the kernel on ``x``: one launch each and the same bits
    (no atomics; du summed over the batch in order)."""
    before = wk.bwd_launches
    got = ops.wkv6_bwd(*x)
    again = ops.wkv6_bwd(*x)
    assert wk.bwd_launches == before + 2
    for a, b in zip(got, again, strict=True):
        assert (a is None and b is None) or torch.equal(a, b)
    return got


# S: one row; ragged and whole first chunks (15-17); around the two 16-row
# output stages (31-33) and the ring of three 16-row input stages (47-49);
# many chunks. (B, H) = (1, 1) is one block alone
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 64, 100, 1024, 31, 32, 33, 47, 48, 49])
@pytest.mark.parametrize("B,H", [(2, 2), (4, 40), (1, 1)])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_bwd_matches_plain(cuda, dtype, S, B, H, with_state):
    """dr, dk, dv, dlogw, du and ds0 against ``ref.wkv6_bwd_ref`` on the same
    inputs within WKV6_BWD_TOL of each gradient's largest magnitude, and
    against its emulation of the kernel's TF32 hi + lo products within
    WKV6_BWD_EMUL_TOL; ragged last chunks and S = 1 included; one launch a
    call, and a second call gives the same bits."""
    x = _wkv_bwd_inputs(cuda, B, S, H, dtype, with_state)
    got = _wkv_bwd_twice(x)
    _assert_wkv_grads_close(got, ref.wkv6_bwd_ref(*x), dtype)
    _assert_wkv_grads_close(got, ref.wkv6_bwd_ref(*x, tf32="split"), dtype,
                            tol=WKV6_BWD_EMUL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [37, 1024])
def test_wkv6_bwd_strided_views(cuda, dtype, S):
    """r, k, v read through head strides (views of one (B, S, H, 3 x 64)
    tensor, as a fused projection gives them) and logw through a sequence
    stride: the same gradients as from contiguous copies, bitwise, and the
    same bits twice."""
    B, H = 2, 3
    x = _wkv_bwd_inputs(cuda, B, S, H, dtype, True)
    wide = torch.cat([t.float() for t in x[:3]], dim=-1).to(dtype)
    r, k, v = wide[..., :64], wide[..., 64:128], wide[..., 128:]
    lw_wide = torch.cat([x[3], torch.zeros_like(x[3])], dim=1)   # (B, 2 S, H, 64)
    logw = lw_wide[:, :S]
    assert not r.is_contiguous() and logw.stride(0) != S * H * 64
    got = _wkv_bwd_twice((r, k, v, logw, *x[4:]))
    want = ops.wkv6_bwd(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.gpu
def test_wkv6_autograd_runs_the_kernels(cuda, monkeypatch):
    """With grad on, ``ops.wkv6`` on the card launches the forward and the
    backward kernels and never reaches a plain version; its gradients are
    the backward kernel's, bitwise."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(ref, "wkv6_ref", refuse)
    monkeypatch.setattr(ref, "wkv6_bwd_ref", refuse)
    r, k, v, logw, u, s0, dy, _ = _wkv_bwd_inputs(cuda, 2, 70, 3, torch.bfloat16, True)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, logw, u, s0)]
    before = (wk.launches, wk.bwd_launches)
    y, _ = ops.wkv6(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    assert (wk.launches, wk.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = ops.wkv6_bwd(r, k, v, logw, u, s0, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


# the backward's tolerance, scaled by each gradient's largest magnitude: f32
# 1e-4; f16 and bf16 the rtol the forward's tests take (torch's defaults, one
# rounding of the output). The 1e-5 floor covers S = 1 (and row 0 under a
# causal mask): one key gives dP = Delta, so dq and dk are zero in exact
# arithmetic and both versions return rounding noise.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2, torch.float16: 1e-3}


def _assert_grads_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= BWD_RTOL[dtype] * scale + 1e-5, (name, err, scale)


def _bwd_inputs(dev, B, Sq, Sk, Hq, Hkv, D, dtype, causal, q_offset=0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, Sq, Hq, D), generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal, q_offset=q_offset)
    return q, k, v, o, lse, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 1, 4, 2, 16), (2, 17, 8, 2, 16),
                                          (1, 130, 32, 4, 64), (2, 100, 16, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_matches_plain(cuda, dtype, B, S, Hq, Hkv, D, causal):
    """The backward kernel against ``ref.flash_attention_bwd_ref`` on the
    same inputs (the kernel's own forward output and log-sum-exp)."""
    x = _bwd_inputs(cuda, B, S, S, Hq, Hkv, D, dtype, causal)
    want = ref.flash_attention_bwd_ref(*x, causal=causal)
    lse_want = ref.flash_attention_ref(*x[:3], causal=causal, return_lse=True)[1]
    torch.testing.assert_close(x[4], lse_want, rtol=1e-5, atol=1e-5)
    before = fa.bwd_launches
    got = ops.flash_attention_bwd(*x, causal=causal)
    assert fa.bwd_launches == before + fa.BWD_PASSES[dtype]
    _assert_grads_close(got, want, dtype)


# The tensor-core route against its plain emulation
# (ref.flash_attention_bwd_ref(..., round_to=dtype), in f32 without the final
# rounding), as a share of each gradient's largest magnitude m. The kernel
# rounds its output, the emulation does not: half a unit in the last place
# of any element is at most 2^-8 m in bf16 and 2^-11 m in f16. A quarter
# more covers the sums' order and exp2 for exp: on an H100 80GB HBM3 (700 W)
# the largest error over 36 cases a type (D 16/64/128, causal and not,
# GQA, q_offset, S = 17 to 1000) was 3.65e-3 m in bf16 and 4.47e-4 m in f16.
TC_EMUL_RTOL = {torch.bfloat16: 1.25 * 2**-8, torch.float16: 1.25 * 2**-11}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_tc_route(cuda, dtype, D, causal):
    """The f16/bf16 route: 100 queries at positions 30..129 over 130 keys
    (neither a multiple of the 64-row tile), GQA 8/2: within BWD_RTOL of the
    f32 plain version, within TC_EMUL_RTOL of the rounding emulation, and
    bitwise equal on repeat."""
    Sq, Sk, off = 100, 130, 30
    x = _bwd_inputs(cuda, 2, Sq, Sk, 8, 2, D, dtype, causal, q_offset=off)
    before = fa.bwd_launches
    got = ops.flash_attention_bwd(*x, causal=causal, q_offset=off)
    assert fa.bwd_launches == before + fa.BWD_PASSES[dtype] == before + 4
    again = ops.flash_attention_bwd(*x, causal=causal, q_offset=off)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
    _assert_grads_close(got, ref.flash_attention_bwd_ref(*x, causal=causal,
                                                         q_offset=off), dtype)
    emul = ref.flash_attention_bwd_ref(*(t.float() for t in x), causal=causal,
                                       q_offset=off, round_to=dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, emul, strict=True):
        err = (g.float() - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= TC_EMUL_RTOL[dtype] * scale + 1e-5, (name, err / scale)


@pytest.mark.gpu
def test_flash_attention_bwd_offset_and_bitwise_repeat(cuda):
    """Queries at positions 35..39 over 40 keys; two calls give the same
    bits (no atomics)."""
    x = _bwd_inputs(cuda, 2, 5, 40, 8, 2, 64, torch.bfloat16, True, q_offset=35)
    got = ops.flash_attention_bwd(*x, causal=True, q_offset=35)
    _assert_grads_close(got, ref.flash_attention_bwd_ref(*x, causal=True, q_offset=35),
                        torch.bfloat16)
    x = _bwd_inputs(cuda, 4, 300, 300, 32, 4, 64, torch.bfloat16, True, seed=1)
    first = ops.flash_attention_bwd(*x, causal=True)
    again = ops.flash_attention_bwd(*x, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))


@pytest.mark.gpu
def test_flash_attention_autograd_runs_the_kernels(cuda):
    """With grad on, ``ops.flash_attention`` on the card launches the forward
    (with its log-sum-exp) and the backward kernels, and its gradients are
    the backward kernel's."""
    q, k, v, _, _, do = _bwd_inputs(cuda, 2, 70, 70, 8, 2, 64, torch.float32, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.launches, fa.bwd_launches)
    o = ops.flash_attention(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1,
                                              before[1] + fa.BWD_PASSES[q.dtype])
    o2, lse = ops.flash_attention_lse(q, k, v)
    assert torch.equal(o.detach(), o2)
    want = ops.flash_attention_bwd(q, k, v, o2, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.gpu
def test_flash_attention_bwd_refuses_strided_inputs(cuda):
    x = list(_bwd_inputs(cuda, 1, 8, 8, 4, 2, 16, torch.float32, True))
    x[0] = x[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_bwd(*x)


@pytest.mark.gpu
@pytest.mark.parametrize("relaxed", [True, False])
def test_smoke_tinyllama_training_on_card_matches_cpu(cuda, relaxed):
    """Three steps of smoke tinyllama (f32, TF32 off) on the card and on the
    CPU from the same params: losses, the trained embedding table and the
    AdamW-trained dense params within 1e-5. AdamW's first steps, near
    sign(g), could amplify float-order noise in the tiniest gradients; on an
    H100 80GB HBM3 (700 W) the dense params after 5 relaxed steps differed
    by at most 6.7e-7, none by more than 1e-6."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import make_batches
    from repro_torch.models.registry import get_api
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("tinyllama-1.1b", smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05)
    gen = torch.Generator().manual_seed(0)
    params = get_api(cfg).init(gen, cfg)
    init_fn = train_loop.make_step_fns(cfg, tc)[0]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = init_fn(tree_map(lambda p, d=dev: p.to(d, copy=True), params))
        before = fa.bwd_launches
        state, losses = train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device=dev),
                                         3, relaxed=relaxed, state=state, device=dev)
        if dev.type == "cuda":   # one backward per layer and step
            assert fa.bwd_launches - before == \
                3 * cfg.num_layers * fa.BWD_PASSES[torch.float32]
        out[dev.type] = (losses, state["embed"]["table"].cpu(),
                         [p.detach().cpu() for p in tree_leaves(state["dense"])])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-5, atol=1e-5)
