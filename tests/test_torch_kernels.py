"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain version (``repro_torch.kernels.ref``);
the Pallas kernels run in interpret mode. The CUDA kernels themselves are
held against the plain versions in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas, gather_rows_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.scatter_update import (scatter_update_logged_pallas,
                                          scatter_update_pallas)
from repro_torch.data.synthetic import zipf_indices
from repro_torch.kernels import gather_rows as gr
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scatter_update as su


def _bag_case(rng, R, D, N, B, dtype):
    table = rng.standard_normal((R, D)).astype(dtype)
    idx = rng.integers(0, R, N).astype(np.int32)
    seg = np.sort(rng.integers(0, B, N)).astype(np.int32)
    return table, idx, seg


# B well above N / few items leave bags empty; D=128 is the Pallas lane width
@pytest.mark.parametrize("R,D,N,B", [(32, 128, 17, 4), (64, 128, 5, 12),
                                     (128, 256, 100, 16), (16, 128, 1, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_embedding_bag_matches_pallas(rng, R, D, N, B, dtype):
    table, idx, seg = _bag_case(rng, R, D, N, B, dtype)
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(seg), B)
    assert got.dtype == torch.float32 and got.shape == (B, D)
    pallas = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(seg), B, interpret=True)
    oracle = jref.embedding_bag_ref(jnp.asarray(table, jnp.float32),
                                    jnp.asarray(idx), jnp.asarray(seg), B)
    plain = ref.embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx),
                                  torch.from_numpy(seg), B)
    for want in (np.asarray(pallas), np.asarray(oracle), plain.numpy()):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    empty = np.setdiff1d(np.arange(B), seg)
    assert not got.numpy()[empty].any()


@pytest.mark.parametrize("R,D,N", [(64, 128, 16), (128, 256, 48)])
def test_scatter_update_matches_pallas(rng, R, D, N):
    table = rng.standard_normal((R, D)).astype(np.float32)
    idx = rng.permutation(R)[:N].astype(np.int32)
    delta = rng.standard_normal((N, D)).astype(np.float32)
    want = scatter_update_pallas(jnp.asarray(table), jnp.asarray(idx),
                                 jnp.asarray(delta), interpret=True)
    t = torch.from_numpy(table.copy())
    out = ops.scatter_update(t, torch.from_numpy(idx), torch.from_numpy(delta))
    assert out is t     # in place
    np.testing.assert_allclose(t.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_update_skips_pads_and_keeps_row0(rng, dtype):
    """Row 0 is real and pads (-1) follow it: row 0 is updated exactly once,
    with the trainer's round(f32(t) + f32(u)) arithmetic."""
    R, D = 16, 8
    table = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)).to(dtype)
    idx = torch.tensor([0, 5, 3, -1, -1, -1], dtype=torch.int32)
    delta = torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32))
    want = table.clone()
    for s in range(3):
        r = int(idx[s])
        want[r] = (want[r].float() + delta[s]).to(dtype)
    ops.scatter_update(table, idx, delta)
    assert torch.equal(table, want)


# the shapes of tests/test_kernels.py::test_scatter_update_sweep
@pytest.mark.parametrize("R,D,N", [(64, 128, 16), (128, 256, 48)])
def test_scatter_update_logged_matches_pallas(rng, R, D, N):
    """The undo rows bitwise; the f32 table within the Pallas test's 1e-6,
    and bitwise too (both add in f32)."""
    table = rng.standard_normal((R, D)).astype(np.float32)
    idx = rng.permutation(R)[:N].astype(np.int32)
    delta = rng.standard_normal((N, D)).astype(np.float32)
    want_t, want_old = scatter_update_logged_pallas(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(delta), interpret=True)
    t = torch.from_numpy(table.copy())
    out, old = ops.scatter_update_logged(t, torch.from_numpy(idx),
                                         torch.from_numpy(delta))
    assert out is t and old.dtype == torch.float32 and old.shape == (N, D)
    np.testing.assert_array_equal(old.numpy(), np.asarray(want_old))
    np.testing.assert_array_equal(old.numpy(), table[idx])
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), atol=1e-6)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("with_row0", [True, False])
def test_scatter_update_logged_pads(rng, dtype, with_row0):
    """Pad slots (-1) log a +0 row and leave the table alone, row 0
    included; real slots log their row's bits and update it once with
    ``scatter_update_ref``'s round(f32(t) + f32(u))."""
    R, D = 16, 8
    table = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)).to(dtype)
    ids = [5, 0, 3] if with_row0 else [5, 3]
    idx = torch.tensor(ids + [-1, -1, -1], dtype=torch.int32)
    delta = torch.from_numpy(rng.standard_normal((len(idx), D)).astype(np.float32))
    before = table.clone()
    want = ref.scatter_update_ref(table.clone(), idx, delta)
    _, old = ops.scatter_update_logged(table, idx, delta)
    assert old.dtype == dtype
    assert torch.equal(table, want)
    n, bits = len(ids), torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(old[:n].view(bits), before[ids].view(bits))
    assert not old[n:].any() and not torch.signbit(old[n:]).any()   # +0
    if not with_row0:
        assert torch.equal(table[0], before[0])


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16])
def test_scatter_update_logged_half_types(rng, dtype):
    """bf16 and f16: the undo rows equal the Pallas kernel's bitwise (both
    copy the row); the table follows ``scatter_update_ref``'s arithmetic,
    not the Pallas kernel's cast of delta to the table type first."""
    R, D, N = 64, 128, 16
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}[dtype]
    table32 = rng.standard_normal((R, D)).astype(np.float32)
    idx = rng.permutation(R)[:N].astype(np.int32)
    delta = (rng.standard_normal((N, D)) * 1e-2).astype(np.float32)
    _, want_old = scatter_update_logged_pallas(
        jnp.asarray(table32, dtype), jnp.asarray(idx), jnp.asarray(delta),
        interpret=True)
    t = torch.from_numpy(table32).to(tdt)
    want_t = ref.scatter_update_ref(t.clone(), torch.from_numpy(idx),
                                    torch.from_numpy(delta))
    _, old = ops.scatter_update_logged(t, torch.from_numpy(idx),
                                       torch.from_numpy(delta))
    assert torch.equal(t, want_t)
    np.testing.assert_array_equal(
        old.view(torch.int16).numpy(),
        np.asarray(want_old).view(np.int16))


def test_scatter_update_logged_refuses_other_devices():
    """Dispatch has no plain path for a meta tensor, and the kernel's
    wrapper takes no CPU table (the CPU goes to the plain version)."""
    table = torch.empty((4, 8), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.scatter_update_logged(table, idx, torch.empty((2, 8), device="meta"))
    with pytest.raises(ValueError, match="needs a CUDA table"):
        su.scatter_update_logged_cuda(torch.zeros((4, 8)), torch.zeros(2, dtype=torch.int32),
                                      torch.zeros((2, 8)))


# uniform ids; and the LM step's shape: 4,096 zipf(1.05) tokens over a
# 32,000 vocabulary, whose hottest token's bag holds hundreds of items (the
# kernel on the card sums such a bag in runs)
@pytest.mark.parametrize("n,rmax,seed,dist", [
    pytest.param(2, 4, 0, "uniform", id="2-4-0"),
    pytest.param(17, 8, 1, "uniform", id="17-8-1"),
    pytest.param(40, 64, 2, "uniform", id="40-64-2"),
    pytest.param(64, 5, 3, "uniform", id="64-5-3"),
    pytest.param(4096, 32000, 4, "zipf", id="lm-4096-32000-zipf")])
def test_combine_duplicates_matches_jax(n, rmax, seed, dist):
    rng = np.random.default_rng(seed)
    if dist == "zipf":
        idx = zipf_indices(rng, (n,), rmax)
        assert np.bincount(idx).max() > 200      # a bag of hundreds of items
    else:
        idx = rng.integers(0, rmax, n).astype(np.int32)
    delta = rng.standard_normal((n, 8)).astype(np.float32)
    ui, cd = jops.combine_duplicates(jnp.asarray(idx), jnp.asarray(delta), rmax)
    dense_jax = np.asarray(jnp.zeros((rmax, 8)).at[ui].add(cd))
    uniq, comb = ops.combine_duplicates(torch.from_numpy(idx),
                                        torch.from_numpy(delta))
    uniq, comb = uniq.numpy(), comb.numpy()
    real = uniq >= 0
    n_uniq = len(np.unique(idx))
    assert real.sum() == n_uniq and real[:n_uniq].all()   # pads trail
    assert np.array_equal(uniq[:n_uniq], np.unique(idx))
    assert not comb[~real].any()
    dense_port = np.zeros((rmax, 8), np.float32)
    np.add.at(dense_port, uniq[real], comb[real])
    np.testing.assert_allclose(dense_port, dense_jax, rtol=1e-5, atol=1e-5)


def test_combine_duplicates_item_rows(rng):
    """item_rows indexes the delta rows without building the (N, D) repeat."""
    idx = rng.integers(0, 6, 30).astype(np.int32)
    rows = rng.standard_normal((10, 4)).astype(np.float32)
    item_rows = rng.integers(0, 10, 30)
    a_idx, a = ops.combine_duplicates(torch.from_numpy(idx),
                                      torch.from_numpy(rows[item_rows]))
    b_idx, b = ops.combine_duplicates(torch.from_numpy(idx), torch.from_numpy(rows),
                                      item_rows=torch.from_numpy(item_rows))
    assert torch.equal(a_idx, b_idx) and torch.equal(a, b)


def test_dispatch_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card has no plain path."""
    table = torch.empty((4, 8), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.embedding_bag(table, idx, idx, 1)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.scatter_update(table, idx, torch.empty((2, 8), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        q = torch.empty((1, 2, 2, 16), device="meta")
        ops.flash_attention(q, q, q)


# ragged widths; N > R repeats rows
@pytest.mark.parametrize("R,D,N", [(64, 128, 20), (32, 32, 70), (7, 45, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_gather_rows_matches_pallas(rng, R, D, N, dtype):
    table = rng.standard_normal((R, D)).astype(dtype)
    idx = rng.integers(0, R, N).astype(np.int32)
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx),
                                         interpret=True))
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    for got in (ops.gather_rows(t, i), ref.gather_rows_ref(t, i)):
        assert got.dtype == t.dtype
        np.testing.assert_array_equal(got.numpy(), want)   # exact


def test_gather_rows_bf16_matches_pallas(rng):
    # finite patterns only: interpret mode quiets NaN payloads on its side
    bits = rng.integers(0, 1 << 16, (50, 32)).astype(np.uint16) & np.uint16(0xBF7F)
    table = jnp.asarray(bits).view(jnp.bfloat16)
    idx = rng.integers(0, 50, 90).astype(np.int32)
    want = np.asarray(gather_rows_pallas(table, jnp.asarray(idx),
                                         interpret=True)).view(np.uint16)
    got = ops.gather_rows(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
                          torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)   # bitwise


# (table dtype, D, table one element into its buffer) -> the gather's chunk
# bytes and the updates' chunk elements (the logged update's undo buffer
# from torch.empty, as its wrapper makes it): rm1's 64-byte bf16 rows, the
# LM's 4 KB bf16 table rows and 8 KB f32 scratch rows, a 2-byte-aligned
# view, D = 1
@pytest.mark.parametrize("dtype,D,offset,gather_bytes,update_elems", [
    (torch.bfloat16, 32, False, 16, 8),
    (torch.float32, 32, False, 16, 4),
    (torch.bfloat16, 2048, False, 16, 8),
    (torch.float32, 2048, False, 16, 4),
    (torch.bfloat16, 2048, True, 2, 1),
    (torch.float32, 2048, True, 4, 1),
    (torch.bfloat16, 1, False, 2, 1),
    (torch.float32, 45, False, 4, 1),
])
def test_row_kernels_chunk_route(dtype, D, offset, gather_bytes, update_elems):
    """The chunk each row kernel's wrapper picks for the main paths' tables
    (16 bytes: the wide route) and for the ones the wide route refuses; the
    logged update takes the plain update's chunk, and the narrow one for an
    undo buffer one element into its buffer."""
    R = 8
    flat = torch.zeros(R * D + 1, dtype=dtype)
    table = flat[int(offset):][: R * D].view(R, D)
    out = torch.empty((5, D), dtype=dtype)
    delta = torch.empty((5, D), dtype=torch.float32)
    row_bytes = D * table.element_size()
    assert gr.chunk_bytes(row_bytes, table.data_ptr(), out.data_ptr()) == gather_bytes
    assert su.chunk_elems(table.element_size(), D, table.data_ptr(),
                          delta.data_ptr()) == update_elems
    old = torch.empty((5, D), dtype=dtype)
    assert su.chunk_elems(table.element_size(), D, table.data_ptr(), delta.data_ptr(),
                          old.data_ptr()) == update_elems
    old_view = torch.empty(5 * D + 1, dtype=dtype)[1:]
    assert su.chunk_elems(table.element_size(), D, table.data_ptr(), delta.data_ptr(),
                          old_view.data_ptr()) == 1


def _qkv(rng, B, S, Hq, Hkv, D):
    return (rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv))


# the shapes of tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("B,S,H,D,causal", [
    (1, 128, 2, 64, True), (2, 256, 4, 64, False), (2, 128, 2, 128, True)])
def test_flash_attention_matches_pallas(rng, B, S, H, D, causal):
    q, k, v = _qkv(rng, B, S, H, H, D)

    def flat(x):   # the Pallas kernel's (B*H, S, D) layout
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(B * H, S, D)
    out = flash_attention_pallas(flat(q), flat(k), flat(v), causal=causal,
                                 bq=64, bk=64, interpret=True)
    want = np.asarray(jnp.moveaxis(out.reshape(B, H, S, D), 1, 2))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (ops.flash_attention(tq, tk, tv, causal=causal),
                ref.flash_attention_ref(tq, tk, tv, causal=causal)):
        assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# GQA (no repeat on the port's side) and ragged lengths
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 33, 8, 2, 16), (1, 9, 4, 1, 32),
                                          (3, 1, 6, 3, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa_ragged_matches_jax_ref(rng, B, S, Hq, Hkv, D, causal):
    q, k, v = _qkv(rng, B, S, Hq, Hkv, D)
    G = Hq // Hkv
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, 2),
                                    jnp.repeat(jnp.asarray(v), G, 2), causal=causal)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_reads_a_cache_prefix_in_place(rng):
    """k, v as the first S entries of a (B, Smax, Hkv, D) cache (not
    contiguous across the batch) give the contiguous result."""
    q, k, v = _qkv(rng, 2, 9, 4, 2, 16)
    kc = torch.zeros((2, 16, 2, 16))
    vc = torch.zeros((2, 16, 2, 16))
    kc[:, :9], vc[:, :9] = torch.from_numpy(k), torch.from_numpy(v)
    assert not kc[:, :9].is_contiguous()
    got = ops.flash_attention(torch.from_numpy(q), kc[:, :9], vc[:, :9])
    want = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))
    assert torch.equal(got, want)


# The tensor-core forward (f16, bf16) carries P as P_hi + P_lo, two terms of
# the input type (``ref.flash_attention_ref(..., p_dtype=dtype)`` emulates
# it). Its gate is the one chip_smoke.py's phase 7 and test_torch_cuda.py
# hold the kernel to against the f32-P plain version: torch's defaults for
# the type (bf16 rtol 1.6e-2, f16 1e-3; atol 1e-5).
FWD_TOL = {torch.bfloat16: (1.6e-2, 1e-5), torch.float16: (1e-3, 1e-5)}


def _share(got, want, dtype):
    """Largest |got - want| over the gate's allowance (atol + rtol |want|)."""
    rtol, atol = FWD_TOL[dtype]
    w = want.float()
    return ((got.float() - w).abs() / (atol + rtol * w.abs())).max().item()


# the shapes of tests/test_kernels.py::test_flash_attention_sweep
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,D,causal", [
    (1, 128, 2, 64, True), (2, 256, 4, 64, False), (2, 128, 2, 128, True)])
def test_flash_split_p_emulation_matches_pallas(rng, dtype, B, S, H, D, causal):
    """The split-P emulation against the Pallas kernel (interpret mode, f32
    P) and the JAX oracle on the same 16-bit inputs, within the gate."""
    q, k, v = (x.astype(jnp.dtype(str(dtype).split(".")[1])) for x in _qkv(rng, B, S, H, H, D))

    def flat(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(B * H, S, D)
    out = flash_attention_pallas(flat(q), flat(k), flat(v), causal=causal,
                                 bq=64, bk=64, interpret=True)
    pallas = jnp.moveaxis(out.reshape(B, H, S, D), 1, 2)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dtype)
                  for x in (q, k, v))
    emul = ref.flash_attention_ref(tq, tk, tv, causal=causal, p_dtype=dtype)
    assert emul.dtype == dtype and emul.shape == (B, S, H, D)
    rtol, atol = FWD_TOL[dtype]
    for want in (pallas, oracle):
        want = torch.from_numpy(np.asarray(want, dtype=np.float32)).to(dtype)
        torch.testing.assert_close(emul, want, rtol=rtol, atol=atol)


# phase 7's head shapes at sizes the CPU takes, ragged and with GQA
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 1, 4, 2, 16), (2, 17, 8, 2, 16),
                                          (1, 130, 32, 4, 64), (2, 100, 16, 8, 128),
                                          (1, 1000, 6, 2, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_split_p_within_limits_single_rounding_reported(rng, dtype, B, S, Hq,
                                                              Hkv, D, causal):
    """The split-P emulation stays within the gate against the f32-P plain
    version; prints the share of the gate it uses and the share a single
    rounding of P would use (run with -s), which is not held."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in _qkv(rng, B, S, Hq, Hkv, D))
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    split = ref.flash_attention_ref(tq, tk, tv, causal=causal, p_dtype=dtype)
    single = ref.flash_attention_ref(tq, tk, tv, causal=causal, p_dtype=dtype, p_terms=1)
    split_share, single_share = _share(split, plain, dtype), _share(single, plain, dtype)
    print(f"P in {dtype} causal={causal} {B, S, Hq, Hkv, D}: share of the gate "
          f"used by the split {split_share:.3f}, by a single rounding {single_share:.3f}")
    assert split_share <= 1.0


# test_torch_cuda.py's limits for the backward kernel against the plain
# version, by input type (f32 1e-4; f16 and bf16 one rounding of the
# output), scaled by each gradient's largest magnitude, with a 1e-5 floor
BWD_RTOL = {torch.bfloat16: 1.6e-2, torch.float16: 1e-3}


# the shapes of test_torch_cuda.py::test_flash_attention_bwd_matches_plain
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 1, 4, 2, 16), (2, 17, 8, 2, 16),
                                          (1, 130, 32, 4, 64), (2, 100, 16, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_rounding_emulation_within_limits(rng, dtype, B, S, Hq, Hkv, D,
                                                    causal):
    """The tensor-core backward rounds P and dS to the input type before
    their products; its plain emulation (``round_to``) stays within the
    limits the card holds the kernel to against the unrounded plain
    version, so the rounding alone does not use them up. Prints the share
    of each limit used."""
    q, do = (torch.from_numpy(rng.standard_normal((B, S, Hq, D)).astype(np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
            .to(dtype) for _ in range(2))
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    emul = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       round_to=dtype)
    shares = []
    for name, e, w in zip(("dq", "dk", "dv"), emul, plain, strict=True):
        assert e.dtype == w.dtype == dtype and e.shape == w.shape
        err = (e.float() - w.float()).abs().max().item()
        limit = BWD_RTOL[dtype] * w.float().abs().max().item() + 1e-5
        shares.append(err / limit)
        assert err <= limit, (name, err, limit)
    print(f"rounding emulation, {dtype} causal={causal} {B, S, Hq, Hkv, D}: "
          f"share of the limit used by dq, dk, dv {[f'{x:.3f}' for x in shares]}")
