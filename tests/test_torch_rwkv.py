"""The port's RWKV-6 serving path against the JAX package, at the smoke size
(f32, d 128, 2 heads, 2 layers).

Inputs come from numpy with a seed; the port starts from the JAX package's
params through ``repro_torch.interop``. On the CPU ``ops.wkv6`` runs its
plain version, ``ref.wkv6_ref``, which is held here against the JAX chunked
form, the sequential oracle and the Pallas kernel in interpret mode; the
CUDA kernel itself is held against the plain version in
``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6_pallas
from repro.models import rwkv6 as jrwkv
from repro.models.registry import get_api as jax_get_api
from repro.training.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import rwkv6
from repro_torch.models.registry import get_api
from repro_torch.training.serve_loop import greedy_generate
from repro_torch.tree import tree_leaves, tree_map

ARCH = "rwkv6-3b"
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def _lm(dtype=None):
    """(JAX cfg, port cfg, JAX params, the same params as port tensors) at
    the smoke size, optionally in another activation dtype."""
    jcfg = jax_get_arch(ARCH, smoke=True).model
    cfg = get_arch(ARCH, smoke=True).model
    if dtype is not None:
        jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, interop.params_from_numpy(jparams, CPU)


def _wkv_case(rng, B, S, H, with_s0=True):
    """As tests/test_sequence_mixers.py::_wkv_case, in numpy."""
    K = rwkv6.HEAD_K
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, S, H, K)) * 0.5 - 1),
                   rwkv6.LOG_W_MIN, -1e-4).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    s0 = (rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.1 if with_s0
          else np.zeros((B, H, K, K), np.float32))
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke):
    jcfg = jax_get_arch(ARCH, smoke=smoke).model
    cfg = get_arch(ARCH, smoke=smoke).model
    want = dataclasses.asdict(jcfg)
    for name, value in dataclasses.asdict(cfg).items():
        assert value == want[name], name
    assert cfg.layer_types == jcfg.layer_types
    assert cfg.param_counts() == jcfg.param_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_has_the_reference_tree(dtype):
    _, cfg, jparams, _ = _lm(dtype)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = tree_leaves(rwkv6.init_lm(gen, cfg))
    want = tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert [str(t.dtype).removeprefix("torch.") for t in got] == \
        [a.dtype.name for a in want]


def test_constants_match_jax():
    assert (rwkv6.HEAD_K, rwkv6.LORA_R, rwkv6.LOG_W_MIN, rwkv6.WKV_CHUNK) == \
        (jrwkv.HEAD_K, jrwkv.LORA_R, jrwkv.LOG_W_MIN, jrwkv.WKV_CHUNK)
    assert wk.HEAD_K == jrwkv.HEAD_K


# the S of tests/test_sequence_mixers.py and ragged ones; 2e-4 as there
@pytest.mark.parametrize("S", [1, 9, 33, 48, 64])
def test_wkv6_plain_matches_jax(rng, S):
    case = _wkv_case(rng, 2, S, 2)
    jin = [jnp.asarray(a) for a in case]
    y, s_fin = ops.wkv6(*(_t(a) for a in case))
    for y_w, s_w in (jrwkv.wkv6_chunked(*jin), jref.wkv6_ref(*jin)):
        np.testing.assert_allclose(_np(y), np.asarray(y_w), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(_np(s_fin), np.asarray(s_w), rtol=2e-4, atol=2e-4)


# the cases of tests/test_kernels.py::test_wkv6_pallas_kernel; 3e-4 as there
@pytest.mark.parametrize("B,S,H", [(2, 64, 2), (1, 48, 1)])
def test_wkv6_plain_matches_pallas(rng, B, S, H):
    r, k, v, logw, u, _ = _wkv_case(rng, B, S, H, with_s0=False)
    want = wkv6_pallas(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                       chunk=rwkv6.WKV_CHUNK)
    got, _ = ref.wkv6_ref(*(_t(a) for a in (r, k, v, logw, u)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-4, atol=3e-4)


def test_wkv6_state_out_in_place_and_cpu_dispatch(rng):
    """``s_out=s0`` overwrites the state with what a fresh output holds;
    the CPU path launches no kernel."""
    r, k, v, logw, u, s0 = (_t(a) for a in _wkv_case(rng, 2, 21, 2))
    before = wk.launches
    y, s_fin = ops.wkv6(r, k, v, logw, u, s0.clone())
    state = s0.clone()
    y2, s2 = ops.wkv6(r, k, v, logw, u, state, s_out=state)
    assert s2 is state and wk.launches == before
    assert torch.equal(y, y2) and torch.equal(state, s_fin)


def test_wkv6_refuses_other_devices():
    r = torch.zeros((1, 2, 1, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.wkv6(r, r, r, r, torch.zeros((1, 64), device="meta"))


# The wkv6 kernel's products on the tensor cores take their operands as TF32
# hi + lo terms (``ref.wkv6_ref(..., tf32="split")`` emulates it). Its gate
# is the one tests/test_kernels.py holds the Pallas kernel to: 3e-4.
WKV_TOL = 3e-4


def _gate_share(got, want):
    """Largest |got - want| over the gate's allowance (atol + rtol |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (WKV_TOL + WKV_TOL * np.abs(want))).max())


def _wkv_whole_range_case(rng, B, S, H, dtype):
    """r, k, v rounded to ``dtype`` (as f32 arrays), logw log-uniform over
    the whole clamp range [-5, -1e-4], u and s0 f32."""
    K = rwkv6.HEAD_K
    r, k, v = (_np(torch.from_numpy(rng.standard_normal((B, S, H, K)).astype(np.float32)
                                    * 0.5).to(dtype).float()) for _ in range(3))
    logw = -np.exp(rng.uniform(np.log(1e-4), np.log(-rwkv6.LOG_W_MIN),
                               (B, S, H, K))).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.1
    return r, k, v, logw, u, s0


# the shapes of tests/test_kernels.py::test_wkv6_pallas_kernel, and a longer
# sequence that carries the state through 64 chunks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", [(2, 64, 2), (1, 48, 1), (1, 1024, 2)])
def test_wkv6_tf32_split_emulation_within_gate(rng, dtype, B, S, H):
    """The kernel's arithmetic (TF32 hi + lo terms) against the Pallas
    kernel in interpret mode (zero state) and ``wkv6_chunked`` (a random
    state in, the final state out) on the same inputs, within 3e-4; one
    TF32 rounding of each operand breaks that gate. Prints the share of
    the gate each uses (run with -s)."""
    r, k, v, logw, u, s0 = _wkv_whole_range_case(rng, B, S, H, dtype)
    tin = [_t(a) for a in (r, k, v, logw, u)]
    shares = {}
    for mode in ("split", "single"):
        zero, _ = ref.wkv6_ref(*tin, tf32=mode)
        y, s_fin = ref.wkv6_ref(*tin, _t(s0), tf32=mode)
        want = []
        if S <= 64:     # the Pallas kernel in interpret mode, at its test shapes
            want.append((zero, wkv6_pallas(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                                           chunk=rwkv6.WKV_CHUNK)))
        y_c, s_c = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
        want += [(y, y_c), (s_fin, s_c)]
        shares[mode] = max(_gate_share(_np(g), w) for g, w in want)
    print(f"wkv6 TF32 emulation, {dtype} {B, S, H}: share of the 3e-4 gate used by "
          f"the split {shares['split']:.4f}, by a single rounding {shares['single']:.2f}")
    assert shares["split"] <= 1.0
    assert shares["single"] > 1.0


# tests/test_sequence_mixers.py::test_rwkv_decode_matches_prefill's comparison
# in bf16, prompts of one chunk and of 2, 4 and 8 chunks and a ragged one
@pytest.mark.parametrize("S1", [9, 33, 65, 130])
def test_decode_matches_prefill_bf16_in_both_packages(S1):
    """Decode after a prefill of S1 - 1 tokens against a prefill of S1, in
    bf16 through the JAX package and through the port from the same params.
    Both gaps are at most one bf16 rounding of the logits (2^-8 of the
    largest), the port's not above the JAX package's, so the port's
    recurrent decode (state precision, token shift) adds nothing of its own.
    The limit is two roundings; with -s the gaps are printed."""
    jcfg, cfg, jparams, params = _lm("bfloat16")
    japi, api = jax_get_api(jcfg), get_api(cfg)
    toks = np.random.default_rng(S1).integers(0, cfg.vocab_size, (2, S1)).astype(np.int32)
    _, jc = japi.prefill(jparams, jcfg, jnp.asarray(toks[:, :-1]), japi.init_cache(jcfg, 2, S1))
    jdec, _ = japi.decode_step(jparams, jcfg, jnp.asarray(toks[:, -1:]), S1 - 1, jc)
    jfull, _ = japi.prefill(jparams, jcfg, jnp.asarray(toks), japi.init_cache(jcfg, 2, S1))
    t = _t(toks)
    _, c = api.prefill(params, cfg, t[:, :-1], api.init_cache(cfg, 2, S1, CPU))
    dec, _ = api.decode_step(params, cfg, t[:, -1:], S1 - 1, c)
    full, _ = api.prefill(params, cfg, t, api.init_cache(cfg, 2, S1, CPU))
    jdec, jfull = np.asarray(jdec, np.float32), np.asarray(jfull, np.float32)
    scale = float(np.abs(jfull).max())
    jax_gap = float(np.abs(jdec - jfull).max()) / scale
    port_gap = float(np.abs(_np(dec) - _np(full)).max()) / scale
    print(f"bf16 decode vs prefill, S1={S1}: gap over the largest logit, JAX "
          f"{jax_gap:.3g}, port {port_gap:.3g}")
    assert jax_gap <= 2 ** -7 and port_gap <= 2 ** -7
    assert port_gap <= max(jax_gap, 2 ** -8)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(rng, with_state):
    jcfg, cfg, jparams, params = _lm()
    jp, p = _layer0(jparams["blocks"]["tmix"]), tree_map(lambda a: a[0],
                                                         params["blocks"]["tmix"])
    H = cfg.d_model // rwkv6.HEAD_K
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    jst = st = None
    if with_state:
        shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        s = rng.standard_normal((2, H, 64, 64)).astype(np.float32) * 0.1
        jst = {"shift": jnp.asarray(shift), "s": jnp.asarray(s)}
        st = {"shift": _t(shift), "s": _t(s)}
    want, jnew = jrwkv.time_mix(jp, jcfg, jnp.asarray(x), state=jst)
    got, new = rwkv6.time_mix(p, cfg, _t(x), state=st)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    if with_state:
        assert new is st   # updated in place
        np.testing.assert_array_equal(_np(st["shift"]), x[:, -1])
        np.testing.assert_allclose(_np(st["s"]), np.asarray(jnew["s"]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(rng, with_state):
    jcfg, cfg, jparams, params = _lm()
    jp, p = _layer0(jparams["blocks"]["cmix"]), tree_map(lambda a: a[0],
                                                         params["blocks"]["cmix"])
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want, _ = jrwkv.channel_mix(jp, jcfg, jnp.asarray(x),
                                state=jnp.asarray(shift) if with_state else None)
    st = _t(shift) if with_state else None
    got, new = rwkv6.channel_mix(p, cfg, _t(x), state=st)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    if with_state:
        assert new is st
        np.testing.assert_array_equal(_np(st), x[:, -1])


def test_prefill_and_decode_match_jax(rng):
    jcfg, cfg, jparams, params = _lm()
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    jc = japi.init_cache(jcfg, 2, 16)
    jl_pre, jc = japi.prefill(jparams, jcfg, jnp.asarray(toks[:, :8]), jc)
    jl_dec, jc = japi.decode_step(jparams, jcfg, jnp.asarray(toks[:, 8:9]), 8, jc)
    c = api.init_cache(cfg, 2, 16, CPU)
    l_pre, c2 = api.prefill(params, cfg, _t(toks[:, :8]), c)
    l_dec, c3 = api.decode_step(params, cfg, _t(toks[:, 8:9]), 8, c2)
    assert c3 is c2 is c   # the cache is updated in place
    for got, want in ((l_pre, jl_pre), (l_dec, jl_dec)):
        assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the recurrent state too, in the reference's layout
    for got, want in zip(tree_leaves(c), tree_leaves(jax.tree_util.tree_map(
            np.asarray, jc)), strict=True):
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)


def test_greedy_generate_matches_jax():
    """4 new tokens, max_seq 16, as tests/test_smoke_archs.py::test_decode_shapes."""
    jcfg, cfg, jparams, params = _lm()
    prompt = JaxLMBatches(jcfg, 2, 8).next(0)["tokens"]
    want = jax_greedy_generate(jcfg, jparams, prompt, 4, max_seq=16)
    stats = {}
    got = greedy_generate(cfg, params, _t(prompt), 4, max_seq=16, stats=stats)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(stats["logits"].argmax(-1).to(torch.int32), got)


def test_decode_matches_own_prefill(rng):
    """As tests/test_sequence_mixers.py::test_rwkv_decode_matches_prefill (2e-4)."""
    _, cfg, _, params = _lm()
    api = get_api(cfg)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    _, c = api.prefill(params, cfg, toks[:, :8], api.init_cache(cfg, 2, 16, CPU))
    l_dec, _ = api.decode_step(params, cfg, toks[:, 8:9], 8, c)
    l_full, _ = api.prefill(params, cfg, toks, api.init_cache(cfg, 2, 16, CPU))
    np.testing.assert_allclose(_np(l_dec), _np(l_full), rtol=2e-4, atol=2e-4)


def test_lm_loss_matches_jax():
    jcfg, cfg, jparams, params = _lm()
    jb = JaxLMBatches(jcfg, 2, 300).next(1)    # 300 > loss_chunk: two chunks
    want = jrwkv.lm_loss(jparams, jcfg, jb)
    got = rwkv6.lm_loss(params, cfg, {k: _t(v) for k, v in jb.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_other_configs_raise():
    cfg = get_arch("tinyllama-1.1b", smoke=True).model
    with pytest.raises(NotImplementedError):
        rwkv6.init_kv_cache(cfg, 1, 4, CPU)
