"""The port's mamba layer and jamba (mamba and attention interleaved, MoE
every other layer) against the JAX package, at the smoke size (f32).

Inputs come from numpy with a seed; the port starts from the JAX package's
params through ``repro_torch.interop``. The SSD scan has no Pallas kernel
in the reference, so both sides are plain code; the chunked scan is also
held against the sequential oracle, ``ref.mamba_ssd_ref``, in each
package. Each test states its tolerance.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.data.synthetic import make_batches as jax_make_batches
from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro.models import transformer as jtransformer
from repro.models.registry import get_api as jax_get_api
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro.training.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import make_batches
from repro_torch.kernels import ref
from repro_torch.models import mamba, transformer
from repro_torch.models.registry import get_api
from repro_torch.training import train_loop
from repro_torch.training.serve_loop import greedy_generate
from repro_torch.tree import tree_leaves, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
JAMBA = "jamba-v0.1-52b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _jamba(**replace):
    """(JAX cfg, port cfg, JAX params, the same params as port tensors) of
    smoke jamba, its fields replaced by ``replace``."""
    jcfg = jax_get_arch(JAMBA, smoke=True).model.replace(**replace)
    cfg = get_arch(JAMBA, smoke=True).model.replace(**replace)
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, interop.params_from_numpy(jparams, CPU)


def _close(got_tree, want_tree, tol):
    got, want = tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert [tuple(g.shape) for g in got] == [np.asarray(w).shape for w in want]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


# -- the SSD scan and the mamba layer ------------------------------------------

# the cases of tests/test_sequence_mixers.py::test_mamba_ssd_chunked_vs_sequential
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 2, 64, 16, 16), (1, 40, 1, 64, 8, 16)])
def test_ssd_chunked_matches_jax_and_oracle(rng, B, S, H, P, N, chunk):
    """The chunked scan against the JAX package's within 1e-5, and against
    the sequential oracle within that test's 2e-4; the port's oracle against
    the JAX one within 1e-5."""
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    a = -(np.abs(rng.standard_normal((H,))) + .1).astype(np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    args = (xh, dt, a, B_, C_)
    jy, jh = jmamba._ssd_chunked(*map(jnp.asarray, args), chunk)
    y, h = mamba._ssd_chunked(*map(_t, args), chunk)
    ry, rh = ref.mamba_ssd_ref(*map(_t, args))
    jry, jrh = jref.mamba_ssd_ref(*map(jnp.asarray, args))
    for got, want in ((y, jy), (h, jh), (ry, jry), (rh, jrh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for got, want in ((y, ry), (h, rh)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_gradient_where_the_mask_overflows_reference_nan_port_finite(rng):
    """At jamba's full width a = -(1 .. 128), so a chunk's exponents above
    its diagonal pass f32's range. The reference masks exp(seg) after
    computing it (``src/repro/models/mamba.py:80-82``): its forward is
    finite, but the backward multiplies the masked inf by 0, and the
    gradient w.r.t. dt is NaN. The port masks the exponent, and its
    gradients equal autograd through the sequential oracle within 2e-4
    of each one's largest (the reference's gradient w.r.t. xh, which is
    finite, within 1e-5)."""
    B, S, H, P, N = 1, 64, 2, 64, 16
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, H))) * 0.1 + 0.05).astype(np.float32)
    a = -np.array([1.0, 128.0], np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)

    def jloss(xh, dt):
        return jnp.sum(jmamba._ssd_chunked(xh, dt, jnp.asarray(a), jnp.asarray(B_),
                                           jnp.asarray(C_), 64)[0])
    jgx, jgd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(dt))
    assert bool(jnp.isfinite(jgx).all()) and not bool(jnp.isfinite(jgd).all())
    got, want = [], []
    for fn, out in ((lambda *t: mamba._ssd_chunked(*t, 64), got),
                    (ref.mamba_ssd_ref, want)):
        tx, td = _t(xh).requires_grad_(), _t(dt).requires_grad_()
        y, _ = fn(tx, td, _t(a), _t(B_), _t(C_))
        out.extend(torch.autograd.grad(y.sum(), (tx, td)))
    for g, w in zip(got, want, strict=True):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * w.abs().max().item())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)


def test_conv1d_causal_matches_jax(rng):
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jmamba._conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = mamba._conv1d_causal(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [8, 2])
def test_mamba_fwd_prefill_and_decode_match_jax(rng, S):
    """A prefill of S tokens (S = 2: fewer than the conv's K - 1 = 3, so
    its window is padded), then a decode step from its state: outputs and
    states within 1e-5."""
    jcfg = jax_get_arch(JAMBA, smoke=True).model
    cfg = get_arch(JAMBA, smoke=True).model
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    p = interop.params_from_numpy(jp, CPU)
    assert p["dt_bias"].dtype == p["a_log"].dtype == p["d_skip"].dtype == torch.float32
    x = rng.standard_normal((2, S + 1, cfg.d_model)).astype(np.float32)
    js = jmamba.init_mamba_state(jcfg, 2)
    jo, js = jmamba.mamba_fwd(jp, jcfg, jnp.asarray(x[:, :S]), state=js)
    jd, js = jmamba.mamba_fwd(jp, jcfg, jnp.asarray(x[:, S:]), state=js)
    st = mamba.init_mamba_state(cfg, 2, CPU)
    o, st2 = mamba.mamba_fwd(p, cfg, _t(x[:, :S]), state=st, cache_index=0)
    assert st2 is st                                     # written in place
    _close({"conv": st["conv"], "h": st["h"]},
           jmamba.mamba_fwd(jp, jcfg, jnp.asarray(x[:, :S]),
                            state=jmamba.init_mamba_state(jcfg, 2))[1], 1e-5)
    d, _ = mamba.mamba_fwd(p, cfg, _t(x[:, S:]), state=st, cache_index=S)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    _close(st, js, 1e-5)
    # without a state, the prefill's output is the same and nothing is kept
    o2, none = mamba.mamba_fwd(p, cfg, _t(x[:, :S]))
    assert none is None and torch.equal(o2, o)


# -- jamba -------------------------------------------------------------------------

def test_jamba_config_and_tree_match_jax():
    """Config, layer and FFN types and param counts at both sizes; the
    init's tree (the "groups" layout) in shapes and dtypes."""
    for smoke in (True, False):
        jcfg = jax_get_arch(JAMBA, smoke=smoke).model
        cfg = get_arch(JAMBA, smoke=smoke).model
        assert cfg.layer_types == jcfg.layer_types
        assert cfg.ffn_types == jcfg.ffn_types
        assert cfg.param_counts() == jcfg.param_counts()
    _, cfg, jparams, params = _jamba()
    gen = torch.Generator()
    gen.manual_seed(0)
    got = transformer.init_lm(gen, cfg)
    assert "groups" in got and len(got["groups"]) == cfg.attn_layer_period
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(got)] == \
        [(tuple(t.shape), t.dtype) for t in tree_leaves(params)]


@pytest.mark.parametrize("layers", [8, 6])
def test_jamba_lm_loss_matches_jax(layers):
    """8 layers: the "groups" layout (two periods of 4); 6: the per-layer
    "layers" layout. The loss with its router term within 1e-5."""
    jcfg, cfg, jparams, params = _jamba(num_layers=layers)
    assert ("groups" in params) == (layers == 8) and ("layers" in params) == (layers == 6)
    jb = JaxLMBatches(jcfg, 2, 300).next(1)              # two loss chunks
    want = jtransformer.lm_loss(jparams, jcfg, jb)
    got = transformer.lm_loss(params, cfg, {k: _t(v) for k, v in jb.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_jamba_prefill_and_decode_match_jax(rng):
    """Prefill and decode logits within 1e-4, as the dense LMs'
    (tests/test_torch_lm.py); the mixed caches (attention k/v, mamba h and
    conv, stacked over the groups) against the reference's tree."""
    jcfg, cfg, jparams, params = _jamba()
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    jc = japi.init_cache(jcfg, 2, 16)
    jl_pre, jc = japi.prefill(jparams, jcfg, jnp.asarray(toks[:, :8]), jc)
    jl_dec, jc = japi.decode_step(jparams, jcfg, jnp.asarray(toks[:, 8:9]), 8, jc)
    c = api.init_cache(cfg, 2, 16, CPU)
    l_pre, c2 = api.prefill(params, cfg, _t(toks[:, :8]), c)
    assert c2 is c
    l_dec, c = api.decode_step(params, cfg, _t(toks[:, 8:9]), 8, c)
    for got, want in ((l_pre, jl_pre), (l_dec, jl_dec)):
        assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert [sorted(e) for e in c] == [["k", "v"] if t == "attn" else ["conv", "h"]
                                      for t in cfg.layer_types[:cfg.attn_layer_period]]
    _close(c, jc, 1e-4)


def test_jamba_decode_matches_own_prefill(rng):
    """As tests/test_sequence_mixers.py::test_jamba_decode_matches_prefill:
    prefill(S) then decode == prefill(S + 1), 2e-3."""
    _, cfg, _, params = _jamba()
    api = get_api(cfg)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    _, c = api.prefill(params, cfg, toks[:, :8], api.init_cache(cfg, 2, 16, CPU))
    l_dec, _ = api.decode_step(params, cfg, toks[:, 8:9], 8, c)
    l_full, _ = api.prefill(params, cfg, toks, api.init_cache(cfg, 2, 16, CPU))
    np.testing.assert_allclose(l_dec.numpy(), l_full.numpy(), rtol=2e-3, atol=2e-3)


def test_jamba_greedy_generate_matches_jax():
    jcfg, cfg, jparams, params = _jamba()
    prompt = JaxLMBatches(jcfg, 2, 8).next(0)["tokens"]
    want = jax_greedy_generate(jcfg, jparams, prompt, 4, max_seq=16)
    got = greedy_generate(cfg, params, _t(prompt), 4, max_seq=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_that_continues_a_state_reference_wrong_port_raises(rng):
    """The reference's fault: a jamba prefill of 8 tokens in two parts, at
    cache_index 0 and then 4. The reference's mamba layers start the second
    part's scan from zeros (``src/repro/models/mamba.py:119-150``), so their
    states differ from those of one prefill of the 8, and so do the
    logits (``-s`` prints the gap). The port raises on the second part."""
    jcfg, cfg, jparams, params = _jamba()
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    japi = jax_get_api(jcfg)
    whole, jc_whole = japi.prefill(jparams, jcfg, toks, japi.init_cache(jcfg, 2, 16))
    jc = japi.init_cache(jcfg, 2, 16)
    _, jc, _ = jtransformer.forward_hidden(jparams, jcfg, toks[:, :4], caches=jc,
                                           cache_index=0)
    hidden, jc, _ = jtransformer.forward_hidden(jparams, jcfg, toks[:, 4:], caches=jc,
                                                cache_index=4)
    parts = (hidden[:, -1] @ jtransformer.head_matrix(jparams, jcfg)).astype(jnp.float32)
    mamba_at = [i for i, t in enumerate(cfg.layer_types[:cfg.attn_layer_period])
                if t == "mamba"]
    gaps = [float(jnp.abs(jc[i]["h"] - jc_whole[i]["h"]).max()) for i in mamba_at]
    gap = float(jnp.abs(parts - whole).max())
    print(f"reference: mamba states off by up to {max(gaps):.3g}; last-token "
          f"logits off by {gap:.3g} (largest {float(jnp.abs(whole).max()):.3g})")
    assert min(gaps) > 1e-3 and gap > 1e-3
    c = get_api(cfg).init_cache(cfg, 2, 16, CPU)
    transformer.forward_hidden(params, cfg, _t(toks[:, :4]), caches=c, cache_index=0)
    with pytest.raises(ValueError, match="cache_index 4"):
        transformer.forward_hidden(params, cfg, _t(toks[:, 4:]), caches=c, cache_index=4)


def test_layers_layout_caches_reference_fails_port_raises(rng):
    """At a depth the period does not divide (6 of period 4), the params
    take the per-layer layout but ``init_kv_cache`` gives the group one
    in both packages (``src/repro/models/transformer.py:230-235``): the
    reference's prefill fails on it, and the port's raises its own error."""
    jcfg, cfg, jparams, params = _jamba(num_layers=6)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    jc, c = japi.init_cache(jcfg, 2, 16), api.init_cache(cfg, 2, 16, CPU)
    _close(c, jc, 0)
    with pytest.raises(Exception):
        japi.prefill(jparams, jcfg, jnp.asarray(toks), jc)
    with pytest.raises(ValueError, match="per-layer layout"):
        api.prefill(params, cfg, _t(toks), c)


# -- training ----------------------------------------------------------------------

def _port_run(steps, relaxed, params=None, tc=None):
    cfg = get_arch(JAMBA, smoke=True).model
    tc = tc or TrainConfig(embed_learning_rate=0.05)
    state = None if params is None else \
        train_loop.make_step_fns(cfg, tc)[0](tree_map(torch.clone, params))
    return train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"),
                            steps, relaxed=relaxed, state=state, device="cpu")


@pytest.mark.parametrize("relaxed", [True, False])
def test_jamba_loss_curve_matches_jax(relaxed):
    """Five steps from the same init and batches as
    ``repro.training.train_loop.train``; 1e-5 relative."""
    jcfg = jax_get_arch(JAMBA, smoke=True).model
    jtc = JaxTrainConfig()
    jstate = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, jst.params_of(jstate)), CPU)
    _, jl = jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=0), 5,
                      relaxed=relaxed, state=jstate)
    _, tl = _port_run(5, relaxed, params=params, tc=TrainConfig())
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=0)


def test_jamba_strict_equals_relaxed_bitwise():
    _, s = _port_run(4, relaxed=False)
    _, r = _port_run(4, relaxed=True)
    assert np.isfinite(s).all() and len(s) == 4
    assert s == r, (s, r)


def test_jamba_remat_gives_bitwise_equal_grads():
    """Per-block checkpointing over the groups: loss and gradients bitwise
    those without remat."""
    _, cfg, _, params = _jamba()
    batch = make_batches(cfg, 2, 16, device="cpu").next(0)
    out = {}
    for remat in (False, True):
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss = transformer.lm_loss(tree_map(lambda _: next(it), params),
                                   cfg.replace(remat=remat), batch)
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)


def test_cli_trains_jamba_on_cpu():
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        JAMBA, "--device", "cpu", "--steps", "3", "--seq", "16"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done on cpu: 3 steps" in r.stdout
