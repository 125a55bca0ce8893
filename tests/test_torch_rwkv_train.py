"""The port's RWKV-6 training path against the JAX package, at the smoke size
(f32, d 128, 2 heads, 2 layers), and the in-place dense AdamW it needs.

Inputs come from numpy with a seed; the port starts from the JAX package's
params through ``repro_torch.interop``, and both read bit-identical token
batches. On the CPU the wkv6 wrappers run their plain versions
(``ref.wkv6_ref`` forward, ``ref.wkv6_bwd_ref`` backward); the CUDA kernels
are held against those in ``test_torch_cuda.py``. Each test states its
tolerance.
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
from repro.data.synthetic import make_batches as jax_make_batches
from repro.models import rwkv6 as jrwkv
from repro.models.registry import get_api as jax_get_api
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core import embedding_ops
from repro_torch.core import relaxed as rx
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import make_batches
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import rwkv6
from repro_torch.optim import optimizers as opt
from repro_torch.pool import FaultSchedule, InjectedCrash
from repro_torch.training import train_loop
from repro_torch.tree import tree_leaves, tree_map

ARCH = "rwkv6-3b"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
K = rwkv6.HEAD_K


def _t(a):
    return torch.from_numpy(np.array(a))


def _wkv_case(rng, B, S, H, with_state):
    """r, k, v, logw, u, s0 as tests/test_torch_rwkv.py::_wkv_case makes
    them (s0 None without state), and the cotangents dy and ds_fin (None
    without state), all f32 numpy."""
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, S, H, K)) * 0.5 - 1),
                   rwkv6.LOG_W_MIN, -1e-4).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    s0 = (rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.1
          if with_state else None)
    dy = rng.standard_normal((B, S, H, K)).astype(np.float32)
    ds_fin = (rng.standard_normal((B, H, K, K)).astype(np.float32)
              if with_state else None)
    return r, k, v, logw, u, s0, dy, ds_fin


def _opt_t(a):
    return None if a is None else _t(a)


def _assert_grads_close(got, want, rel):
    """Each gradient within ``rel`` of its own largest magnitude."""
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30))


# -- the plain backward --------------------------------------------------------

# the S of test_torch_rwkv.py::test_wkv6_plain_matches_jax: one token, a
# ragged chunk, three chunks of 11 for the JAX grouping, whole chunks
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9, 33, 48, 64])
def test_wkv6_bwd_ref_matches_jax_vjp(rng, S, with_state):
    """dr, dk, dv, dlogw, du (and ds0) against ``jax.vjp`` of the
    reference's ``wkv6_chunked`` (which groups S by its largest divisor up
    to 16, so the chunk algebra runs over other groupings). 1e-5 of each
    gradient's largest magnitude: f32 on both sides (the measured gap is
    below 1e-6)."""
    r, k, v, logw, u, s0, dy, ds_fin = _wkv_case(rng, 2, S, 2, with_state)
    zeros = np.zeros((2, 2, K, K), np.float32)
    args = [jnp.asarray(a) for a in (r, k, v, logw, u,
                                     zeros if s0 is None else s0)]
    _, vjp = jax.vjp(jrwkv.wkv6_chunked, *args)
    want = vjp((jnp.asarray(dy), jnp.asarray(zeros if ds_fin is None else ds_fin)))
    got = ref.wkv6_bwd_ref(*(_opt_t(a) for a in (r, k, v, logw, u, s0, dy, ds_fin)))
    if s0 is None:
        assert got[5] is None
        got, want = got[:5], want[:5]
    _assert_grads_close([g.numpy() for g in got], want, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9, 33, 48, 64])
def test_wkv6_bwd_ref_matches_torch_autograd(rng, S, with_state):
    """The written-out backward against torch autograd through
    ``ref.wkv6_ref``: the same f32 algebra, other orders; 1e-5 of each
    gradient's largest magnitude."""
    case = [_opt_t(a) for a in _wkv_case(rng, 2, S, 2, with_state)]
    r, k, v, logw, u, s0, dy, ds_fin = case
    leaves = [x.clone().requires_grad_() for x in (r, k, v, logw, u, s0)
              if x is not None]
    y, s_fin = ref.wkv6_ref(*leaves, *([None] if s0 is None else []))
    outs, grads_out = (y, s_fin), (dy, ds_fin)
    if ds_fin is None:
        outs, grads_out = (y,), (dy,)
    want = torch.autograd.grad(outs, leaves, grads_out)
    got = ref.wkv6_bwd_ref(*case)
    _assert_grads_close([g.numpy() for g in got[:len(want)]],
                        [w.numpy() for w in want], 1e-5)


def test_wkv6_function_on_cpu_runs_the_plain_versions(rng):
    """With grad on, ``ops.wkv6`` goes through ``WKV6``: on the CPU its
    outputs are the plain forward's and its gradients the plain backward's,
    bitwise. Under no_grad nothing changes, and a differentiable call
    refuses ``s_out``. No kernel launches on the CPU."""
    r, k, v, logw, u, s0, dy, ds_fin = (_opt_t(a) for a in _wkv_case(rng, 2, 37, 2, True))
    before = (wk.launches, wk.bwd_launches)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, logw, u, s0)]
    y, s_fin = ops.wkv6(*leaves)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    want_y, want_s = ref.wkv6_ref(r, k, v, logw, u, s0)
    assert torch.equal(y.detach(), want_y) and torch.equal(s_fin.detach(), want_s)
    got = torch.autograd.grad((y, s_fin), leaves, (dy, ds_fin))
    for g, w in zip(got, ref.wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds_fin),
                    strict=True):
        assert torch.equal(g, w)
    # only y used: the final state's gradient is absent, taken as zero
    y, _ = ops.wkv6(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    for g, w in zip(got, ref.wkv6_bwd_ref(r, k, v, logw, u, s0, dy), strict=True):
        assert torch.equal(g, w)
    with torch.no_grad():
        y2, _ = ops.wkv6(*leaves)
    assert y2.grad_fn is None and torch.equal(y2, want_y)
    with pytest.raises(ValueError, match="s_out"):
        ops.wkv6(*leaves, s_out=s0.clone())
    assert (wk.launches, wk.bwd_launches) == before


def test_wkv6_bwd_casts_to_the_inputs_dtype(rng):
    """``ops.wkv6_bwd`` returns dr, dk, dv in r's dtype (the plain version's
    f32 rounded once), the rest in f32."""
    r, k, v, logw, u, _, dy, _ = (_opt_t(a) for a in _wkv_case(rng, 1, 20, 2, False))
    rb, kb, vb = (x.to(torch.bfloat16) for x in (r, k, v))
    got = ops.wkv6_bwd(rb, kb, vb, logw, u, None, dy)
    want = ref.wkv6_bwd_ref(rb, kb, vb, logw, u, None, dy)
    for g, w in zip(got[:3], want[:3], strict=True):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16))
    assert got[3].dtype == got[4].dtype == torch.float32 and got[5] is None
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


# the backward kernel's gate (tests/test_torch_cuda.py's WKV6_BWD_TOL): 1e-4
# of each gradient's largest magnitude
WKV6_BWD_TOL = 1e-4


# small heads and a short sequence with a state (whole chunks, and S = 33,
# which the JAX function groups in chunks of 11), and one sequence of 64
# chunks with no state, as training calls it
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,with_state", [(2, 64, 2, True), (2, 33, 2, True),
                                              (1, 1024, 1, False)])
def test_wkv6_bwd_tf32_split_emulation_within_gate(rng, dtype, B, S, H, with_state):
    """The backward kernel's arithmetic (every tensor-core product's
    operands as TF32 hi + lo terms; ``ref.wkv6_bwd_ref(..., tf32="split")``)
    against ``jax.vjp`` of ``wkv6_chunked`` on the same inputs, logw
    log-uniform over the whole clamp range [-5, -1e-4] and r, k, v rounded
    to ``dtype``: within WKV6_BWD_TOL of each gradient's largest magnitude.
    Prints the share of the gate the split uses and the share one TF32
    rounding of each operand would use (run with -s)."""
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, K)).astype(np.float32)
                                * 0.5).to(dtype).float().numpy() for _ in range(3))
    logw = -np.exp(rng.uniform(np.log(1e-4), np.log(-rwkv6.LOG_W_MIN),
                               (B, S, H, K))).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.1
    dy = rng.standard_normal((B, S, H, K)).astype(np.float32)
    ds_fin = rng.standard_normal((B, H, K, K)).astype(np.float32)
    if not with_state:
        s0, ds_fin = np.zeros_like(s0), np.zeros_like(ds_fin)
    _, vjp = jax.vjp(jrwkv.wkv6_chunked, *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    want = [np.asarray(w, np.float64)
            for w in vjp((jnp.asarray(dy), jnp.asarray(ds_fin)))]
    args = [_t(a) for a in (r, k, v, logw, u)]
    state = (_t(s0), _t(dy), _t(ds_fin)) if with_state else (None, _t(dy), None)
    shares = {}
    for mode in ("split", "single"):
        got = ref.wkv6_bwd_ref(*args, *state, tf32=mode)
        pairs = zip(got if with_state else got[:5], want if with_state else want[:5],
                    strict=True)
        shares[mode] = max(
            float(np.abs(g.double().numpy() - w).max()
                  / (WKV6_BWD_TOL * max(np.abs(w).max(), 1e-30)))
            for g, w in pairs)
    print(f"wkv6 backward TF32 emulation, {dtype} {B, S, H} state={with_state}: share "
          f"of the 1e-4 gate used by the split {shares['split']:.4f}, by a single "
          f"rounding {shares['single']:.2f}")
    assert shares["split"] <= 1.0


# -- the in-place dense AdamW --------------------------------------------------

def _leaves(rng, dtype, stacked):
    """A small tree of dense leaves in ``dtype`` (norm weights stay f32, as
    rwkv6's mu and u do), with a stacked (L, a, b) leaf."""
    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return {"w": arr(6, 10).to(dtype), "b": arr(10),
            "stack": arr(*stacked).to(dtype)}


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_inplace_is_bitwise_the_functional(rng, monkeypatch, dtype,
                                                 weight_decay, sliced):
    """Three steps of ``update_inplace`` give the params, m, v and t of
    ``update`` plus ``(p.f32 + u).to(p.dtype)`` bit for bit, on f32 and
    bf16 leaves, with and without weight decay; ``sliced`` makes the
    stacked leaf (5, 9, 7) walk in slices of its leading axis (a slice
    limit of 130 elements: two layers at a time, and a ragged last)."""
    if sliced:
        monkeypatch.setattr(opt, "SLICE_ELEMS", 130)
        assert len(list(opt.leaf_slices(torch.zeros(5, 9, 7)))) == 3
    params = _leaves(rng, dtype, (5, 9, 7))
    adam = opt.adamw(1e-2, weight_decay=weight_decay)
    p_fun, p_in = tree_map(torch.clone, params), tree_map(torch.clone, params)
    s_fun, s_in = adam.init(p_fun), adam.init(p_in)
    for step in range(3):
        grads = _leaves(np.random.default_rng(step), dtype, (5, 9, 7))
        upd, s_fun = adam.update(grads, s_fun, p_fun)
        p_fun = tree_map(lambda p, u: (p.float() + u).to(p.dtype), p_fun, upd)
        m_before = tree_leaves(s_in["m"])
        s_in = adam.update_inplace(grads, s_in, p_in)
        assert all(a is b for a, b in zip(m_before, tree_leaves(s_in["m"]), strict=True))
    for a, b in zip(tree_leaves((p_fun, s_fun)), tree_leaves((p_in, s_in)), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_clip_inplace_is_bitwise(rng, dtype):
    """The in-place clip scales the grads to the bits of ``global_norm_clip``
    and returns the same norm; a norm under the limit leaves them as they
    are."""
    for max_norm in (0.5, 1e6):
        grads = _leaves(rng, dtype, (3, 4, 5))
        want, norm = opt.global_norm_clip(grads, max_norm)
        got = tree_map(torch.clone, grads)
        assert torch.equal(opt.global_norm_clip_(got, max_norm), norm)
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert torch.equal(a, b)


def test_step_updates_the_dense_tier_in_place():
    """A step returns a state whose dense leaves and moments are the ones
    it was given, updated: their values equal the functional update's."""
    cfg = get_arch(ARCH, smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05)
    state = train_loop.init_state(cfg, tc, "cpu")
    dense = tree_leaves((state["dense"], state["opt_dense"]["m"], state["opt_dense"]["v"]))
    before = [p.clone() for p in tree_leaves(state["dense"])]
    new, _ = train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"), 1,
                              relaxed=False, state=state, device="cpu")
    after = tree_leaves((new["dense"], new["opt_dense"]["m"], new["opt_dense"]["v"]))
    assert all(a is b for a, b in zip(dense, after, strict=True))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(new["dense"]), strict=True))
    assert int(new["opt_dense"]["t"]) == 1


# -- the model's loss and gradients ---------------------------------------------

def _jax_lm():
    jcfg = jax_get_arch(ARCH, smoke=True).model
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, interop.params_from_numpy(jparams, CPU)


def test_step_loss_and_grads_match_jax():
    """One step's loss and its gradients, w.r.t. every dense leaf and the
    looked-up token rows, against ``jax.value_and_grad(lm_loss)``; the JAX
    side differentiates ``wkv6_chunked`` through XLA, the port runs the
    plain backward. 1e-5 relative to each leaf's largest gradient (f32 on
    both sides)."""
    jcfg, jparams, params = _jax_lm()
    cfg = get_arch(ARCH, smoke=True).model
    batch = make_batches(cfg, 4, 16, device="cpu").next(0)
    jbatch = jax_make_batches(jcfg, 4, 16).next(0)
    jrows = jparams["embed"]["table"][jbatch["tokens"]]
    jdense = {k: v for k, v in jparams.items() if k != "embed"}

    def jloss(dense, rows):
        return jrwkv.lm_loss({**dense, "embed": jparams["embed"]}, jcfg,
                             {**jbatch, "embed_rows": rows})
    jl, (jgd, jgr) = jax.value_and_grad(jloss, argnums=(0, 1))(jdense, jrows)

    dense = tree_map(lambda p: p.clone().requires_grad_(),
                     {k: v for k, v in params.items() if k != "embed"})
    rows = embedding_ops.lookup(params["embed"]["table"], batch["tokens"])
    rows.requires_grad_()
    loss = rwkv6.lm_loss({**dense, "embed": params["embed"]}, cfg,
                         {**batch, "embed_rows": rows})
    grads = torch.autograd.grad(loss, tree_leaves(dense) + [rows])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want = jax.tree_util.tree_leaves(jgd) + [jgr]
    assert len(grads) == len(want)
    _assert_grads_close([g.numpy() for g in grads], want, 1e-5)


def test_remat_gives_bitwise_equal_grads(monkeypatch):
    """Per-block activation checkpointing changes what is kept, not what is
    computed: the loss and gradients equal those without remat bit for bit.
    With remat each layer's wkv6 forward runs twice (the recompute), and
    the backward once a layer either way."""
    cfg = get_arch(ARCH, smoke=True).model
    _, _, params = _jax_lm()
    batch = make_batches(cfg, 2, 16, device="cpu").next(0)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.wkv6_ref, ref.wkv6_bwd_ref

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(ref, "wkv6_ref", count("fwd", fwd))
    monkeypatch.setattr(ref, "wkv6_bwd_ref", count("bwd", bwd))
    out, L = {}, cfg.num_layers
    for remat in (False, True):
        calls.update(fwd=0, bwd=0)
        c = cfg.replace(remat=remat)
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss = rwkv6.lm_loss(tree_map(lambda _: next(it), params), c, batch)
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
        assert calls == {"fwd": L * (2 if remat else 1), "bwd": L}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)


# -- training --------------------------------------------------------------------

def _port_run(steps, relaxed, params=None, lr=0.05, tc=None):
    cfg = get_arch(ARCH, smoke=True).model
    tc = tc or TrainConfig(embed_learning_rate=lr)
    state = None if params is None else \
        train_loop.make_step_fns(cfg, tc)[0](tree_map(torch.clone, params))
    return train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"),
                            steps, relaxed=relaxed, state=state, device="cpu")


@pytest.mark.parametrize("relaxed", [True, False])
def test_loss_curve_matches_jax(relaxed):
    """Five steps from the same init and batches as
    ``repro.training.train_loop.train`` (AdamW on the dense tier, SGD on
    the table); 1e-5 relative."""
    jcfg = jax_get_arch(ARCH, smoke=True).model
    jtc = JaxTrainConfig()
    jstate = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, jst.params_of(jstate)), CPU)
    _, jl = jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=0), 5,
                      relaxed=relaxed, state=jstate)
    _, tl = _port_run(5, relaxed, params=params, tc=TrainConfig())
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=0)


@pytest.mark.parametrize("lr", [0.05, 0.5])
def test_strict_equals_relaxed_bitwise(lr):
    """The paper's claim for row-gather models, as tests/test_relaxed.py:28-33
    holds it for rwkv6-3b: the relaxed losses equal the strict ones bit for
    bit."""
    _, s = _port_run(4, relaxed=False, lr=lr)
    _, r = _port_run(4, relaxed=True, lr=lr)
    assert np.isfinite(s).all() and len(s) == 4
    assert s == r, (s, r)


def test_relaxed_prefetch_is_the_updated_lookup():
    """After relaxed steps the carried rows are bitwise a fresh lookup of
    the updated table, and the correction's scratch is zero again."""
    cfg = get_arch(ARCH, smoke=True).model
    state, _ = _port_run(2, relaxed=True, lr=0.5)
    nxt = make_batches(cfg, 4, 16, device="cpu").next(2)
    assert torch.equal(state["prefetch"]["rows"],
                       rx.lookup_rows(state["embed"], cfg, nxt))
    assert not state["prefetch"]["scratch"].any()


@pytest.mark.parametrize("backend", ["dram", "pmem"])
def test_checkpointed_crash_recovers_bitwise_and_resumes(tmp_path, backend):
    """The manager's drill of tests/test_torch_checkpoint.py on rwkv6: power
    loss after step 3's undo COMMIT, before its mirror apply. Recovery
    rolls back to the step-2 mirror bit for bit, and the resumed run gives
    the uninterrupted run's losses exactly (an LM's rebuilt carry is
    bitwise the carried one, and tier-M restores the dense tier and its
    moments bitwise)."""
    cfg = get_arch(ARCH, smoke=True).model

    def setup(name):
        cc = CheckpointConfig(directory=str(tmp_path / name), dense_interval=1,
                              pool_backend=backend)
        return cc, TrainConfig(embed_learning_rate=0.05, checkpoint=cc)

    def fresh(tc):
        return train_loop.init_state(cfg, tc, "cpu")

    data = make_batches(cfg, 4, 16, seed=3, device="cpu")
    cc, tc = setup("ck")
    _, full = train_loop.train(cfg, tc, data, 6, relaxed=True, device="cpu")
    ref_cc, _ = setup("ref")
    st = fresh(tc)
    mgr = CheckpointManager(cfg, ref_cc, embed_init=st["embed"])
    train_loop.train(cfg, tc, data, 3, relaxed=True, state=st, ckpt_manager=mgr)
    ref_rows = np.array(mgr.mirror_rows)
    mgr.pool.close()
    st = fresh(tc)
    mgr = CheckpointManager(cfg, cc, embed_init=st["embed"], faults=FaultSchedule.crash_at(
        "tier_e.between-commit-and-apply", occurrence=4))
    with pytest.raises(InjectedCrash):
        train_loop.train(cfg, tc, data, 6, relaxed=True, state=st, ckpt_manager=mgr)
    if backend == "dram":
        mgr.pool.crash()                   # power loss: cache dropped
        rec = recovery.recover(cc.directory, pool=mgr.pool)
    else:
        mgr.pool.close()                   # process death: reopen from disk
        rec = recovery.recover(cc.directory)
    assert rec.mirror_step == 2 and rec.dense_step == 2 and rec.rolled_back
    assert rec.table_name == "table"
    np.testing.assert_array_equal(rec.embed_rows, ref_rows)   # bit-identical
    st, resume = recovery.resume_train_state(rec, fresh(tc))
    assert resume == 3
    _, tail = train_loop.train(cfg, tc, data, 3, relaxed=True, state=st,
                               start_step=resume, device="cpu")
    assert tail == full[3:], (tail, full[3:])
    rec.pool.close()


def test_cli_trains_rwkv6_on_cpu():
    """``launch.train --arch rwkv6-3b`` trains (this replaces the test that
    held its refusal)."""
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        ARCH, "--device", "cpu", "--steps", "1", "--seq", "16"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done on cpu: 1 steps" in r.stdout
