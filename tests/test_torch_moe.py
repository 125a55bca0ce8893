"""The port's MoE FFN and the MoE transformers (qwen3-moe-235b-a22b,
arctic-480b) against the JAX package, at the smoke size (f32).

Inputs come from numpy with a seed; the port starts from the JAX package's
params through ``repro_torch.interop``. MoE has no Pallas kernel in the
reference, so both sides are plain code. Each test states its tolerance.
The MoE ids' serving cases run with the dense ones in ``test_torch_lm.py``;
their training cases run here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import make_batches as jax_make_batches
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.registry import get_api as jax_get_api
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import embedding_ops
from repro_torch.data.synthetic import make_batches
from repro_torch.models import moe, transformer
from repro_torch.training import train_loop
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
MOE_IDS = ["qwen3-moe-235b-a22b", "arctic-480b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe(arch, seed=0):
    """(JAX cfg, port cfg, JAX moe params, the same as port tensors)."""
    jcfg = jax_get_arch(arch, smoke=True).model
    cfg = get_arch(arch, smoke=True).model
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, interop.params_from_numpy(jp, CPU)


@pytest.mark.parametrize("T,k,e", [(16, 2, 4), (64, 2, 4), (4, 8, 128),
                                   (4096, 8, 128), (4100, 2, 16), (7, 1, 3)])
def test_capacity_matches_jax(T, k, e):
    assert moe._capacity(T, k, e) == jmoe._capacity(T, k, e)


@pytest.mark.parametrize("T,d,E,k", [(16, 64, 4, 2), (40, 32, 16, 8), (9, 16, 3, 1)])
def test_route_matches_jax(rng, T, d, E, k):
    """Choices equal exactly; gates and aux within 1e-6 (f32 softmax and
    renormalisation on both sides)."""
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    jg, jc, ja = jmoe.route(jnp.asarray(w), jnp.asarray(x), k)
    g, c, a = moe.route(_t(w), _t(x), k)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a.item(), float(ja), rtol=1e-6, atol=1e-6)


def test_route_leaves_the_tf32_setting_as_it_found_it(rng):
    x = _t(rng.standard_normal((8, 16)).astype(np.float32))
    w = _t(rng.standard_normal((16, 4)).astype(np.float32))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            moe.route(w, x, 2)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("arch", MOE_IDS + ["jamba-v0.1-52b"])
def test_moe_fwd_matches_jax(rng, arch):
    """Output and aux within the reference's 1e-5
    (tests/test_attention_and_moe.py:87-89); arctic adds its dense
    residual."""
    jcfg, cfg, jp, p = _moe(arch)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jo, ja = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    o, a = moe.moe_fwd(p, cfg, _t(x))
    assert o.dtype == torch.float32 and o.shape == x.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.item(), float(ja), rtol=1e-5)


def _reference_drops(jp, xt, gate, choice, k, E, C):
    """The (token, slot) pairs the reference's ``_moe_local`` drops: with
    the gates of all slots but one set to 0, a token's output is 0 exactly
    where that one slot was dropped."""
    dropped = []
    for j in range(k):
        only = gate * (jnp.arange(k) == j)[None, :]
        out = jmoe._moe_local(xt, only, choice, jp["wi"], jp["wg"], jp["wo"],
                              top_k=k, num_experts=E, e_offset=0, capacity=C)
        dropped.append(np.all(np.asarray(out) == 0, axis=1))
    return np.stack(dropped, axis=1)


def test_capacity_overflow_drops_the_reference_tokens(rng):
    """A router biased to expert 0 sends every token there: 64 tokens over
    a capacity of 40 drop the 24 last of them (their slot at expert 0);
    the port drops exactly the reference's pairs, and the outputs agree
    within 1e-5."""
    jcfg, cfg, jp, p = _moe("qwen3-moe-235b-a22b")
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    bias = np.zeros((cfg.d_model, E), np.float32)
    bias[:, 0] = 0.1          # |x| summed over d: about +5 on its logit
    router = np.asarray(jp["router"]) + bias
    jp = {**jp, "router": jnp.asarray(router)}
    p = {**p, "router": _t(router)}
    x = np.abs(rng.standard_normal((2, 32, cfg.d_model))).astype(np.float32)
    T, C = 64, moe._capacity(64, k, E)
    assert C == 40
    jg, jc, _ = jmoe.route(jp["router"], jnp.asarray(x.reshape(T, -1)), k)
    assert (np.asarray(jc) == 0).any(axis=1).all()      # every token at expert 0
    want = _reference_drops(jp, jnp.asarray(x.reshape(T, -1)), jg, jc, k, E, C)
    assert want.sum() == T - C
    with moe.recording() as rec:
        o, _ = moe.moe_fwd(p, cfg, _t(x))
    assert len(rec) == 1
    np.testing.assert_array_equal(rec[0]["dropped"].numpy(), want)
    np.testing.assert_array_equal(rec[0]["choice"].numpy(), np.asarray(jc))
    jo, _ = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", MOE_IDS)
def test_moe_gradients_match_jax(rng, arch):
    """Gradients of sum(out^2) + 0.01 aux (as test_moe_gradients_flow)
    w.r.t. the router, wi, wg, wo (arctic: its dense residual too) and x,
    against ``jax.grad``: 1e-5 of each leaf's largest gradient."""
    jcfg, cfg, jp, p = _moe(arch)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)

    def jloss(jp, x):
        out, aux = jmoe.moe_fwd(jp, jcfg, x)
        return jnp.sum(out ** 2) + 0.01 * aux
    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [a.clone().requires_grad_() for a in tree_leaves(p)]
    it = iter(leaves)
    tx = _t(x).requires_grad_()
    out, aux = moe.moe_fwd(tree_map(lambda _: next(it), p), cfg, tx)
    got = torch.autograd.grad(torch.sum(out ** 2) + 0.01 * aux, leaves + [tx])
    want = jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    names = [".".join(k) for k in _paths(p)] + ["x"]
    assert {"router", "wi", "wg", "wo"} <= set(names)
    assert ("dense.wi" in names) == cfg.moe.dense_residual
    for n, g, w in zip(names, got, want, strict=True):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=n)


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], pre + (k,))]
    return [pre]


def test_dispatch_and_combine_are_adjoint(rng):
    """<dispatch(x), y> == <x, combine(y)>, and each one's backward is the
    other: the gradient of the dispatch is the combine of its cotangent,
    bitwise, and the other way round."""
    T, d, E, k = 24, 8, 4, 2
    choice = torch.from_numpy(np.stack([rng.choice(E, k, replace=False)
                                        for _ in range(T)]))
    C = 8                                                 # some pairs dropped
    src, slot, _, dropped = moe._plan(choice, E, C)
    assert dropped.any() and not dropped.all()
    x = _t(rng.standard_normal((T, d)).astype(np.float64)).requires_grad_()
    y = _t(rng.standard_normal((E * C, d)).astype(np.float64)).requires_grad_()
    xe = moe._Dispatch.apply(x, src, slot)
    out = moe._Combine.apply(y, src, slot)
    torch.testing.assert_close((xe * y).sum(), (x * out).sum(), rtol=1e-12, atol=1e-12)
    gx, = torch.autograd.grad(xe, x, y.detach())
    assert torch.equal(gx, moe._Combine.apply(y.detach(), src, slot))
    gy, = torch.autograd.grad(out, y, x.detach())
    assert torch.equal(gy, moe._Dispatch.apply(x.detach(), src, slot))
    # a token's window slots, ascending in expert, each kept pair once
    kept = slot[slot < E * C]
    assert kept.unique().numel() == kept.numel() == int((~dropped).sum())
    assert bool((src[kept] == torch.arange(T)[:, None].expand(T, k)[slot < E * C]).all())


def test_touched_experts_matches_jax(rng):
    cfg = get_arch("qwen3-moe-235b-a22b", smoke=True).model
    jcfg = jax_get_arch("qwen3-moe-235b-a22b", smoke=True).model
    choice = rng.integers(0, 3, (5, 2)).astype(np.int32)   # expert 3 untouched
    want = jmoe.touched_experts(jcfg, jnp.asarray(choice))
    got = moe.touched_experts(cfg, _t(choice).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the MoE transformers' training --------------------------------------------

def _port_run(arch, steps, relaxed, params=None, tc=None):
    cfg = get_arch(arch, smoke=True).model
    tc = tc or TrainConfig(embed_learning_rate=0.05)
    state = None if params is None else \
        train_loop.make_step_fns(cfg, tc)[0](tree_map(torch.clone, params))
    return train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"),
                            steps, relaxed=relaxed, state=state, device="cpu")


@pytest.mark.parametrize("arch", MOE_IDS)
def test_step_loss_and_grads_match_jax(arch):
    """One step's loss (the router term included) and its gradients, w.r.t.
    every dense leaf and the looked-up token rows, against
    ``jax.value_and_grad(lm_loss)``: 1e-5 of each leaf's largest gradient."""
    jcfg = jax_get_arch(arch, smoke=True).model
    cfg = get_arch(arch, smoke=True).model
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jparams, CPU)
    batch = make_batches(cfg, 4, 16, device="cpu").next(0)
    jbatch = jax_make_batches(jcfg, 4, 16).next(0)
    jrows = jparams["embed"]["table"][jbatch["tokens"]]
    jdense = {k: v for k, v in jparams.items() if k != "embed"}

    def jloss(dense, rows):
        return jtransformer.lm_loss({**dense, "embed": jparams["embed"]}, jcfg,
                                    {**jbatch, "embed_rows": rows})
    jl, (jgd, jgr) = jax.value_and_grad(jloss, argnums=(0, 1))(jdense, jrows)
    dense = tree_map(lambda p: p.clone().requires_grad_(),
                     {k: v for k, v in params.items() if k != "embed"})
    rows = embedding_ops.lookup(params["embed"]["table"], batch["tokens"])
    rows.requires_grad_()
    loss = transformer.lm_loss({**dense, "embed": params["embed"]}, cfg,
                               {**batch, "embed_rows": rows})
    grads = torch.autograd.grad(loss, tree_leaves(dense) + [rows])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want = jax.tree_util.tree_leaves(jgd) + [jgr]
    for g, w in zip(grads, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("relaxed", [True, False])
@pytest.mark.parametrize("arch", MOE_IDS)
def test_loss_curve_matches_jax(arch, relaxed):
    """Five steps from the same init and batches as
    ``repro.training.train_loop.train``; 1e-5 relative."""
    jcfg = jax_get_arch(arch, smoke=True).model
    jtc = JaxTrainConfig()
    jstate = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, jst.params_of(jstate)), CPU)
    _, jl = jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=0), 5,
                      relaxed=relaxed, state=jstate)
    _, tl = _port_run(arch, 5, relaxed, params=params, tc=TrainConfig())
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", MOE_IDS)
def test_strict_equals_relaxed_bitwise(arch):
    """The relaxed losses equal the strict ones bit for bit
    (tests/test_relaxed.py:28-33), the router term included."""
    _, s = _port_run(arch, 4, relaxed=False)
    _, r = _port_run(arch, 4, relaxed=True)
    assert np.isfinite(s).all() and len(s) == 4
    assert s == r, (s, r)


@pytest.mark.parametrize("arch", MOE_IDS)
def test_remat_gives_bitwise_equal_grads(arch):
    """Per-block checkpointing recomputes the routing as it first ran: the
    loss and every gradient equal those without remat bit for bit."""
    cfg = get_arch(arch, smoke=True).model
    jcfg = jax_get_arch(arch, smoke=True).model
    params = interop.params_from_numpy(
        jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg), CPU)
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
