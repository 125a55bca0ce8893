"""The port's LM training path against the JAX package, at the smoke size (f32).

Inputs come from numpy with a seed, and the port starts from the JAX
package's params through ``repro_torch.interop``; both read bit-identical
token batches. On the CPU the flash-attention wrappers run their plain
versions (forward and backward); the CUDA kernels are held against those in
``test_torch_cuda.py``. Each test states its tolerance.
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
from repro.core import relaxed as jrx
from repro.data.synthetic import make_batches as jax_make_batches
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import get_api as jax_get_api
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import LM_IDS, get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.core import embedding_ops
from repro_torch.core import relaxed as rx
from repro_torch.data.synthetic import make_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, transformer
from repro_torch.training import train_loop
from repro_torch.tree import tree_leaves, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
# the dense transformer ids; the MoE ones train in test_torch_moe.py
DENSE_IDS = [a for a in LM_IDS if get_arch(a).model.arch_type == "transformer"
             and not get_arch(a).model.moe.enabled]

# (B, Sq, Sk, Hq, Hkv, D, q_offset): ragged S, GQA, D 16 and 128, and queries
# at positions 7..11 over 12 keys (a prefill into a cache holding 7)
ATTN_CASES = [(2, 17, 17, 4, 2, 16, 0), (1, 33, 33, 6, 2, 128, 0),
              (2, 64, 64, 8, 1, 16, 0), (2, 5, 12, 4, 2, 16, 7)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(rng, B, Sq, Sk, Hq, Hkv, D):
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sq, Hq, D)).astype(np.float32))


def _plain_bwd(q, k, v, do, causal, q_offset):
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                     return_lse=True)
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       q_offset=q_offset)


# -- the plain backward --------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,off", ATTN_CASES)
def test_flash_bwd_ref_matches_jax_vjp(rng, B, Sq, Sk, Hq, Hkv, D, off, causal):
    """The written-out backward against ``jax.vjp`` of the reference's
    ``chunked_attention`` (query chunks of 16, so ragged S pads a chunk).
    2e-5, as the forward's parity test: other summation orders in f32."""
    q, k, v, do = _qkv(rng, B, Sq, Sk, Hq, Hkv, D)

    def attn(q, k, v):
        return jlayers.chunked_attention(
            q, k, v, causal=causal, q_chunk=16,
            positions_q=off + jnp.arange(Sq), positions_k=jnp.arange(Sk))
    _, vjp = jax.vjp(attn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _plain_bwd(_t(q), _t(k), _t(v), _t(do), causal, off)
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,off", ATTN_CASES)
def test_flash_bwd_ref_matches_torch_autograd(rng, B, Sq, Sk, Hq, Hkv, D, off,
                                              causal):
    """The written-out backward against torch autograd through
    ``ref.flash_attention_ref``. 2e-5: the same f32 math, other orders."""
    q, k, v, do = (_t(a) for a in _qkv(rng, B, Sq, Sk, Hq, Hkv, D))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal, q_offset=off)
    want = torch.autograd.grad(o, leaves, do)
    got = _plain_bwd(q, k, v, do, causal, off)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_flash_lse_is_the_rows_logsumexp(rng):
    """The forward's log-sum-exp is that of the scaled, masked scores."""
    q, k, v, _ = (_t(a) for a in _qkv(rng, 2, 9, 9, 4, 2, 16))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    assert lse.shape == (2, 4, 9) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, dim=2)) / 4.0
    s = s.masked_fill(torch.ones(9, 9, dtype=torch.bool).triu(1), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    assert torch.equal(o, ref.flash_attention_ref(q, k, v))


def test_flash_function_on_cpu_runs_the_plain_versions(rng):
    """With grad on, ``ops.flash_attention`` goes through ``FlashAttention``;
    on the CPU its forward is the plain forward and its gradients are the
    plain backward's, bitwise. Under no_grad nothing changes. No kernel
    launches on the CPU."""
    q, k, v, do = (_t(a) for a in _qkv(rng, 2, 17, 17, 4, 2, 16))
    before = (fa.launches, fa.bwd_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=True)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(o.detach(), ref.flash_attention_ref(q, k, v))
    got = torch.autograd.grad(o, leaves, do)
    for g, w in zip(got, _plain_bwd(q, k, v, do, True, 0), strict=True):
        assert torch.equal(g, w)
    with torch.no_grad():
        o2 = ops.flash_attention(*leaves, causal=True)
    assert o2.grad_fn is None and torch.equal(o2, o.detach())
    assert (fa.launches, fa.bwd_launches) == before


# -- the loss ------------------------------------------------------------------

def test_chunked_softmax_xent_grad_matches_jax(rng):
    """Loss, weight and the gradients w.r.t. hidden and the head against
    ``jax.grad`` of the reference's (chunks of 8 over S = 37, a ragged last
    chunk, and a mask). 1e-5: f32 logits and log-sum-exp in both."""
    h = rng.standard_normal((2, 37, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    y = rng.integers(0, 50, (2, 37)).astype(np.int32)
    m = (rng.random((2, 37)) < 0.8).astype(np.float32)

    def jloss(h, w):
        s, c = jlayers.chunked_softmax_xent(h, w, jnp.asarray(y), chunk=8,
                                            mask=jnp.asarray(m))
        return s / c, (s, c)
    (_, (js, jc)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    s, c = layers.chunked_softmax_xent(th, tw, _t(y), chunk=8, mask=_t(m))
    tg = torch.autograd.grad(s / c, (th, tw))
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-6)
    assert c.item() == float(jc)
    for g, want in zip(tg, jg, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _jax_lm(arch):
    jcfg = jax_get_arch(arch, smoke=True).model
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, interop.params_from_numpy(jparams, CPU)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_step_loss_and_grads_match_jax(arch):
    """One step's loss and its gradients, w.r.t. every dense leaf and the
    looked-up token rows, against ``jax.value_and_grad(lm_loss)``. 1e-5
    relative to each leaf's largest gradient (f32 on both sides)."""
    jcfg, jparams, params = _jax_lm(arch)
    cfg = get_arch(arch, smoke=True).model
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
    assert len(grads) == len(want)
    for g, w in zip(grads, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# -- training ---------------------------------------------------------------------

def _port_run(arch, steps, relaxed, params=None, lr=0.05, tc=None):
    cfg = get_arch(arch, smoke=True).model
    tc = tc or TrainConfig(embed_learning_rate=lr)
    state = None if params is None else \
        train_loop.make_step_fns(cfg, tc)[0](tree_map(torch.clone, params))
    return train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"),
                            steps, relaxed=relaxed, state=state, device="cpu")


@pytest.mark.parametrize("relaxed", [True, False])
@pytest.mark.parametrize("arch", DENSE_IDS)
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


@pytest.mark.parametrize("lr", [0.05, 0.5])
@pytest.mark.parametrize("arch", DENSE_IDS)
def test_strict_equals_relaxed_bitwise(arch, lr):
    """The paper's claim for row-gather models, as tests/test_relaxed.py:28-33
    holds it: the relaxed losses equal the strict ones bit for bit."""
    _, s = _port_run(arch, 4, relaxed=False, lr=lr)
    _, r = _port_run(arch, 4, relaxed=True, lr=lr)
    assert np.isfinite(s).all() and len(s) == 4
    assert s == r, (s, r)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_relaxed_prefetch_is_the_updated_lookup(arch):
    """After relaxed steps the carried rows are bitwise a fresh lookup of
    the updated table, and the correction's scratch is zero again."""
    cfg = get_arch(arch, smoke=True).model
    state, _ = _port_run(arch, 2, relaxed=True, lr=0.5)
    nxt = make_batches(cfg, 4, 16, device="cpu").next(2)
    assert torch.equal(state["prefetch"]["rows"],
                       rx.lookup_rows(state["embed"], cfg, nxt))
    assert not state["prefetch"]["scratch"].any()


def test_sparse_rows_grad_is_the_dense_adjoint(rng):
    """The port's (uniq, rows) gradient is the JAX package's dense
    ``scatter_rows_grad`` at the touched rows, and zero elsewhere. 1e-6:
    duplicate tokens summed in f32 in item order on both sides."""
    cfg = get_arch("tinyllama-1.1b", smoke=True).model
    jcfg = jax_get_arch("tinyllama-1.1b", smoke=True).model
    tokens = make_batches(cfg, 4, 16, device="cpu").next(0)["tokens"]
    g = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    table = torch.zeros((cfg.vocab_size, cfg.d_model))
    uniq, rows = rx.sparse_rows_grad({"table": table}, cfg, {"tokens": tokens},
                                     _t(g))
    dense = np.asarray(jrx.scatter_rows_grad(
        {"table": jnp.zeros((cfg.vocab_size, cfg.d_model))}, jcfg,
        {"tokens": jnp.asarray(tokens.numpy())}, jnp.asarray(g))["table"])
    n = int((uniq >= 0).sum())
    ids = uniq[:n].long().numpy()
    np.testing.assert_array_equal(ids, np.unique(tokens.numpy()))
    np.testing.assert_allclose(rows[:n].numpy(), dense[ids], rtol=1e-6, atol=1e-6)
    assert not rows[n:].any()
    rest = np.ones(cfg.vocab_size, bool)
    rest[ids] = False
    assert not dense[rest].any()


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_remat_gives_bitwise_equal_grads(arch, monkeypatch):
    """Per-block activation checkpointing changes what is kept, not what is
    computed: the gradients equal those without remat bit for bit. With
    remat each layer's attention forward runs twice (the recompute)."""
    cfg = get_arch(arch, smoke=True).model
    _, _, params = _jax_lm(arch)
    batch = make_batches(cfg, 2, 16, device="cpu").next(0)
    calls = []
    plain = ref.flash_attention_ref
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    grads = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss = transformer.lm_loss(tree_map(lambda _: next(it), params), c, batch)
        n0 = len(calls)
        grads[remat] = (loss, torch.autograd.grad(loss, leaves))
        calls.append(("backward recomputes", len(calls) - n0))
    assert torch.equal(grads[True][0], grads[False][0])
    for a, b in zip(grads[True][1], grads[False][1], strict=True):
        assert torch.equal(a, b)
    # forward: L calls each; backward: none without remat, L with it
    L = cfg.num_layers
    assert calls.count(1) == 3 * L
    assert ("backward recomputes", 0) in calls and ("backward recomputes", L) in calls


# -- entry points and what is not ported --------------------------------------------

def _cli(*args):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_trains_tinyllama_on_cpu():
    r = _cli("--arch", "tinyllama-1.1b", "--device", "cpu", "--steps", "3",
             "--seq", "16")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done on cpu: 3 steps" in r.stdout


def test_cli_tinyllama_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _cli("--arch", "tinyllama-1.1b", "--steps", "1", "--seq", "16")
    assert r.returncode != 0 and "no CUDA card" in r.stderr


def test_tied_head_training_raises(tmp_path):
    """A head tied to the table trains now (whisper's; its every row moves
    each step), but checkpointed training of it raises: tier-E logs the
    touched rows only, so the mirror would go stale (the reference's does,
    tests/test_torch_whisper.py). Uncheckpointed, tied tinyllama's relaxed
    losses equal the strict ones bit for bit."""
    cfg = get_arch("tinyllama-1.1b", smoke=True).model.replace(tie_embeddings=True)
    tc = TrainConfig(embed_learning_rate=0.05)
    with pytest.raises(NotImplementedError, match="tied"):
        train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"), 1,
                         device="cpu", checkpoint_dir=str(tmp_path / "ck"))
    runs = [train_loop.train(cfg, tc, make_batches(cfg, 4, 16, device="cpu"), 3,
                             relaxed=relaxed, device="cpu") for relaxed in (False, True)]
    (s_state, s), (r_state, r) = runs
    assert s == r and np.isfinite(s).all()
    assert torch.equal(s_state["embed"]["table"], r_state["embed"]["table"])
