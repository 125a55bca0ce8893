"""The port's DLRM pieces against the JAX package, at the smoke size (fp32).

Inputs come from numpy with a seed; the port starts from the JAX package's
params through ``repro_torch.interop``, since torch cannot reproduce
``jax.random`` draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding_ops as jeo
from repro.data.synthetic import DLRMBatches as JaxBatches
from repro.models import dlrm as jdlrm
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import embedding_ops, relaxed as rx
from repro_torch.data.lookahead import LookaheadIterator
from repro_torch.data.synthetic import DLRMBatches
from repro_torch.models import dlrm
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")


def _cfgs(arch="dlrm-rm1"):
    return (jax_get_arch(arch, smoke=True).model, get_arch(arch, smoke=True).model)


@pytest.mark.parametrize("arch", ["dlrm-rm1", "dlrm-rm4"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_batches_bitwise(arch, seed, step):
    jcfg, cfg = _cfgs(arch)
    want = JaxBatches(jcfg, 8, seed=seed).next(step)
    got = DLRMBatches(cfg, 8, seed=seed, device="cpu").next(step)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k


def test_batches_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DLRMBatches(_cfgs()[1], 4)


@pytest.mark.parametrize("T,R,d,B,L", [(3, 50, 8, 4, 6), (20, 2048, 32, 4, 80)])
def test_bag_lookup_matches_jax(rng, T, R, d, B, L):
    tables = rng.standard_normal((T, R, d)).astype(np.float32)
    ids = rng.integers(0, R, (B, T, L)).astype(np.int32)
    want = jeo.bag_lookup(jnp.asarray(tables), jnp.asarray(ids))
    got = embedding_ops.bag_lookup(torch.from_numpy(tables), torch.from_numpy(ids))
    assert got.shape == (B, T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_params_and_batch(seed=0, batch=4):
    jcfg, cfg = _cfgs()
    params = jdlrm.init_dlrm(jax.random.PRNGKey(seed), jcfg)
    jb = JaxBatches(jcfg, batch, seed=seed).next(0)
    tb = DLRMBatches(cfg, batch, seed=seed, device="cpu").next(0)
    return jcfg, cfg, params, jb, tb


def test_dlrm_forward_loss_and_grads_match_jax():
    jcfg, cfg, jparams, jb, tb = _jax_params_and_batch()
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)

    jlogit = jdlrm.forward(jparams, jcfg, jb)
    np.testing.assert_allclose(dlrm.forward(params, cfg, tb).numpy(),
                               np.asarray(jlogit), rtol=2e-5, atol=2e-5)

    jloss, jgrads = jax.value_and_grad(jdlrm.bce_loss)(jparams, jcfg, jb)
    # the port's route: grad w.r.t. the bag vectors, then the sparse adjoint
    dense = {k: v for k, v in params.items() if k != "embed"}
    for p in tree_leaves(dense):
        p.requires_grad_()
    rows = rx.lookup_rows(params["embed"], cfg, tb).requires_grad_()
    loss = dlrm.bce_loss(params, cfg, {**tb, "embed_rows": rows})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5, atol=2e-5)
    loss.backward()
    jg = jax.tree.map(np.asarray, jgrads)
    for part in ("bottom", "top"):
        for got, want in zip(params[part], jg[part], strict=True):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k].grad.numpy(), want[k],
                                           rtol=2e-5, atol=2e-5)
    uniq, g = rx.sparse_rows_grad(params["embed"], cfg, tb, rows.grad)
    T, R, d = params["embed"]["emb_tables"].shape
    dense_g = np.zeros((T * R, d), np.float32)
    real = uniq.numpy() >= 0
    np.add.at(dense_g, uniq.numpy()[real], g.numpy()[real])
    np.testing.assert_allclose(dense_g, jg["embed"]["emb_tables"].reshape(T * R, d),
                               rtol=2e-5, atol=2e-5)


def test_interop_roundtrip_bf16():
    tree = {"a": [np.arange(6, dtype=np.float32).reshape(2, 3)],
            "b": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)}
    t = interop.params_from_numpy(jax.tree.map(np.asarray, tree), CPU)
    assert t["b"].dtype == torch.bfloat16
    assert np.array_equal(t["b"].float().numpy(),
                          np.asarray(tree["b"], np.float32))
    back = interop.params_to_numpy(t)
    assert np.array_equal(back["a"][0], tree["a"][0])
    assert back["b"].dtype == np.float32


def test_init_shapes_and_dtypes():
    cfg = get_arch("dlrm-rm1", smoke=True).model.replace(dtype="bfloat16")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p = dlrm.init_dlrm(gen, cfg)
    jshapes = jax.eval_shape(lambda k: jdlrm.init_dlrm(k, _cfgs()[0]),
                             jax.random.PRNGKey(0))
    got = [tuple(x.shape) for x in tree_leaves(p)]
    assert got == [tuple(x.shape) for x in jax.tree.leaves(jshapes)]
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(p))
    tables = p["embed"]["emb_tables"].float()
    assert abs(tables.std().item() - 32 ** -0.5) < 0.01


def test_optimizers_math():
    """Mirrors tests/test_attention_and_moe.py::test_optimizers_math."""
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    o = opt.sgd(0.1)
    upd, _ = o.update(g, o.init(p), p)
    np.testing.assert_allclose(upd["w"].numpy(), [-0.05, -0.05])

    o = opt.adamw(1e-2, 0.9, 0.999)
    st = o.init(p)
    upd, st = o.update(g, st, p)
    np.testing.assert_allclose(upd["w"].numpy(),
                               [-1e-2 * 0.5 / (0.5 + 1e-8)] * 2, rtol=1e-4)

    o = opt.rowwise_adagrad(0.1)
    t = {"t": torch.ones((4, 2))}
    gt = {"t": torch.ones((4, 2)) * 2.0}
    upd, _ = o.update(gt, o.init(t), t)
    np.testing.assert_allclose(upd["t"].numpy(), np.full((4, 2), -0.1), rtol=1e-5)


@pytest.mark.parametrize("name", ["sgd", "sgdm", "adamw", "rowwise_adagrad"])
def test_optimizers_match_jax_over_steps(rng, name):
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.optim import optimizers as jopt
    from repro_torch.configs.base import TrainConfig
    params = {"a": rng.standard_normal((6, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    jo = jopt.make_optimizer(name, 0.05, JaxTrainConfig(weight_decay=0.01))
    to = opt.make_optimizer(name, 0.05, TrainConfig(weight_decay=0.01))
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.params_from_numpy(params, CPU)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        grads = {"a": rng.standard_normal((6, 3)).astype(np.float32),
                 "b": [rng.standard_normal(4).astype(np.float32)]}
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tu, ts = to.update(interop.params_from_numpy(grads, CPU), ts, tp)
        for got, want in zip(tree_leaves(tu), jax.tree.leaves(ju), strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_global_norm_clip_matches_jax(rng):
    from repro.optim import optimizers as jopt
    grads = {"x": rng.standard_normal((5, 4)).astype(np.float32) * 3,
             "y": [rng.standard_normal(7).astype(np.float32)]}
    jc, jn = jopt.global_norm_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    tc, tn = opt.global_norm_clip(interop.params_from_numpy(grads, CPU), 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for got, want in zip(tree_leaves(tc), jax.tree.leaves(jc), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_lookahead_peek_indices():
    cfg = _cfgs()[1]
    it = LookaheadIterator(DLRMBatches(cfg, 4, device="cpu"), cfg, depth=3)
    assert torch.equal(it.peek_indices(1), it.peek(1)["sparse"])
    first = it.advance()
    assert torch.equal(first["sparse"], DLRMBatches(cfg, 4, device="cpu")
                       .next(0)["sparse"])
    assert torch.equal(it.next(3)["dense"], DLRMBatches(cfg, 4, device="cpu")
                       .next(3)["dense"])
