"""Row-wise Adagrad on the port's sparse tier against the JAX package, at
the smoke sizes (f32 on both sides).

The port updates only the rows a step touched (``Optimizer.update_rows``,
through the row kernels' plain versions here); the JAX package updates the
whole table with a table-sized gradient. Their accumulators have the same
shapes: (V, 1) for an LM's table, (T, 1, 1) for DLRM's stacked tables (one
per table, ``src/repro/optim/optimizers.py:78-88``). On DLRM the JAX
package takes the mean of g squared over the whole (R, d) table gradient,
zeros included, and the port sums the touched rows only: the two differ in
the f32 order of that sum. Each test states its tolerance.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import CheckpointConfig as JaxCheckpointConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint import recovery as jrecovery
from repro.core.checkpoint.manager import CheckpointManager as JaxManager
from repro.data.synthetic import make_batches as jax_make_batches
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core import relaxed as rx
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import make_batches
from repro_torch.optim import optimizers as opt
from repro_torch.training import train_loop

CPU = torch.device("cpu")
ARCHS = ["dlrm-rm1", "tinyllama-1.1b"]
LR = 0.05
ADAGRAD = "rowwise_adagrad"
# measured: the accumulators agree within 1.8e-6 relative, the losses
# within 1.2e-6 (DLRM) and 8.2e-8 (tinyllama) relative
ACC_RTOL = 1e-5
LOSS_TOL = {"dlrm-rm1": dict(rtol=1e-4, atol=1e-5),   # test_torch_train.py's
            "tinyllama-1.1b": dict(rtol=1e-5, atol=0)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized steps gain nothing from intra-op threads, and the other
    test workers compete for the cores. The previous count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(arch, steps, relaxed, lr=LR):
    """The JAX trainer from PRNGKey(0): (its init params as numpy, final
    state, losses)."""
    jcfg = jax_get_arch(arch, smoke=True).model
    jtc = JaxTrainConfig(embed_learning_rate=lr, embed_optimizer=ADAGRAD)
    jstate = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jst.params_of(jstate))
    final, losses = jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=0),
                              steps, relaxed=relaxed, state=jstate)
    return params, final, np.asarray(losses)


def _port_run(arch, steps, relaxed, params_np=None, lr=LR):
    cfg = get_arch(arch, smoke=True).model
    tc = TrainConfig(embed_learning_rate=lr, embed_optimizer=ADAGRAD)
    state = None if params_np is None else train_loop.make_step_fns(cfg, tc)[0](
        interop.params_from_numpy(params_np, CPU))
    final, losses = train_loop.train(cfg, tc, make_batches(cfg, 4, 16, seed=0,
                                                           device="cpu"),
                                     steps, relaxed=relaxed, state=state,
                                     device="cpu")
    return final, np.asarray(losses)


@pytest.mark.parametrize("relaxed", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_curves_and_accumulator_match_jax(arch, relaxed):
    """Five steps from the JAX package's init: the losses and the final
    accumulator tree, whose shape is the JAX package's ((T, 1, 1) for DLRM,
    (V, 1) for an LM)."""
    params, jfinal, jl = _jax_run(arch, 5, relaxed)
    final, tl = _port_run(arch, 5, relaxed, params_np=params)
    cfg = get_arch(arch, smoke=True).model
    leaf = rx.embed_leaf(cfg)
    assert list(final["opt_embed"]) == list(jfinal["opt_embed"]) == [leaf]
    want = np.asarray(jfinal["opt_embed"][leaf])
    got = final["opt_embed"][leaf].numpy()
    if arch == "dlrm-rm1":
        assert got.shape == (cfg.dlrm_num_tables, 1, 1)
    else:
        assert got.shape == (cfg.vocab_size, 1)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=ACC_RTOL, atol=0)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_relaxed_matches_strict(arch):
    """tests/test_relaxed.py:49-56 holds tinyllama's relaxed run against its
    strict one within 1e-6 (the port's are bitwise equal: both take the same
    touched-rows update, and the LM's correction commutes exactly); DLRM
    within the bag sum order's 2e-5, as for SGD."""
    strict_state, s = _port_run(arch, 4, relaxed=False)
    relaxed_state, r = _port_run(arch, 4, relaxed=True)
    assert np.isfinite(s).all() and len(s) == 4
    tol = 1e-6 if arch == "tinyllama-1.1b" else 2e-5
    np.testing.assert_allclose(s, r, rtol=tol, atol=tol)
    leaf = rx.embed_leaf(get_arch(arch, smoke=True).model)
    torch.testing.assert_close(strict_state["opt_embed"][leaf],
                               relaxed_state["opt_embed"][leaf],
                               rtol=tol, atol=0)


@pytest.mark.parametrize("shape", [(64, 8), (3, 50, 8)])
def test_touched_rows_form_equals_dense_update(rng, shape):
    """``update_rows`` at the touched rows against the port's dense
    ``update`` of the same gradient as a table: the updates of the touched
    rows within 1e-6, the accumulator within 1e-6 (the f32 order of the
    mean differs), the pads (-1) unwritten."""
    o = opt.rowwise_adagrad(0.1)
    table = torch.zeros(shape)
    flat_rows = int(np.prod(shape[:-1]))
    d = shape[-1]
    ids = np.unique(rng.integers(0, flat_rows, 20))
    n, pads = ids.size, 5
    uniq = torch.from_numpy(np.concatenate([ids, -np.ones(pads, np.int64)])
                            .astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((n + pads, d)).astype(np.float32))
    g[n:] = 0
    state = o.init({"t": table})
    state["t"] += torch.from_numpy(rng.random(state["t"].shape).astype(np.float32))
    dense_g = torch.zeros((flat_rows, d))
    dense_g[torch.from_numpy(ids)] = g[:n]
    want_upd, want_state = o.update({"t": dense_g.reshape(shape)},
                                    {"t": state["t"].clone()}, None)
    upd, got_state = o.update_rows(uniq, g, state, shape)
    assert got_state is state and state["t"].shape == want_state["t"].shape
    torch.testing.assert_close(state["t"], want_state["t"], rtol=1e-6, atol=0)
    torch.testing.assert_close(upd[:n], want_upd["t"].reshape(-1, d)[ids],
                               rtol=1e-6, atol=1e-7)
    assert not upd[n:].any()


def test_sgd_momentum_has_no_touched_rows_form():
    """sgdm's momentum moves rows the batch did not touch
    (src/repro/optim/optimizers.py:22-33)."""
    assert opt.make_optimizer("sgdm", 0.1).update_rows is None
    assert opt.make_optimizer("sgd", 0.1).update_rows is not None
    assert opt.make_optimizer(ADAGRAD, 0.1).update_rows is not None


# -- checkpoints with an Adagrad accumulator ---------------------------------------

def _jax_checkpoint(tmp, arch, steps):
    jcfg = jax_get_arch(arch, smoke=True).model
    cc = JaxCheckpointConfig(directory=tmp, dense_interval=1, pool_backend="pmem")
    jtc = JaxTrainConfig(embed_learning_rate=LR, embed_optimizer=ADAGRAD,
                         checkpoint=cc)
    st0 = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    mgr = JaxManager(jcfg, cc, embed_init=st0["embed"])
    jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=3), steps,
              relaxed=True, state=st0, ckpt_manager=mgr)
    mgr.close()


def _port_setup(tmp, arch):
    cfg = get_arch(arch, smoke=True).model
    cc = CheckpointConfig(directory=tmp, dense_interval=1, pool_backend="pmem")
    tc = TrainConfig(embed_learning_rate=LR, embed_optimizer=ADAGRAD,
                     checkpoint=cc)
    return cfg, tc, make_batches(cfg, 4, 16, seed=3, device="cpu")


def _port_checkpoint(tmp, arch, steps):
    cfg, tc, data = _port_setup(tmp, arch)
    state = train_loop.init_state(cfg, tc, "cpu")
    mgr = CheckpointManager(cfg, tc.checkpoint, embed_init=state["embed"])
    train_loop.train(cfg, tc, data, steps, relaxed=True, state=state,
                     ckpt_manager=mgr, device="cpu")
    mgr.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adagrad_checkpoint_recovers_in_the_other_package(tmp_path, writer):
    """A pmem checkpoint of smoke DLRM trained with Adagrad, written by one
    package, recovers in the other: the same mirror, and a tier-M blob whose
    accumulator (T, 1, 1) and dense tree are bitwise the writer's."""
    src = str(tmp_path / "ck")
    (_jax_checkpoint if writer == "jax" else _port_checkpoint)(src, "dlrm-rm1", 3)
    shutil.copytree(src, str(tmp_path / "ck2"))
    jrec = jrecovery.recover(src)
    prec = recovery.recover(str(tmp_path / "ck2"))
    try:
        assert (prec.mirror_step, prec.dense_step) \
            == (jrec.mirror_step, jrec.dense_step) == (2, 2)
        np.testing.assert_array_equal(prec.embed_rows, jrec.embed_rows)
        got = prec.dense["opt_embed"]["emb_tables"]
        want = np.asarray(jrec.dense["opt_embed"]["emb_tables"])
        assert got.shape == want.shape == (20, 1, 1) and (want > 0).all()
        np.testing.assert_array_equal(got.numpy(), want)
        for key in ("dense", "opt_dense"):
            for a, b in zip(jax.tree_util.tree_leaves(prec.dense[key]),
                            jax.tree_util.tree_leaves(jrec.dense[key]),
                            strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    finally:
        jrec.pool.close()
        prec.pool.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_continues_with_the_blobs_accumulator(tmp_path, arch):
    """Three checkpointed steps, recovery, then three more: the losses and
    the accumulator equal those of six uninterrupted steps (the dense blob
    of every step, so no relaxed gap). DLRM within the bag's 1e-5 (the
    resumed carry is looked up afresh), an LM exact."""
    tmp = str(tmp_path / "ck")
    _port_checkpoint(tmp, arch, 3)
    cfg, tc, data = _port_setup(tmp, arch)
    full, full_losses = train_loop.train(cfg, tc, data, 6, relaxed=True,
                                         device="cpu")
    rec = recovery.recover(tmp)
    assert (rec.mirror_step, rec.dense_step) == (2, 2)
    state, start = recovery.resume_train_state(
        rec, train_loop.init_state(cfg, tc, "cpu"))
    leaf = rx.embed_leaf(cfg)
    assert state["opt_embed"][leaf].shape == full["opt_embed"][leaf].shape
    mgr = CheckpointManager(cfg, tc.checkpoint, pool=rec.pool)
    mgr.init_mirror(state["embed"], step=rec.mirror_step)
    resumed, tail = train_loop.train(cfg, tc, data, 3, relaxed=True, state=state,
                                     start_step=start, ckpt_manager=mgr,
                                     device="cpu")
    mgr.close()
    tol = 1e-5 if arch == "dlrm-rm1" else 0
    np.testing.assert_allclose(tail, full_losses[3:], rtol=tol, atol=tol)
    torch.testing.assert_close(resumed["opt_embed"][leaf], full["opt_embed"][leaf],
                               rtol=tol, atol=0)
