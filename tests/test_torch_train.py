"""The port's DLRM training path against the JAX package, at the smoke size.

Both packages start from the JAX package's initial params (through numpy)
and read bit-identical batches from the same seed.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import make_batches
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import DLRMBatches
from repro_torch.training import train_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")


def _port_state(cfg, tc, params_np):
    init_fn = train_loop.make_step_fns(cfg, tc)[0]
    return init_fn(interop.params_from_numpy(params_np, CPU))


def _port_losses(tc, steps, relaxed, params_np=None, seed=0, batch=4):
    cfg = get_arch("dlrm-rm1", smoke=True).model
    data = DLRMBatches(cfg, batch, seed=seed, device="cpu")
    state = None if params_np is None else _port_state(cfg, tc, params_np)
    _, losses = train_loop.train(cfg, tc, data, steps, relaxed=relaxed,
                                 state=state, device="cpu")
    return np.asarray(losses)


def test_strict_relaxed_equivalence():
    """The paper's claim on the port: as tests/test_relaxed.py:36-39, bag
    models agree to float-sum tolerance (the reduce order differs)."""
    tc = TrainConfig(embed_learning_rate=0.05)
    s = _port_losses(tc, 5, relaxed=False)
    r = _port_losses(tc, 5, relaxed=True)
    assert np.isfinite(s).all() and len(s) == 5
    np.testing.assert_allclose(s, r, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("relaxed", [True, False])
def test_loss_curve_matches_jax(relaxed):
    """Five steps from the same init. rtol 1e-4: AdamW's first steps divide
    by sqrt(v), which amplifies float-order differences in tiny grads."""
    jtc = JaxTrainConfig(embed_learning_rate=0.05)
    jcfg = jax_get_arch("dlrm-rm1", smoke=True).model
    init_fn = jtl.make_step_fns(jcfg, jtc)[0]
    jstate = init_fn(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jst.params_of(jstate))
    _, jl = jtl.train(jcfg, jtc, make_batches(jcfg, 4, 16, seed=0), 5,
                      relaxed=relaxed, state=jstate)
    tl = _port_losses(TrainConfig(embed_learning_rate=0.05), 5, relaxed,
                      params_np=params_np)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4, atol=1e-5)


def test_relaxed_prefetch_matches_updated_tables():
    """After a relaxed step the carried bags equal a fresh lookup of the
    updated tables (to the f32 sum order), and the scratch is zero again."""
    from repro_torch.core import relaxed as rx
    cfg = get_arch("dlrm-rm1", smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.5)
    data = DLRMBatches(cfg, 4, seed=1, device="cpu")
    state, _ = train_loop.train(cfg, tc, data, 2, relaxed=True, device="cpu")
    fresh = rx.lookup_rows(state["embed"], cfg, data.next(2))
    torch.testing.assert_close(state["prefetch"]["rows"], fresh,
                               rtol=1e-5, atol=1e-5)
    assert not state["prefetch"]["scratch"].any()


def test_sparse_update_only_supports_sgd():
    """The sparse tier takes the rules with a touched-rows form, sgd and
    rowwise_adagrad (tests/test_torch_adagrad.py); sgdm has none (its
    momentum moves untouched rows) and raises."""
    cfg = get_arch("dlrm-rm1", smoke=True).model
    train_loop.make_step_fns(cfg, TrainConfig(embed_optimizer="rowwise_adagrad"))
    with pytest.raises(NotImplementedError, match="'sgdm' has no touched-rows"):
        train_loop.make_step_fns(cfg, TrainConfig(embed_optimizer="sgdm"))


def _run(code_or_args, module=False):
    env = {**os.environ, "PYTHONPATH": SRC}
    cmd = [sys.executable] + (["-m"] + code_or_args if module
                              else ["-c", code_or_args])
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_no_jax_and_no_reference():
    r = _run("import sys, repro_torch.launch.train, repro_torch.interop\n"
             "import repro_torch.launch.serve, repro_torch.models.rwkv6\n"
             "import repro_torch.models.moe, repro_torch.models.mamba\n"
             "import repro_torch.models.whisper, repro_torch.launch.trace_step\n"
             "import repro_torch.core.checkpoint.manager\n"
             "import repro_torch.core.checkpoint.recovery\n"
             "import repro_torch.serve, repro_torch.examples.serve_batched\n"
             "import repro_torch.pool.server, repro_torch.pool.remote\n"
             "import repro_torch.pool.protocol\n"
             "import repro_torch.distributed.sharding\n"
             "import repro_torch.distributed.context_parallel\n"
             "import repro_torch.distributed.tensor_parallel\n"
             "import repro_torch.distributed.checkpoint\n"
             "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
             "import repro_torch.sim.engine, repro_torch.sim.energy\n"
             "import repro_torch.sim.models_rm, repro_torch.sim.calibration\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'ml_dtypes', 'repro')]\n"
             "print(bad); sys.exit(1 if bad else 0)")
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("relaxed", [True, False])
def test_lookahead_makes_one_batch_per_step(relaxed):
    """The loop slides the lookahead window: each step makes one new batch
    (relaxed steps also hold the next), and the losses are those of the
    plain batch source."""
    from repro_torch.data.lookahead import LookaheadIterator

    class Counting(DLRMBatches):
        calls = 0

        def next(self, step):
            self.calls += 1
            return super().next(step)

    cfg = get_arch("dlrm-rm1", smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05)
    data = Counting(cfg, 2, seed=0, device="cpu")
    _, got = train_loop.train(cfg, tc, LookaheadIterator(data, cfg, depth=2),
                              6, relaxed=relaxed, device="cpu")
    assert data.calls == 6 + relaxed
    _, want = train_loop.train(cfg, tc, DLRMBatches(cfg, 2, seed=0, device="cpu"),
                               6, relaxed=relaxed, device="cpu")
    assert got == want


def test_cli_runs_on_cpu():
    r = _run(["repro_torch.launch.train", "--device", "cpu", "--steps", "3"],
             module=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done on cpu: 3 steps" in r.stdout


def test_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(["repro_torch.launch.train", "--steps", "1"], module=True)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
