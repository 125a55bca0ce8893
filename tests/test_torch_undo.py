"""The relaxed step's undo image (paper Fig. 7) against the JAX package and
against the pool's own, at the smoke size.

The port's relaxed step updates the table through the fused logged update,
so its feed carries ``old_rows``: the rows of the step's distinct touched
ids as they were before the update. The JAX reference's feed names the
same content under that key (``repro/training/train_loop.py:119-122``).
The pool captures its undo image from its mirror; the two must agree bit
for bit on every committed step. The ring's host-driven ``append`` (the
calibration rig's wire mode) writes the JAX package's slots.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint.manager import flatten_touched
from repro.core.checkpoint.undo_log import UndoRing as JUndoRing
from repro.core.checkpoint.undo_log import open_ring as jopen_ring
from repro.pool import DramPool as JDramPool
from repro.pool import PmemPool as JPmemPool
from repro.pool import PoolAllocator as JPoolAllocator
from repro.data.synthetic import make_batches as jax_make_batches
from repro.training import state as jst
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core import relaxed as rx
from repro_torch.core.checkpoint.manager import (CheckpointManager,
                                                 check_undo_images,
                                                 touched_rows, undo_image)
from repro_torch.core.checkpoint.undo_log import UndoRing, open_ring
from repro_torch.data.synthetic import make_batches
from repro_torch.pool import (DramPool, PmemPool, PoolAllocator,
                              TenantIsolationError)
from repro_torch.training import train_loop

ARCHS = ["dlrm-rm1", "tinyllama-1.1b"]
CPU = torch.device("cpu")
STEPS = 3


def _jax_tables_before_each_step(arch, tc):
    """The JAX trainer's initial params and its flat table before each of
    STEPS relaxed steps."""
    jcfg = jax_get_arch(arch, smoke=True).model
    init_fn, _, relaxed_step, warmup = jtl.make_step_fns(jcfg, tc)
    state = init_fn(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jst.params_of(state))
    data = jax_make_batches(jcfg, 4, 16, seed=0)
    state = jax.jit(warmup)(state, data.next(0))
    step = jax.jit(relaxed_step)
    leaf = "emb_tables" if jcfg.arch_type == "dlrm" else "table"
    tables = []
    for n in range(STEPS):
        t = np.asarray(state["embed"][leaf])
        tables.append(t.reshape(-1, t.shape[-1]))
        state, _ = step(state, data.next(n), data.next(n + 1))
    return jcfg, params, tables


@pytest.mark.parametrize("arch", ARCHS)
def test_old_rows_are_the_pre_update_rows(arch):
    """Each relaxed step's ``old_rows[:n]`` are the table's rows at the
    step's distinct touched ids (``np.unique`` of the batch's flat ids)
    before the step: bitwise against the port's own table, and against the
    JAX trainer's within the card-vs-CPU table tolerance (1e-5, as
    tests/test_torch_cuda.py holds the trained table); the pads are +0."""
    jcfg, params, jtables = _jax_tables_before_each_step(
        arch, JaxTrainConfig(embed_learning_rate=0.05))
    cfg = get_arch(arch, smoke=True).model
    init_fn, _, relaxed_step, warmup = train_loop.make_step_fns(
        cfg, TrainConfig(embed_learning_rate=0.05))
    data = make_batches(cfg, 4, 16, seed=0, device="cpu")
    state = warmup(init_fn(interop.params_from_numpy(params, CPU)), data.next(0))
    leaf = rx.embed_leaf(cfg)
    for n in range(STEPS):
        t = state["embed"][leaf]
        before = t.reshape(-1, t.shape[-1]).clone()
        batch = data.next(n)
        state, m = relaxed_step(state, batch, data.next(n + 1))
        feed = m["ckpt_feed"]
        ids, idx = touched_rows(feed)
        want_ids = np.unique(flatten_touched(
            jcfg, batch["sparse" if "sparse" in batch else "tokens"].numpy()))
        np.testing.assert_array_equal(idx, want_ids)
        old = feed["old_rows"]
        assert old.dtype == t.dtype and old.shape == feed["delta"].shape
        assert torch.equal(old[:idx.size].view(torch.int32),
                           before[ids.long()].view(torch.int32))
        assert not old[idx.size:].any() and not torch.signbit(old[idx.size:]).any()
        np.testing.assert_allclose(old[:idx.size].numpy(), jtables[n][idx],
                                   rtol=1e-5, atol=1e-5)
        assert not np.array_equal(before[ids.long()].numpy(),
                                  t.reshape(before.shape)[ids.long()].numpy())


@pytest.mark.parametrize("backend", ["dram", "pmem"])
@pytest.mark.parametrize("arch", ARCHS)
def test_pool_undo_image_equals_the_device_image(tmp_path, arch, backend):
    """The undo entry the pool captured from its mirror for every committed
    step equals, bitwise, the image the fused update captured from the
    tables; an image that differs in one bit is refused."""
    cfg = get_arch(arch, smoke=True).model
    cc = CheckpointConfig(directory=str(tmp_path / "ck"), dense_interval=0,
                          pool_backend=backend)
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    state = train_loop.init_state(cfg, tc, "cpu")
    mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
    images = {}
    try:
        train_loop.train(cfg, tc, make_batches(cfg, 4, 16, seed=3, device="cpu"),
                         4, relaxed=True, state=state, ckpt_manager=mgr,
                         device="cpu", on_metrics=lambda n, m: images.__setitem__(
                             n, undo_image(m["ckpt_feed"])))
        assert mgr.ring.committed_steps() == [0, 1, 2, 3]
        assert check_undo_images(mgr.ring, images) == 4
        idx, rows = images[2]
        bad = rows.copy()
        bad.view(np.uint32)[0, 0] ^= 1
        with pytest.raises(RuntimeError, match="step 2 differs"):
            check_undo_images(mgr.ring, {**images, 2: (idx, bad)})
        with pytest.raises(RuntimeError, match="step 0: no device image"):
            check_undo_images(mgr.ring, {k: v for k, v in images.items() if k})
    finally:
        mgr.close()


# -- the host-driven append -----------------------------------------------------

def _appends(rng, with_acc):
    """Three steps' images, the third large enough to grow the ring."""
    out = []
    for step, n in ((0, 5), (1, 3), (2, 300)):
        idx = np.sort(rng.choice(4000, n, replace=False)).astype(np.int64)
        rows = (rng.integers(-512, 512, (n, 16)) / 256.0).astype(np.float32)
        acc = rng.random((n, 16)).astype(np.float32) if with_acc else None
        out.append((step, idx, rows, acc))
    return out


@pytest.mark.parametrize("with_acc", [False, True], ids=["rows", "rows+acc"])
@pytest.mark.parametrize("compress", ["none", "zlib"])
def test_append_writes_the_jax_slots(compress, with_acc):
    """The port's ``UndoRing.append`` leaves the pool image bitwise equal to
    the JAX package's after the same appends (a ring grow among them), and
    each step reads back as it was written."""
    entries = _appends(np.random.default_rng(7), with_acc)
    pools = {}
    for name, (Dram, Alloc, Ring) in (
            ("port", (DramPool, PoolAllocator, UndoRing)),
            ("jax", (JDramPool, JPoolAllocator, JUndoRing))):
        pool = Dram(capacity=1 << 20)
        ring = Ring(Alloc(pool), max_logs=2, compress=compress)
        for step, idx, rows, acc in entries:
            ring.append(step, idx, rows, acc)
        assert ring.committed_steps() == [0, 1, 2]
        for step, idx, rows, acc in entries:
            got = ring.read(step)
            np.testing.assert_array_equal(got[0], idx)
            assert got[1].tobytes() == rows.tobytes()
            if with_acc:
                assert got[2].tobytes() == acc.tobytes()
        pools[name] = pool
    assert pools["port"].capacity == pools["jax"].capacity
    assert bytes(pools["port"].view(0, pools["port"].capacity)) == \
        bytes(pools["jax"].view(0, pools["jax"].capacity))


@pytest.mark.parametrize("compress", ["none", "zlib"])
def test_port_appended_ring_reads_in_jax(tmp_path, compress):
    """A ring the port's ``append`` wrote into a pmem file is read back by the
    JAX package's ``open_ring(...).read``, bitwise."""
    entries = _appends(np.random.default_rng(8), False)
    path = str(tmp_path / "pool.img")
    pool = PmemPool(path, capacity=1 << 20)
    ring = UndoRing(PoolAllocator(pool), max_logs=4, compress=compress)
    for step, idx, rows, acc in entries:
        ring.append(step, idx, rows, acc)
    pool.close()
    jpool = JPmemPool.open(path)
    jring = jopen_ring(jpool, max_logs=4)
    assert jring.committed_steps() == [0, 1, 2]
    for step, idx, rows, _ in entries:
        got = jring.read(step)
        np.testing.assert_array_equal(got[0], idx)
        assert got[1].tobytes() == rows.tobytes()
    jpool.close()


def test_readonly_ring_refuses_append():
    """A read-only ring refuses the host-driven append, as it refuses
    ``log_and_apply`` and ``gc``, and the ring is left as it was."""
    pool = DramPool(capacity=1 << 20)
    UndoRing(PoolAllocator(pool), max_logs=4).append(
        0, np.arange(3), np.ones((3, 8), np.float32))
    before = bytes(pool.view(0, pool.capacity))
    ro = open_ring(pool, max_logs=4, readonly=True)
    with pytest.raises(TenantIsolationError, match="append denied"):
        ro.append(1, np.arange(3), np.zeros((3, 8), np.float32))
    assert ro.committed_steps() == [0]
    assert bytes(pool.view(0, pool.capacity)) == before
