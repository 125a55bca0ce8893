"""The port's checkpoint stack against the JAX package, at the smoke size.

Byte formats (tree blobs, undo slots, compressed frames) are compared with
the JAX package's for the same inputs; the crash drills of
``tests/test_checkpoint.py`` run through the port's trainer on dlrm-rm1 and
tinyllama-1.1b smoke (the reference drills tinyllama), over the dram and
pmem pools; and a checkpoint written by either package is recovered by the
other. Mirrors are compared bitwise.
"""
import os
import shutil
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import CheckpointConfig as JaxCheckpointConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint import recovery as jrecovery
from repro.core.checkpoint import store as jstore
from repro.core.checkpoint.manager import CheckpointManager as JaxManager
from repro.core.checkpoint.manager import flatten_touched
from repro.data.synthetic import make_batches
from repro.pool import FaultSchedule as JaxFaultSchedule
from repro.pool import InjectedCrash as JaxInjectedCrash
from repro.pool import compress as jcompress
from repro.pool import undo_codec as juc
from repro.training import train_loop as jtl
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery, store
from repro_torch.core.checkpoint.manager import CheckpointManager, touched_rows
from repro_torch.data.synthetic import make_batches as port_make_batches
from repro_torch.pool import FaultSchedule, InjectedCrash, PoolError, make_pool
from repro_torch.pool import compress, undo_codec
from repro_torch.training import train_loop

BACKENDS = ["dram", "pmem"]
ARCHS = ["dlrm-rm1", "tinyllama-1.1b"]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# resumed losses against the uninterrupted run: tests/test_checkpoint.py's
# tolerance. The resumed run rebuilds the relaxed carry by a fresh bag
# lookup where the uninterrupted one carried stale bags plus a correction,
# so the f32 sums differ in order. (With bf16 tables the carry is also
# rounded differently, and the gap is far wider: chip_smoke.py phase 6.)
# An LM's rebuilt carry is bitwise the carried one.
RESUME_TOL = 1e-6


# -- byte formats -------------------------------------------------------------

def _bf16_bits(rng, shape):
    return rng.integers(0, 1 << 16, shape, dtype=np.uint32).astype(np.uint16) \
        & np.uint16(0xBF7F)     # keep every exponent finite


def test_tree_blob_bytes_match_jax(rng):
    """Same tree, same bytes: a bf16 leaf (ml_dtypes on the JAX side, a
    torch bf16 tensor on the port's), f32, an int32 scalar, a list and an
    empty tuple. Exact."""
    bits = _bf16_bits(rng, (3, 5))
    w = rng.standard_normal((4, 3)).astype(np.float32)
    jtree = {"dense": {"w": bits.view(ml_dtypes.bfloat16), "b": [w]},
             "opt": {"t": np.asarray(7, np.int32)}, "emb": ()}
    ptree = {"dense": {"w": torch.from_numpy(bits.view(np.int16))
                       .view(torch.bfloat16), "b": [torch.from_numpy(w)]},
             "opt": {"t": torch.tensor(7, dtype=torch.int32)}, "emb": ()}
    blob = store.serialize_tree(ptree, {"step": 4})
    assert blob == jstore.serialize_tree(jtree, {"step": 4})
    back, extra = store.deserialize_tree(blob)
    assert extra == {"step": 4} and back["emb"] == ()
    assert back["dense"]["w"].dtype == torch.bfloat16
    assert np.array_equal(back["dense"]["w"].view(torch.int16).numpy()
                          .view(np.uint16), bits)
    assert torch.equal(back["dense"]["b"][0], torch.from_numpy(w))
    assert back["opt"]["t"].dtype == torch.int32 and int(back["opt"]["t"]) == 7
    jback, _ = jstore.deserialize_tree(blob)    # the JAX package reads it
    assert jback["dense"]["w"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(jback["dense"]["w"].view(np.uint16), bits)


@pytest.mark.parametrize("mode", ["none", "zlib", "int8"])
def test_undo_slot_and_frame_bytes_match_jax(rng, mode):
    """``pack_slot`` and ``frame`` give the JAX package's bytes. Exact."""
    idx = np.sort(rng.choice(5000, 300, replace=False)).astype(np.int64)
    # bf16 values widened to f32, as the mirror holds them (compressible)
    rows = _bf16_bits(rng, (300, 32)).view(ml_dtypes.bfloat16).astype(np.float32)
    got = undo_codec.pack_slot(9, idx, rows, None, mode=mode, slot_bytes=1 << 20)
    assert got == juc.pack_slot(9, idx, rows, None, mode=mode,
                                slot_bytes=1 << 20)
    blob = rows.tobytes()
    assert compress.frame(blob, mode) == jcompress.frame(blob, mode)
    assert compress.unframe(compress.frame(blob, mode)) == blob


# -- crash drills through the port's trainer ------------------------------------

def setup_run(tmp, dense_interval=1, backend="pmem", compress_mode="zlib",
              arch="dlrm-rm1", **kw):
    cc = CheckpointConfig(directory=tmp, dense_interval=dense_interval,
                          pool_backend=backend, pool_compress=compress_mode,
                          **kw)
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    cfg = get_arch(arch, smoke=True).model
    return cfg, tc, cc, port_make_batches(cfg, 4, 16, seed=3, device="cpu")


def fresh(cfg, tc):
    return train_loop.init_state(cfg, tc, "cpu")


def train(cfg, tc, data, steps, **kw):
    return train_loop.train(cfg, tc, data, steps, relaxed=True, device="cpu",
                            **kw)


def run_with_manager(cfg, tc, cc, data, steps, faults=None):
    st0 = fresh(cfg, tc)
    mgr = CheckpointManager(cfg, cc, embed_init=st0["embed"], faults=faults)
    train(cfg, tc, data, steps, state=st0, ckpt_manager=mgr)
    return mgr


def mirror_after(cfg, tc, tmp, backend, steps):
    """Mirror rows of a clean run stopped after `steps` steps."""
    _, _, cc, data = setup_run(tmp, backend=backend, arch=cfg.name)
    mgr = run_with_manager(cfg, tc, cc, data, steps)
    rows = np.array(mgr.mirror_rows)
    mgr.pool.close()
    return rows


def crash_run(cfg, tc, cc, data, faults, steps=6):
    st0 = fresh(cfg, tc)
    mgr = CheckpointManager(cfg, cc, embed_init=st0["embed"], faults=faults)
    with pytest.raises(InjectedCrash):
        train(cfg, tc, data, steps, state=st0, ckpt_manager=mgr)
    return mgr


def recover_after_crash(mgr, tmp, backend):
    if backend == "dram":
        mgr.pool.crash()                   # power loss: cache dropped
        return recovery.recover(tmp, pool=mgr.pool)
    mgr.pool.close()                       # process death: reopen from disk
    return recovery.recover(tmp)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_exact(tmp_path, arch):
    tmp = str(tmp_path / "ck")
    cfg, tc, _, data = setup_run(tmp, arch=arch)
    _, full = train(cfg, tc, data, 8)
    # the loop builds (and closes) its own manager from the directory
    train(cfg, tc, data, 5, checkpoint_dir=tmp, pool_backend="pmem")
    rec = recovery.recover(tmp)
    assert rec.mirror_step == 4 and rec.dense_step == 4 and rec.gap == 0
    st, resume = recovery.resume_train_state(rec, fresh(cfg, tc))
    _, tail = train(cfg, tc, data, 3, state=st, start_step=resume)
    np.testing.assert_allclose(tail, full[5:], rtol=RESUME_TOL, atol=RESUME_TOL)
    rec.pool.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_between_commit_and_apply(tmp_path, backend, arch):
    """Power loss after step 3's undo COMMIT persisted, before its mirror
    apply: recovery rolls back to a bit-identical step-2 mirror, and
    resuming reproduces the uninterrupted run."""
    tmp = str(tmp_path / "ck")
    cfg, tc, cc, data = setup_run(tmp, backend=backend, arch=arch)
    _, full = train(cfg, tc, data, 6)
    ref_rows = mirror_after(cfg, tc, str(tmp_path / "ref"), backend, 3)
    mgr = crash_run(cfg, tc, cc, data, FaultSchedule.crash_at(
        "tier_e.between-commit-and-apply", occurrence=4))
    rec = recover_after_crash(mgr, tmp, backend)
    assert rec.mirror_step == 2 and rec.rolled_back
    np.testing.assert_array_equal(rec.embed_rows, ref_rows)   # bit-identical
    st, resume = recovery.resume_train_state(rec, fresh(cfg, tc))
    assert resume == 3
    _, tail = train(cfg, tc, data, 3, state=st, start_step=resume)
    np.testing.assert_allclose(tail, full[3:], rtol=RESUME_TOL, atol=RESUME_TOL)
    rec.pool.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_mirror_apply_rolls_back(tmp_path, backend, arch):
    """A torn persist mid-apply leaves garbage in some mirror rows; the
    COMMITted undo entry restores them bit-exactly."""
    tmp = str(tmp_path / "ck")
    cfg, tc, cc, data = setup_run(tmp, backend=backend, arch=arch)
    ref_rows = mirror_after(cfg, tc, str(tmp_path / "ref"), backend, 2)
    mgr = crash_run(cfg, tc, cc, data,
                    FaultSchedule.torn_at("mirror-apply", occurrence=3))
    mgr.pool.crash()
    rec = recovery.recover(tmp, pool=mgr.pool)
    assert rec.rolled_back and rec.mirror_step == 1
    np.testing.assert_array_equal(rec.embed_rows, ref_rows)
    mgr.pool.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_recovery_bit_identical_across_compression_modes(tmp_path, backend,
                                                         arch):
    """The same drill recovers the same bytes whether pool-side compression
    is on or off."""
    rows, dense_steps = {}, {}
    for comp in ("none", "zlib"):
        tmp = str(tmp_path / f"ck-{comp}")
        cfg, tc, cc, data = setup_run(tmp, backend=backend, compress_mode=comp,
                                      arch=arch)
        mgr = crash_run(cfg, tc, cc, data, FaultSchedule.crash_at(
            "tier_e.between-commit-and-apply", occurrence=4))
        if comp == "zlib":       # the compressed run really compressed
            assert 0 < mgr.stats["undo_stored_bytes"] \
                < mgr.stats["undo_raw_bytes"]
        rec = recover_after_crash(mgr, tmp, backend)
        rows[comp], dense_steps[comp] = np.array(rec.embed_rows), rec.dense_step
        assert rec.mirror_step == 2
        rec.pool.close()
    np.testing.assert_array_equal(rows["none"], rows["zlib"])
    assert dense_steps["none"] == dense_steps["zlib"]


@pytest.mark.parametrize("arch", ARCHS)
def test_relaxed_gap_semantics(tmp_path, arch):
    """dense_interval=3: the dense tier trails the embedding tier; recovery
    reports the gap and resumes after the mirror's step."""
    tmp = str(tmp_path / "ck")
    cfg, tc, cc, data = setup_run(tmp, dense_interval=3, arch=arch)
    run_with_manager(cfg, tc, cc, data, 5).pool.close()
    rec = recovery.recover(tmp)
    assert (rec.mirror_step, rec.dense_step, rec.gap) == (4, 3, 1)
    _, resume = recovery.resume_train_state(rec, fresh(cfg, tc))
    assert resume == 5
    rec.pool.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_undo_log_gc(tmp_path, arch):
    cfg, tc, cc, data = setup_run(str(tmp_path / "ck"), dense_interval=0,
                                  max_undo_logs=3, arch=arch)
    mgr = run_with_manager(cfg, tc, cc, data, 8)
    steps = mgr.ring.committed_steps()
    assert len(steps) <= 4 and max(steps) == 7
    mgr.pool.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_writer_deadline_skips_tier_m(tmp_path, arch):
    tmp = str(tmp_path / "ck")
    cfg, tc, cc, data = setup_run(tmp, writer_deadline_s=1e-9, arch=arch)
    mgr = run_with_manager(cfg, tc, cc, data, 3)
    # tier-M never blocks; with an impossible deadline every snapshot is
    # skipped, and tier-E stays consistent
    assert mgr.stats["tier_m_skipped"] >= 1
    rec = recovery.recover(tmp, pool=mgr.pool)
    assert rec.mirror_step == 2
    mgr.pool.close()


# -- the feed and the two packages' checkpoints ----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_feed_ids_are_jax_flatten_touched(arch):
    """The ids the port logs for a relaxed step are the JAX manager's
    ``flatten_touched`` of the batch: same values, int64 (for an LM the JAX
    ids are the tokens' int32, which the undo codec widens to int64)."""
    cfg = get_arch(arch, smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05)
    _, _, relaxed_step, warmup = train_loop.make_step_fns(cfg, tc)
    data = port_make_batches(cfg, 8, 16, seed=1, device="cpu")
    state = warmup(fresh(cfg, tc), data.next(0))
    _, m = relaxed_step(state, data.next(0), data.next(1))
    ids, idx = touched_rows(m["ckpt_feed"])
    batch = data.next(0)
    want = flatten_touched(jax_get_arch(arch, smoke=True).model,
                           batch["sparse" if "sparse" in batch else "tokens"].numpy())
    assert idx.dtype == np.int64
    assert want.dtype == (np.int64 if arch == "dlrm-rm1" else np.int32)
    np.testing.assert_array_equal(idx, want)
    assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), want)


def _crashed_jax_checkpoint(tmp, arch):
    """JAX: 4 relaxed steps, crash between COMMIT and apply of step 2."""
    jcfg = jax_get_arch(arch, smoke=True).model
    cc = JaxCheckpointConfig(directory=tmp, dense_interval=1,
                             pool_backend="pmem")
    jtc = JaxTrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    st0 = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    mgr = JaxManager(jcfg, cc, embed_init=st0["embed"],
                     faults=JaxFaultSchedule.crash_at(
                         "tier_e.between-commit-and-apply", occurrence=3))
    with pytest.raises(JaxInjectedCrash):
        jtl.train(jcfg, jtc, make_batches(jcfg, 4, 16, seed=3), 4,
                  relaxed=True, state=st0, ckpt_manager=mgr)
    mgr.pool.close()


def _crashed_port_checkpoint(tmp, arch):
    cfg, tc, cc, data = setup_run(tmp, arch=arch)
    crash_run(cfg, tc, cc, data, FaultSchedule.crash_at(
        "tier_e.between-commit-and-apply", occurrence=3), steps=4).pool.close()


def _leaves(tree, prefix=""):
    """{path: numpy array} of a recovered dense tree (f32 view of bf16)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _leaves(x, f"{prefix}#{i}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.float() if tree.dtype == torch.bfloat16 else tree
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_recovers_in_the_other_package(tmp_path, writer, arch):
    """A pmem checkpoint written by one package (with a rollback pending)
    recovers in the other to the same mirror, dense tree and steps as in
    the package that wrote it. Exact."""
    src = str(tmp_path / "ck")
    (_crashed_jax_checkpoint if writer == "jax" else _crashed_port_checkpoint)(
        src, arch)
    shutil.copytree(src, str(tmp_path / "ck2"))  # recovery writes its rollback
    jrec = jrecovery.recover(src)
    prec = recovery.recover(str(tmp_path / "ck2"))
    try:
        assert (prec.mirror_step, prec.dense_step, prec.gap, prec.rolled_back) \
            == (jrec.mirror_step, jrec.dense_step, jrec.gap, jrec.rolled_back) \
            == (1, 1, 0, True)
        assert prec.table_name == jrec.table_name == (
            "emb_tables" if arch == "dlrm-rm1" else "table")
        assert prec.table_shape == tuple(jrec.table_shape)
        np.testing.assert_array_equal(prec.embed_rows, jrec.embed_rows)
        got, want = _leaves(prec.dense), _leaves(jrec.dense)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        jrec.pool.close()
        prec.pool.close()


# -- what is not ported, or not given, raises --------------------------------------

@pytest.mark.parametrize("backend", ["remote", "sharded"])
def test_unported_backends_raise(tmp_path, backend):
    """remote without a node's address, and sharded without the nodes'
    addresses, raise the JAX package's errors, before the manager starts
    anything."""
    msg = {"remote": "needs a server addr", "sharded": "needs shard addrs"}[backend]
    with pytest.raises(PoolError, match=msg):
        make_pool(backend, path=str(tmp_path / "p.img"))
    cfg, _, cc, _ = setup_run(str(tmp_path / "ck"), backend=backend)
    with pytest.raises(PoolError, match=msg):
        CheckpointManager(cfg, cc)


def test_pool_checker_request_raises(tmp_path, monkeypatch):
    """REPRO_POOL_CHECK=1 asks for the crash-consistency checker, which is
    not ported: pool creation and recovery refuse rather than run unchecked."""
    tmp = str(tmp_path / "ck")
    cfg, tc, cc, data = setup_run(tmp)
    run_with_manager(cfg, tc, cc, data, 1).pool.close()
    monkeypatch.setenv("REPRO_POOL_CHECK", "1")
    with pytest.raises(PoolError, match="REPRO_POOL_CHECK"):
        make_pool("dram")
    with pytest.raises(PoolError, match="REPRO_POOL_CHECK"):
        recovery.recover(tmp)


# -- the CLI ---------------------------------------------------------------------

def _cli(*args):
    env = {**os.environ, "PYTHONPATH": SRC}
    env.pop("REPRO_POOL_CHECK", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_checkpoint_and_resume(tmp_path, arch):
    ck = str(tmp_path / "ck")
    a = ("--arch", arch, "--seq", "16")
    r = _cli(*a, "--steps", "3", "--ckpt-dir", ck, "--dense-interval", "1")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "'tier_e': 3" in r.stdout and "pool[pmem]" in r.stdout
    r = _cli(*a, "--steps", "2", "--ckpt-dir", ck, "--resume")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumed at step 3" in r.stdout
    assert "done on cpu: 2 steps" in r.stdout


@pytest.mark.parametrize("args,msg", [
    (["--pool-backend", "remote"], "--pool-addr"),
    (["--pool-backend", "sharded"], "--pool-shards"),
    (["--pool-backend", "dram", "--resume"], "volatile"),
])
def test_cli_refuses(tmp_path, args, msg):
    r = _cli("--steps", "1", "--ckpt-dir", str(tmp_path / "ck"), *args)
    assert r.returncode != 0 and msg in r.stderr
