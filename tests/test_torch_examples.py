"""The port's examples (``repro_torch.examples``) on the CPU, at smoke size.

Each runs as a subprocess with ``--device cpu``, as a user runs it, and
must exit 0 with its marker line. A CUDA device without a card must raise.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import (fault_tolerance_demo, pool_soak, quickstart,
                                  serve_batched, shared_pool_demo,
                                  train_dlrm_e2e)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"fault_tolerance_demo": fault_tolerance_demo,
            "train_dlrm_e2e": train_dlrm_e2e, "quickstart": quickstart,
            "serve_batched": serve_batched,
            "shared_pool_demo": shared_pool_demo, "pool_soak": pool_soak}


def _run(name, *args, tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                        "--device", "cpu", *args], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("backend", ["pmem", "dram", "remote"])
def test_fault_tolerance_demo(tmp_path, backend):
    """The drill recovers a mirror bitwise equal to a clean replay, whose
    every logged step's device undo image equals the pool's, and resumes.
    remote: a memory node and a trainer in processes of their own, the
    trainer SIGKILLed and the node alive."""
    out = _run("fault_tolerance_demo", "--pool-backend", backend,
               "--work-dir", str(tmp_path), tmp_path=tmp_path)
    assert "BIT-IDENTICAL to a clean replay" in out
    assert "the device's equal the pool's bitwise" in out
    assert "the mirror equals the tables" in out
    assert out.rstrip().endswith("fault-tolerance demo PASSED")
    if backend in ("pmem", "remote"):
        assert "SIGKILLed trainer after 12 reported steps" in out
    if backend == "remote":
        assert "memory node still alive" in out
        assert "memory node shut down" in out
    if backend == "dram":
        assert "rolled_back=True" in out
    assert os.listdir(tmp_path) == []      # its pool files are removed


def test_shared_pool_demo(tmp_path):
    """Two trainer tenants with quotas checkpoint into one memory node at
    once; the node attributes traffic to each, and keeps a third tenant out
    of their bytes and within its quota."""
    out = _run("shared_pool_demo", "--work-dir", str(tmp_path),
               tmp_path=tmp_path)
    for tenant in ("trainer-a", "trainer-b"):
        assert f"[{tenant}] done: {{'tier_e': 8" in out
        assert f"-- tenant '{tenant}': media=" in out
    assert "cross-tenant read denied" in out
    assert "over-quota alloc denied" in out
    assert out.rstrip().endswith("shared-pool demo PASSED")
    assert os.listdir(tmp_path) == []


def test_train_dlrm_e2e(tmp_path):
    out = _run("train_dlrm_e2e", "--steps", "4", "--batch", "32",
               "--work-dir", str(tmp_path), tmp_path=tmp_path)
    assert "96.1M params" in out and "simulated crash at step 2" in out
    assert "recovered: embeddings@1" in out and "== done: 4 steps" in out


def test_quickstart(tmp_path):
    out = _run("quickstart", tmp_path=tmp_path)
    assert "strict == relaxed: True" in out and "generated:" in out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_serve_batched(tmp_path, arch):
    out = _run("serve_batched", "--arch", arch, "--new-tokens", "8",
               tmp_path=tmp_path)
    assert f"[prefill] {arch} on cpu: 8x32 tokens" in out
    assert "[decode] 8x8 tokens" in out and "[sample]" in out


@pytest.mark.parametrize("backend", ["dram", "pmem", "remote"])
def test_serve_batched_pool_drill(tmp_path, backend):
    """Serving from the pool with commits interleaved: each commit evicts
    exactly the cached rows it touched (the JAX drill's counts), the rows
    after it are the committed ones bitwise, and no file is left behind.
    remote serves through a read-only tenant of an in-process node."""
    readonly = ["--pool-readonly"] if backend == "remote" else []
    out = _run("serve_batched", "--pool-backend", backend, *readonly,
               tmp_path=tmp_path)
    assert f"[pool-serve] backend={backend} table=4096x32 cache=512 rows" in out
    for step, n in enumerate((7, 8, 8, 8)):
        assert f"step {step}: commit touched 8 rows, evicted exactly {n} " \
            "cached" in out
    assert "132 requests, 2435 rows" in out and "inval=31" in out
    assert out.rstrip().endswith("pool-serving drill PASSED")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name,args,markers", [
    ("fault_tolerance_demo", ["--pool-backend", "sharded"],
     ("BIT-IDENTICAL to a clean replay", "restarted over its pmem image",
      "fused undo capture stayed on the owning shard",
      "kill -9'd the DESTINATION memory node", "the partial copy swept",
      "the policy migrated embedding-mirror + undo-log to node",
      "post-migration recovery BIT-IDENTICAL", "DELETED its image", "in ONE epoch",
      "recovered BIT-IDENTICAL through the replication watermark",
      "resumed on the survivors", "still absent", "memory nodes shut down",
      "fault-tolerance demo PASSED")),
    ("serve_batched", ["--pool-backend", "sharded"],
     ("evicted exactly 7 cached", "killed primary shard",
      "replica served 8 requests after the primary's death (staleness <= 0",
      "failovers=1", "pool-serving drill PASSED")),
])
def test_unported_options_raise(tmp_path, name, args, markers):
    """The sharded drills, which raised until the sharded pool was ported,
    run as a user runs them. The crash demo: two memory-node processes, the
    mirror's node killed and restarted under a trainer subprocess with
    bitwise recovery, the live migration whose destination is killed
    mid-copy, and the permanent loss of a node with the replica promoted in
    one epoch. serve_batched: the read replica serves every committed row
    after the primary's node is shut down."""
    if name == "fault_tolerance_demo":
        args = [*args, "--work-dir", str(tmp_path)]
    out = _run(name, *args, tmp_path=tmp_path)
    for marker in markers:
        assert marker in out, marker
    assert os.listdir(tmp_path) == []


def _reference_soak_cells(tmp_path):
    """The JAX package's ``examples/pool_soak.py`` ``one_cell`` for the pmem
    and remote backends, seeds 0-2, in this process (its remote cells
    through the JAX package's node)."""
    import importlib.util

    import repro.pool as J
    spec = importlib.util.spec_from_file_location(
        "reference_pool_soak", os.path.join(REPO, "examples", "pool_soak.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ctx = ref.build_ctx()
    cells = []
    for backend in ("pmem", "remote"):
        for seed in range(3):
            work = tmp_path / f"ref-{backend}-{seed}"
            work.mkdir()
            server = J.PoolServer(J.PmemPool(str(work / "pool.img"), 1 << 22),
                                  f"unix:{work}/p.sock").start() \
                if backend == "remote" else None
            try:
                cells.append(ref.one_cell(ctx, backend, seed, str(work / "ck"),
                                          server.addr if server else None))
            finally:
                if server is not None:
                    server.shutdown(close_device=True)
    return cells


def test_pool_soak_matches_the_reference(tmp_path):
    """The seeded soak over pmem and a memory node, seeds 0-2 (one crash,
    torn and drop cell each) under the checker, as its nightly run: it
    exits 0, and each cell's kind, crash, mirror and dense steps and
    rollback equal the JAX package's soak cell for the same seed."""
    out_json = tmp_path / "soak.json"
    env = {**os.environ, "PYTHONPATH": SRC, "REPRO_POOL_CHECK": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.pool_soak", "--device",
         "cpu", "--backends", "pmem,remote", "--seeds", "3", "--out",
         str(out_json)], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ref = _reference_soak_cells(tmp_path)   # meanwhile, in this process
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "soak: 6 ok, 0 failed" in out
    report = json.loads(out_json.read_text())
    assert report["failures"] == [] and report["steps_per_cell"] == 12

    def key(c):
        return {k: c[k] for k in ("backend", "seed", "kind", "crashed",
                                  "mirror_step", "dense_step", "rolled_back")}
    got = [key(c) for c in report["cells"]]
    assert got == [key(c) for c in ref]
    assert sorted(c["kind"] for c in got) == ["crash", "crash", "drop",
                                              "drop", "torn", "torn"]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_without_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        EXAMPLES[name].main([])


def test_examples_import_no_jax_and_no_reference():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import repro_torch.examples.fault_tolerance_demo, "
         "repro_torch.examples.train_dlrm_e2e, repro_torch.examples.quickstart, "
         "repro_torch.examples.serve_batched, "
         "repro_torch.examples.shared_pool_demo, "
         "repro_torch.examples.pool_soak\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'ml_dtypes', 'repro')]\n"
         "print(bad); sys.exit(1 if bad else 0)"],
        env={**os.environ, "PYTHONPATH": SRC}, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
