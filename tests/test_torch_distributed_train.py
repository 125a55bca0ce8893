"""The port's DLRM trained under a mesh (``train_loop`` under
``sharding.use_sharding``, the mesh checkpoint and recovery of
``repro_torch.distributed.checkpoint``, ``distributed.compression``)
against the JAX package's steps jitted with the dry run's state and batch
shardings, at the smoke size (dlrm-rm1: 20 tables x 2048 rows x 32, 80
lookups a bag) in f32, batch 4, 4 steps, with sgd and with row-wise
Adagrad on the sparse tier.

The params come from the JAX package's init (``PRNGKey(0)``); the port
takes them through ``interop`` and each rank keeps its part
(``sharding.shard_params``). One module fixture runs everything that needs
more than one process, all started together:
  * one spawn of gloo ranks on the CPU per mesh layout (data x model):
    (1, 2), two ranks, and (2, 2), four; each rank runs every case and
    writes its results; the (1, 2) ranks also run the checkpointed cases
    at (2, 1), where each rank holds the tables whole;
  * this file run as a script in a JAX subprocess under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the reference's
    ``relaxed_step`` and ``strict_step`` jitted with
    ``dryrun.state_shardings`` / ``batch_shardings`` on the same layouts
    and act rules ``{"batch": ("data",)}``, the programs compiled on
    threads.
On the CPU the ranks' kernels are their plain versions (by the tensors'
device), as everywhere in the port.

Tolerances: losses within rtol 2e-5 (``tests/test_relaxed.py:39``'s), the
tables and dense params within 1e-5 of the largest magnitude. The
reference's own gap between these sharded steps and its unsharded ones is
1.7e-7 relative in the losses and 1.1e-7 absolute in the tables (4 steps
at (1, 2), (2, 1) and (2, 2)). Bitwise: each rank's slice of the batch
against the reference's ``device_put``; the writer's merged feed ids
against the reference's batch ids; the feed ids and the first step's undo
images against the port's one-rank run; the merged feed, and the mirror
it writes, against the one-rank feed for the same gradients; the
recovered mirror against the tables the ranks held at the last committed
step; every committed undo entry against the images the ranks captured.
"""
import os
import pickle
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint import recovery as jrecovery
from repro.core.checkpoint.manager import flatten_touched
from repro.data.synthetic import DLRMBatches as JaxDLRMBatches
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core import relaxed as rx
from repro_torch.distributed import compression, sharding
from repro_torch.launch import mesh as pmesh
from repro_torch.training import train_loop

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CPU = torch.device("cpu")
RULES = {"batch": ("data",)}
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}          # (data, model)
WHOLE = "2x1"           # the tables held whole; run by the (1, 2) spawn's ranks
CKPT_LAYOUTS = (*LAYOUTS, WHOLE)
SYNC_KINDS = ("f32", "f32+bf16")
OPTS = ("sgd", "rowwise_adagrad")
SCHEDULES = ("relaxed", "strict")
B, STEPS, LR = 4, 4, 0.05
LOSS_RTOL, PARAM_TOL = 2e-5, 1e-5
CRASH_STEP = 2          # the writer crashes between step 2's COMMIT and apply
RESUMED = 2             # steps resumed after recovery
TIMEOUT = 120           # seconds a collective may wait before it raises


def _cfg():
    return get_arch("dlrm-rm1", smoke=True).model


def _tc(opt):
    return TrainConfig(embed_learning_rate=LR, embed_optimizer=opt)


# -- the JAX package on four host devices (run as a script) ---------------------


def _jax_inputs():
    from repro.models.registry import get_api
    cfg = jax_get_arch("dlrm-rm1", smoke=True).model
    params = jax.jit(lambda k: get_api(cfg).init(k, cfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    T, d = cfg.dlrm_num_tables, cfg.dlrm_bottom_mlp[-1]
    return {"params": jax.tree.map(np.asarray, params),
            "g_rows": rng.standard_normal((B, T, d)).astype(np.float32),
            "comp": rng.standard_normal((2, 64, 32)).astype(np.float32)}


def _jax_cases():
    from jax.sharding import Mesh
    assert jax.device_count() == 4, jax.devices()
    from repro.launch import dryrun          # sets XLA_FLAGS for later processes only
    cfg = jax_get_arch("dlrm-rm1", smoke=True).model
    data = JaxDLRMBatches(cfg, B, seed=0)
    batches = [{k: jnp.asarray(v) for k, v in data.next(n).items()}
               for n in range(STEPS + 1)]
    dp = ("data",)

    def case(layout, opt, schedule):
        shape = LAYOUTS[layout]
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        tc = JaxTrainConfig(embed_learning_rate=LR, embed_optimizer=opt)
        init_fn, strict_step, relaxed_step, warmup = jtl.make_step_fns(cfg, tc)
        out = {}
        with jsh.use_sharding(mesh, RULES):
            state = jax.jit(init_fn)(jax.random.PRNGKey(0))
            b_sh = dryrun.batch_shardings(cfg, batches[0], mesh, dp)
            if schedule == "relaxed":
                state = jax.jit(warmup)(state, batches[0])
            st_sh = dryrun.state_shardings(jax.eval_shape(lambda: state), {}, mesh, dp,
                                           cfg)
            state = jax.device_put(state, st_sh)
            put = [jax.device_put(b, b_sh) for b in batches]
            losses, touched = [], []
            if schedule == "relaxed":
                step = jax.jit(relaxed_step, in_shardings=(st_sh, b_sh, b_sh))
                for n in range(STEPS):
                    state, m = step(state, put[n], put[n + 1])
                    losses.append(float(m["loss"]))
                    touched.append(np.asarray(m["ckpt_feed"]["touched"]))
            else:
                step = jax.jit(strict_step, in_shardings=(st_sh, b_sh))
                for n in range(STEPS):
                    state, m = step(state, put[n])
                    losses.append(float(m["loss"]))
            if layout == "2x2" and opt == "sgd" and schedule == "relaxed":
                split = out["split"] = {}
                for k, v in put[0].items():
                    for sh in v.addressable_shards:
                        c = tuple(int(x) for x in np.argwhere(mesh.devices == sh.device)[0])
                        split.setdefault(c, {})[k] = np.asarray(sh.data)
            out[(layout, opt, schedule)] = {
                "losses": np.asarray(losses), "touched": touched,
                "tables": np.asarray(state["embed"]["emb_tables"]),
                "tables_spec": tuple(state["embed"]["emb_tables"].sharding.spec),
                "dense": jax.tree.map(np.asarray, state["dense"]),
                "opt_embed": jax.tree.map(np.asarray, state["opt_embed"])}
        return out

    jobs = [(lay, o, s) for lay in LAYOUTS for o in OPTS for s in SCHEDULES]
    results, lock = {}, threading.Lock()

    def run(job):
        got = case(*job)
        with lock:
            results.update(got)
    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == len(jobs) + 1, sorted(results)
    return results


# -- the port at gloo ranks -----------------------------------------------------


def _gathered(mesh, state):
    """(the whole tables, gathered from the blocks over ``model``, the
    dense tree, the embedding optimizer's state) as numpy, on every rank."""
    tab = mesh.all_gather(state["embed"]["emb_tables"], "model", 1)
    return (tab.numpy().copy(), interop.params_to_numpy(state["dense"]),
            interop.params_to_numpy(state["opt_embed"]))


def _layout_cases(mesh, inp, out_dir, cases):
    """This rank's results at ``mesh``'s layout: ``cases`` (optimizer,
    schedule) trained 4 steps, relaxed sgd checkpointed through the writer;
    the merged feed for the same gradients against the one-rank feed; and
    at two ranks the crash drill."""
    from repro_torch.core.checkpoint.manager import check_undo_images, undo_image
    from repro_torch.core.checkpoint.undo_log import UndoRing
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.pool import FaultSchedule, InjectedCrash
    from repro_torch.pool.allocator import PoolAllocator
    cfg = _cfg()
    layout = f"{mesh.shape[0]}x{mesh.shape[1]}"
    writer = mesh.axis_index(mesh.axis_names) == 0
    out = {"coords": (mesh.coords["data"], mesh.coords["model"]),
           "ck_root": os.path.join(out_dir, f"ck-{layout}")}
    whole = interop.params_from_numpy(inp["params"], CPU)

    def data():
        return DLRMBatches(cfg, B, seed=0, device="cpu")

    def fresh(opt):
        p = sharding.shard_params(interop.params_from_numpy(inp["params"], CPU), mesh)
        return train_loop.make_step_fns(cfg, _tc(opt))[0](p)

    with sharding.use_sharding(mesh, RULES):
        out["split"] = {k: v.numpy() for k, v in
                        sharding.shard_batch(data().next(0), mesh, RULES).items()}
        out["rows_held"] = fresh("sgd")["embed"]["emb_tables"].shape[1]

    # the cases; relaxed sgd checkpointed through the writer
    for opt, schedule in cases:
        ckpt = opt == "sgd" and schedule == "relaxed"
        feeds, images = [], {}
        with sharding.use_sharding(mesh, RULES):
            mgr = None
            state = fresh(opt)
            if ckpt:
                cc = CheckpointConfig(directory=out["ck_root"], dense_interval=1,
                                      pool_backend="pmem")
                mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"])

                def hook(n, feed, feeds=feeds, images=images):
                    k = int((feed["touched"] >= 0).sum())
                    feeds.append((feed["touched"][:k].clone(),
                                  feed["old_rows"][:k].clone()))
                    images[n] = undo_image(feed)
                mgr.add_feed_hook(hook)
            before = mesh.stats()
            state, losses = train_loop.train(
                cfg, _tc(opt), data(), STEPS, relaxed=schedule == "relaxed",
                state=state, ckpt_manager=mgr, device="cpu")
            moved = {k: (v["calls"] - before.get(k, {}).get("calls", 0),
                         v["bytes"] - before.get(k, {}).get("bytes", 0))
                     for k, v in mesh.stats().items()}
            if mgr is not None:
                if writer:
                    out["undo_checked"] = check_undo_images(mgr.manager.ring, images)
                    out["feeds"] = [(i.numpy(), o.numpy()) for i, o in feeds]
                    out["mirror_load_s"] = mgr.stats["mirror_load_s"]
                mgr.close()
        out[(opt, schedule)] = {"losses": np.asarray(losses), "moved": moved,
                                "state": _gathered(mesh, state)}

    # the merged feed for the same gradients against the one-rank feed: one
    # sgd step's sparse tier, each rank its slice of g_rows
    g = torch.from_numpy(inp["g_rows"])
    dp = mesh.shape[0]
    if writer:
        one = {"emb_tables": whole["embed"]["emb_tables"].clone()}
        u1, g1 = rx.sparse_rows_grad(one, cfg, data().next(0), g * (1.0 / dp))
        o1 = rx.apply_embed_update_logged(one, cfg, u1, -LR * g1)
    with sharding.use_sharding(mesh, RULES):
        batch = sharding.shard_batch(data().next(0), mesh, RULES)
        g_mine = sharding.shard_batch({"g": g}, mesh, RULES)["g"]
        embed = fresh("sgd")["embed"]
        cc = CheckpointConfig(directory=os.path.join(out_dir, f"feed-{layout}"),
                              dense_interval=0, pool_backend="dram")
        mgr = MeshCheckpoint(cfg, cc, embed_init=embed)
        merged = {}
        mgr.add_feed_hook(lambda n, feed: merged.update(feed))
        uniq, grad = rx.sparse_rows_grad(embed, cfg, batch, g_mine)
        upd = -LR * grad
        old = rx.apply_embed_update_logged(embed, cfg, uniq, upd)
        mgr.on_step(0, {"embed": embed}, {"touched": uniq, "delta": upd, "old_rows": old})
        mgr.flush()
        if writer:
            out["feed_case"] = {
                "merged": {k: v.numpy() for k, v in merged.items()},
                "one": {"touched": u1.numpy(), "delta": (-LR * g1).numpy(),
                        "old_rows": o1.numpy()},
                "mirror": np.array(mgr.manager.mirror_rows),
                "one_tables": one["emb_tables"].reshape(-1, upd.shape[-1]).numpy()}
        mgr.close()

    # the crash drill at two ranks: the writer crashes between step
    # CRASH_STEP's undo COMMIT and its mirror apply; every rank stops after
    # that step
    if mesh.shape[0] * mesh.shape[1] == 2:
        root = os.path.join(out_dir, f"crash-{layout}")
        cc = CheckpointConfig(directory=root, dense_interval=1, pool_backend="pmem")
        images, snap = {}, {}
        with sharding.use_sharding(mesh, RULES):
            state = fresh("sgd")
            faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                            occurrence=CRASH_STEP + 1)
            mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                                 faults=faults if writer else None)
            mgr.add_feed_hook(lambda n, feed: images.__setitem__(n, undo_image(feed)))
            table = state["embed"]["emb_tables"]     # updated in place

            def keep(n, _):
                if n == CRASH_STEP - 1:
                    snap["tables"] = table.clone()
            crashed = False
            try:
                train_loop.train(cfg, _tc("sgd"), data(), CRASH_STEP + 1, state=state,
                                 ckpt_manager=mgr, on_metrics=keep, device="cpu")
            except InjectedCrash:
                crashed = True
                mgr.manager.pool.close()       # the writer's process death
            out["crashed"] = crashed
            state, start, rec = recover_on_mesh(cfg, root, fresh("sgd"))
            out["resume_at"] = start
            out["recovered_bitwise"] = torch.equal(state["embed"]["emb_tables"],
                                                   snap["tables"])
            if writer:
                out["rec"] = (rec.mirror_step, rec.dense_step, rec.rolled_back)
                ring = UndoRing(PoolAllocator(rec.pool), cc.max_undo_logs)
                out["crash_undo_checked"] = check_undo_images(ring, images)
            mgr2 = MeshCheckpoint(cfg, cc, pool=rec.pool if writer else None)
            mgr2.init_mirror(state["embed"], step=start - 1)
            _, tail = train_loop.train(cfg, _tc("sgd"), data(), RESUMED, state=state,
                                       start_step=start, ckpt_manager=mgr2, device="cpu")
            mgr2.close()
            out["resumed"] = np.asarray(tail)
    return out


def _torch_rank(rank, world, device, model_parallel, inp_path, out_dir):
    """One rank: every case at this layout (and, at (1, 2), the checkpointed
    cases at (2, 1) over the same two ranks: the tables held whole), its
    results pickled to ``out_dir/rank{rank}.pkl``. The inputs come from the
    JAX subprocess."""
    torch.set_num_threads(1)
    deadline = time.monotonic() + 180
    while not os.path.exists(inp_path):
        assert time.monotonic() < deadline, f"no {inp_path} from the JAX subprocess"
        time.sleep(0.1)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    mesh = pmesh.make_local_mesh(model_parallel=model_parallel, device=device)
    out = _layout_cases(mesh, inp, out_dir, [(o, s) for o in OPTS for s in SCHEDULES])
    if mesh.shape == (1, 2):
        held_whole = pmesh.make_local_mesh(model_parallel=1, device=device)
        out[WHOLE] = _layout_cases(held_whole, inp, out_dir, [("sgd", "relaxed")])

    # compressed_psum over the model axis, each rank its own tensor; the
    # dense sync over data, of f32 leaves and of f32 and bf16 leaves at once
    out["comp"] = compression.compressed_psum(
        torch.from_numpy(inp["comp"][mesh.coords["model"]]), mesh, "model").numpy()
    with sharding.use_sharding(mesh, RULES):
        for kind in SYNC_KINDS:
            w = torch.from_numpy(inp["comp"][mesh.coords["data"]].copy())
            grads = {"w": w}
            if kind == "f32+bf16":
                grads["b"] = w[0].to(torch.bfloat16)
            loss = train_loop.sync_dense_(grads, torch.tensor(mesh.coords["data"] + 1.0),
                                          get_arch("dlrm-rm1", smoke=True).model)
            out[f"sync/{kind}"] = ({k: v.float().numpy() for k, v in grads.items()},
                                   float(loss))
    # an LM the port does not train under a mesh yet (the dense decoders
    # train since tensor parallelism came: tests/test_torch_tensor_parallel.py)
    lm = get_arch("rwkv6-3b", smoke=True).model
    with sharding.use_sharding(mesh, RULES):
        try:
            train_loop.make_step_fns(lm, TrainConfig())
            out["lm_raised"] = None
        except NotImplementedError as e:
            out["lm_raised"] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _spawn(layout, inp_path, out_dir):
    d, m = LAYOUTS[layout]
    pmesh.spawn(_torch_rank, d * m, backend="gloo", device="cpu",
                args=(m, str(inp_path), str(out_dir)), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, {layout: [rank 0's, ...]}, port one-rank results,
    the work directory): the JAX subprocess (which makes the inputs
    first), one spawn a layout and the one-rank runs here, all together."""
    d = tmp_path_factory.mktemp("dist-train")
    inp_path, jax_out = d / "inputs.pkl", d / "jax.pkl"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, HERE]),
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    jax_proc = subprocess.Popen([sys.executable, __file__, str(inp_path), str(jax_out)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    errors = {}

    def spawn(layout):
        try:
            os.makedirs(d / layout, exist_ok=True)
            _spawn(layout, inp_path, d / layout)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors[layout] = e
    try:
        threads = [threading.Thread(target=spawn, args=(lay,)) for lay in LAYOUTS]
        for t in threads:
            t.start()
        one = _one_rank(inp_path)
        for t in threads:
            t.join()
        log = jax_proc.communicate(timeout=300)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert not errors, errors
    assert jax_proc.returncode == 0, log
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    ranks = {}
    for layout, (dd, m) in LAYOUTS.items():
        ranks[layout] = []
        for r in range(dd * m):
            with open(d / layout / f"rank{r}.pkl", "rb") as f:
                ranks[layout].append(pickle.load(f))
    ranks[WHOLE] = [r[WHOLE] for r in ranks["1x2"]]
    return want, ranks, one, d


def _one_rank(inp_path):
    """The port's one-rank relaxed sgd run: each step's feed ids (pads
    dropped) and undo images, its losses and its tables after the run."""
    from repro_torch.data.synthetic import DLRMBatches
    deadline = time.monotonic() + 180
    while not os.path.exists(inp_path):
        assert time.monotonic() < deadline, f"no {inp_path} from the JAX subprocess"
        time.sleep(0.1)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    cfg = _cfg()
    state = train_loop.make_step_fns(cfg, _tc("sgd"))[0](
        interop.params_from_numpy(inp["params"], CPU))
    feeds = []

    def keep(n, m):
        k = int((m["ckpt_feed"]["touched"] >= 0).sum())
        feeds.append((m["ckpt_feed"]["touched"][:k].numpy().copy(),
                      m["ckpt_feed"]["old_rows"][:k].numpy().copy()))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, losses = train_loop.train(cfg, _tc("sgd"), DLRMBatches(cfg, B, seed=0,
                                                                      device="cpu"),
                                         STEPS, state=state, on_metrics=keep, device="cpu")
    finally:
        torch.set_num_threads(n)
    return {"feeds": feeds, "losses": np.asarray(losses), "comp": inp["comp"],
            "tables": state["embed"]["emb_tables"].numpy().copy()}


def _close(got, want, tol):
    """Every leaf of ``got`` within ``tol`` of ``want``'s largest magnitude."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w, strict=True):
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol * scale, float(np.abs(a - b).max()) / scale


@pytest.mark.parametrize("layout", CKPT_LAYOUTS)
def test_dp_batch_split_bitwise(runs, layout):
    """Each rank's slice of batch 0 is bitwise the shard that the
    reference's ``device_put`` with ``batch_shardings`` puts on the device
    at its coordinates (the (2, 2) mesh's; a slice depends on the data
    coordinate alone); at (1, 2) every rank keeps the whole batch."""
    want, ranks, _, _ = runs
    split = want["split"]
    full = {k: np.concatenate([split[(0, 0)][k], split[(1, 0)][k]]) for k in split[(0, 0)]}
    for got in ranks[layout]:
        ref = full if layout == "1x2" else split[got["coords"]]
        assert set(got["split"]) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got["split"][k], ref[k])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_losses_match_jax(runs, layout, opt, schedule):
    """Every rank reports the global loss, within rtol 2e-5 of the
    reference's sharded step's, and the ranks agree bitwise."""
    want, ranks, _, _ = runs
    ref = want[(layout, opt, schedule)]["losses"]
    for got in ranks[layout]:
        np.testing.assert_allclose(got[(opt, schedule)]["losses"], ref, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got[(opt, schedule)]["losses"],
                                      ranks[layout][0][(opt, schedule)]["losses"])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_params_match_jax(runs, layout, opt, schedule):
    """After 4 steps: the tables (gathered from the ranks' blocks; the
    reference's come out sharded over ``model``), the dense params and the
    embedding optimizer's state (Adagrad's (T, 1, 1) accumulator) within
    1e-5 of the largest; each rank holds half of every table's rows."""
    want, ranks, _, _ = runs
    ref = want[(layout, opt, schedule)]
    assert ref["tables_spec"][:2] == (None, "model")
    for got in ranks[layout]:
        assert got["rows_held"] == _cfg().dlrm_rows_per_table // 2
        tables, dense, opt_embed = got[(opt, schedule)]["state"]
        _close(tables, ref["tables"], PARAM_TOL)
        _close(dense, ref["dense"], PARAM_TOL)
        _close(opt_embed, ref["opt_embed"], PARAM_TOL)


def test_tables_held_whole_match_one_rank(runs):
    """At (2, 1), where nothing shards the tables and each rank holds them
    whole, 4 checkpointed relaxed sgd steps: the losses within rtol 2e-5
    of the port's one-rank run's and of the reference's at (1, 2) (its
    layouts agree within 1.7e-7), the ranks bitwise alike, and the tables
    within 1e-5 of the largest of the one-rank run's."""
    want, ranks, one, _ = runs
    for got in ranks[WHOLE]:
        assert got["rows_held"] == _cfg().dlrm_rows_per_table
        losses = got[("sgd", "relaxed")]["losses"]
        np.testing.assert_allclose(losses, one["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(losses, want[("1x2", "sgd", "relaxed")]["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(losses,
                                      ranks[WHOLE][0][("sgd", "relaxed")]["losses"])
        _close(got[("sgd", "relaxed")]["state"][0], one["tables"], PARAM_TOL)


@pytest.mark.parametrize("layout", CKPT_LAYOUTS)
def test_merged_feed_ids_match_jax_and_one_rank(runs, layout):
    """The writer's merged feed, each relaxed step: its ids bitwise the
    distinct flat ids of the reference's feed (the global batch's, at
    (1, 2) for the layout the reference does not run) and of the port's
    one-rank feed; the first step's undo image bitwise the one-rank run's
    (both the initial tables' rows)."""
    want, ranks, one, _ = runs
    feeds = ranks[layout][0]["feeds"]
    assert len(feeds) == STEPS
    jax_layout = layout if layout in LAYOUTS else "1x2"
    for n, (ids, old) in enumerate(feeds):
        ref = flatten_touched(jax_get_arch("dlrm-rm1", smoke=True).model,
                              want[(jax_layout, "sgd", "relaxed")]["touched"][n])
        np.testing.assert_array_equal(ids.astype(np.int64), ref)
        np.testing.assert_array_equal(ids, one["feeds"][n][0])
    np.testing.assert_array_equal(feeds[0][1], one["feeds"][0][1])


@pytest.mark.parametrize("layout", CKPT_LAYOUTS)
def test_merged_feed_is_the_one_rank_feed(runs, layout):
    """For the same bag-row gradients, the writer's merged feed (ids,
    deltas, undo image) is bitwise the one-rank adjoint's and update's,
    and the mirror it wrote is bitwise the one-rank tables after the
    update."""
    _, ranks, _, _ = runs
    case = ranks[layout][0]["feed_case"]
    for k in ("touched", "delta", "old_rows"):
        np.testing.assert_array_equal(case["merged"][k], case["one"][k])
    np.testing.assert_array_equal(case["mirror"], case["one_tables"])


@pytest.mark.parametrize("layout", CKPT_LAYOUTS)
def test_undo_entries_match_the_device_images(runs, layout):
    """Every committed undo entry of the checkpointed run equals the image
    the ranks' logged updates captured (``check_undo_images``)."""
    _, ranks, _, _ = runs
    assert ranks[layout][0]["undo_checked"] == STEPS
    assert ranks[layout][0]["mirror_load_s"] > 0


@pytest.mark.parametrize("layout", CKPT_LAYOUTS)
def test_checkpoint_recovers_in_both_packages(runs, layout):
    """The checkpoint written through the writer at this layout recovers in
    the JAX package and in the port: the mirror bitwise the ranks' gathered
    tables after the last step, the dense tier at that step."""
    from repro_torch.core.checkpoint import recovery
    _, ranks, _, _ = runs
    root = ranks[layout][0]["ck_root"]
    tables = ranks[layout][0][("sgd", "relaxed")]["state"][0]
    for rec in (jrecovery.recover(root), recovery.recover(root)):
        assert rec.mirror_step == STEPS - 1 and rec.dense_step == STEPS - 1
        np.testing.assert_array_equal(np.asarray(rec.embed_rows),
                                      tables.reshape(-1, tables.shape[-1]))
        rec.pool.close()


@pytest.mark.parametrize("layout", ("1x2", WHOLE))
def test_recover_and_resume_at_two_ranks(runs, layout):
    """The writer crashed between step 2's undo COMMIT and its mirror apply
    (every rank stopped after step 2): recovery at two ranks rolls back to
    step 1, each rank's block (at (2, 1) the whole tables) bitwise the
    tables it held after step 1, every committed undo entry equal to the
    ranks' images, and 2 resumed steps within rtol 2e-5 of the
    uninterrupted run's."""
    _, ranks, _, _ = runs
    r0 = ranks[layout][0]
    assert r0["crashed"] and r0["rec"] == (CRASH_STEP - 1, CRASH_STEP - 1, True)
    assert r0["crash_undo_checked"] == CRASH_STEP + 1
    assert not ranks[layout][1]["crashed"]
    full = r0[("sgd", "relaxed")]["losses"]
    for got in ranks[layout]:
        assert got["resume_at"] == CRASH_STEP and got["recovered_bitwise"]
        np.testing.assert_allclose(got["resumed"], full[CRASH_STEP:CRASH_STEP + RESUMED],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_compressed_psum_matches_jax(runs, layout):
    """``compressed_psum`` over the model axis: the sum of the ranks'
    int8-dequantised tensors, each by the JAX package's functions; bitwise
    (two f32 terms)."""
    _, ranks, one, _ = runs
    want = sum(np.asarray(jcomp.int8_decompress(*jcomp.int8_compress(jnp.asarray(x))))
               for x in one["comp"])
    for got in ranks[layout]:
        np.testing.assert_array_equal(got["comp"], want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lm_under_a_context_raises(runs, layout):
    """Training an LM the port does not yet run under a mesh (rwkv6-3b)
    under a sharding context raises, naming the item that will port it."""
    _, ranks, _, _ = runs
    for got in ranks[layout]:
        assert got["lm_raised"] and "10(c)" in got["lm_raised"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_strict_steps_collectives(runs, layout):
    """What 4 strict sgd steps move, on every rank: a step's bag one
    all-reduce of the rank's B * T * d f32 partial bags over ``model``;
    with two ``data`` ranks also the dense grads' one all-reduce (all f32)
    and the loss's, and the all-gathers of the batch's ids and of the bag
    rows' gradients (the counts are the gathered buffers' bytes)."""
    _, ranks, _, _ = runs
    cfg = _cfg()
    D = LAYOUTS[layout][0]
    T, L, d = cfg.dlrm_num_tables, cfg.dlrm_num_sparse, cfg.dlrm_bottom_mlp[-1]
    for got in ranks[layout]:
        n_dense = sum(x.size for x in jax.tree.leaves(got[("sgd", "strict")]["state"][1]))
        want = {"all_reduce_sum": (STEPS * (1 + 2 * (D > 1)),
                                   STEPS * (B // D * T * d * 4 + (D > 1) * (n_dense * 4 + 4)))}
        if D > 1:
            want["all_gather"] = (STEPS * 2, STEPS * (B * T * L * 4 + B * T * d * 4))
        moved = {k: v for k, v in got[("sgd", "strict")]["moved"].items() if v[0]}
        assert moved == want


@pytest.mark.parametrize("kind", SYNC_KINDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dense_sync(runs, layout, kind):
    """``sync_dense_`` under the context: at (2, 2) each grad becomes the
    mean over ``data`` of the ranks' grads and the loss the mean, bitwise
    (two terms, halved; a bf16 leaf summed as one bf16 add rounds it, in a
    reduction of its own beside the f32 one); at (1, 2) both are left as
    they are."""
    _, ranks, one, _ = runs
    comp = one["comp"]
    bf = [torch.from_numpy(x[0]).to(torch.bfloat16) for x in comp]
    for got in ranks[layout]:
        g, loss = got[f"sync/{kind}"]
        assert set(g) == ({"w", "b"} if kind == "f32+bf16" else {"w"})
        if layout == "2x2":
            np.testing.assert_array_equal(g["w"], (comp[0] + comp[1]) / np.float32(2))
            want_b = ((bf[0] + bf[1]) / 2).float().numpy()
            assert loss == 1.5
        else:
            np.testing.assert_array_equal(g["w"], comp[0])
            want_b = bf[0].float().numpy()
            assert loss == 1.0
        if "b" in g:
            np.testing.assert_array_equal(g["b"], want_b)


# -- single-process cases -------------------------------------------------------


def test_int8_compression_bitwise_jax(rng):
    """``int8_compress`` / ``_decompress`` bitwise the JAX package's; the
    round trip within 2% of the largest (``tests/test_system.py``)."""
    g = rng.standard_normal((64, 32)).astype(np.float32)
    q, s = compression.int8_compress(torch.from_numpy(g))
    jq, js = jcomp.int8_compress(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = compression.int8_decompress(q, s).numpy()
    np.testing.assert_array_equal(back, np.asarray(jcomp.int8_decompress(jq, js)))
    assert np.abs(back - g).max() / np.abs(g).max() < 0.02


def test_topk_compression_matches_jax(rng):
    """Top-k on distinct values: the same indices, values and round trip
    as the JAX package's."""
    g = rng.standard_normal((64, 32)).astype(np.float32)
    idx, vals, shape = compression.topk_compress(torch.from_numpy(g), 64)
    jidx, jvals, jshape = jcomp.topk_compress(jnp.asarray(g), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert shape == tuple(jshape)
    np.testing.assert_array_equal(compression.topk_decompress(idx, vals, shape).numpy(),
                                  np.asarray(jcomp.topk_decompress(jidx, jvals, jshape)))


def test_error_feedback_matches_jax(rng):
    """20 rounds of error feedback at k_frac 0.25: what is sent and the
    residual equal the JAX package's within 1e-6, and the cumulative sent
    plus the residual tracks the cumulative gradient within 1e-4
    (``tests/test_system.py``)."""
    ef, jef = compression.ErrorFeedback(), jcomp.ErrorFeedback()
    errors = ef.init({"w": torch.zeros((16, 8))})
    jerrors = jef.init({"w": jnp.zeros((16, 8))})
    total_sent, total_true = np.zeros((16, 8)), np.zeros((16, 8))
    for _ in range(20):
        g = rng.standard_normal((16, 8)).astype(np.float32)
        sent, errors = ef.apply({"w": torch.from_numpy(g)}, errors, k_frac=0.25)
        jsent, jerrors = jef.apply({"w": jnp.asarray(g)}, jerrors, k_frac=0.25)
        np.testing.assert_allclose(sent["w"].numpy(), np.asarray(jsent["w"]), atol=1e-6)
        np.testing.assert_allclose(errors["w"].numpy(), np.asarray(jerrors["w"]), atol=1e-6)
        total_sent += sent["w"].numpy()
        total_true += g
    assert np.abs(total_true - total_sent - errors["w"].numpy()).max() < 1e-4


def test_shard_batch_raises_where_the_batch_does_not_split():
    """A batch of 3 over two data ranks raises; ``positions3`` splits on
    dimension 1."""
    m = pmesh.Mesh(pmesh.AXES, (2, 1), {"data": 1, "model": 0})
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_batch({"dense": torch.zeros(3, 2)}, m, RULES)
    pos = torch.arange(24).reshape(3, 4, 2)
    got = sharding.shard_batch({"positions3": pos, "tokens": torch.zeros(4, 2)}, m, RULES)
    assert torch.equal(got["positions3"], pos[:, 2:])
    assert got["tokens"].shape == (2, 2)


if __name__ == "__main__":
    inputs = _jax_inputs()
    with open(sys.argv[1] + ".tmp", "wb") as fout:
        pickle.dump(inputs, fout)
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
    results = _jax_cases()
    with open(sys.argv[2], "wb") as fout:
        pickle.dump(results, fout)
