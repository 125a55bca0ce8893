"""The port's dense decoders trained, checkpointed and served under FSDP
(``distributed/fsdp.py``: the weights' embed dimension over ``data`` as well,
gathered at their use) and with kv heads that the model axis does not divide
(each model rank reads them whole), against the JAX package's steps jitted
under the same rules on host devices, at the smoke sizes in f32:
  * granite-20b's smoke model under its full profile's train rules (FSDP,
    Megatron-SP, one kv head) at (data, model) = (2, 2);
  * tinyllama-1.1b's smoke model under its profile's rules at (1, 4), where
    its 2 kv heads are replicated over 4 model ranks and rank r's one query
    head reads kv head r // 2;
batch 2 x 16 tokens, 3 strict and 3 relaxed steps, AdamW (the default
``TrainConfig``, clip 1.0); then granite at (2, 2): a crash drill with
tier-M every step, recovery at every rank, one resumed step, and serving
(prefill and 3 decode steps) under its decode rules.

The params come from the port's init (a ``torch.Generator`` seeded 0),
written as numpy for both packages before anything starts; each rank keeps
its blocks (``sharding.shard_params`` with the rules). One module fixture
runs everything that needs more than one process, all started together:
one spawn of four gloo ranks on the CPU that builds both meshes
(``make_local_mesh(2)``, then ``make_local_mesh(4)``) and runs every case;
this file run as a script in a JAX subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, where the reference's
``strict_step``, ``warmup`` and ``relaxed_step`` are jitted with
``dryrun.state_shardings`` / ``batch_shardings`` on ``make_local_mesh``
under its ``build_rules``, and granite's prefill and decode with its
params placed by ``param_specs`` and ``check_divisibility`` under the
weight rules; and the port's one-rank strict runs here. Without the
fixture: ``build_rules`` against the reference's for every id and shape at
(2, 2) and (1, 4).

Tolerances, from ``tests/test_torch_tensor_parallel.py`` and restated from
what was measured here: losses within rtol 2e-5 of the reference's
(measured 1.5e-7); the gradient norms within rtol 1e-5 of the port's
one-rank run's (measured 2.2e-7); the params after 3 steps within 2e-3 of
each leaf's largest magnitude (AdamW's first steps move an element whose
gradient is near zero by up to the learning rate on a rounding; measured
2.5e-4 from the reference's) and their mean absolute difference within
1e-6 of it (measured 2.2e-8); the served logits within 1e-5 of the
largest (measured 5.2e-7), the tokens equal. Bitwise: relaxed
against strict; every leaf and moment that the ranks hold whole, across
the ranks; the recovered blocks against the ones the ranks held; the
tier-M blob, read by either package, against the ranks' tree gathered
whole.
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

if __name__ != "__main__":      # the JAX subprocess runs none of the port
    import torch

    from repro.core.checkpoint import recovery as jrecovery
    from repro_torch import interop
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.configs.base import SHAPES, CheckpointConfig, TrainConfig
    from repro_torch.data.synthetic import make_batches
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models.registry import get_api
    from repro_torch.training import serve_loop, train_loop
    from repro_torch.tree import tree_leaves, tree_map_with_path

    CPU = torch.device("cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
# case: (arch, (data, model))
CASES = {"granite": ("granite-20b", (2, 2)), "tinyllama": ("tinyllama-1.1b", (1, 4))}
ARCHS = tuple(a for a, _ in CASES.values())
SCHEDULES = ("strict", "relaxed")
B, S, STEPS, NEW = 2, 16, 3, 4
LOSS_RTOL, NORM_RTOL = 2e-5, 1e-5
PARAM_MAX, PARAM_MEAN = 2e-3, 1e-6
LOGIT_TOL = 1e-5
CRASH_STEP = 2          # the writer crashes between step 2's COMMIT and apply
WORLD, TIMEOUT = 4, 120


def _tc():
    return TrainConfig()


def _leaf_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


# -- the JAX package on four host devices (run as a script) ---------------------


def _jbundle(arch):
    """The reference's smoke model under its full profile's rules."""
    from repro.configs import get_arch as jget
    return dataclasses.replace(jget(arch, smoke=True), sharding=jget(arch).sharding)


def _jax_cases(inputs):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import SHAPES as JSHAPES
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data.synthetic import make_batches as jbatches
    from repro.distributed import sharding as jsh
    from repro.launch.mesh import make_local_mesh
    from repro.optim import optimizers as jopt
    from repro.training import serve_loop as jserve
    from repro.training import state as jstate
    from repro.training import train_loop as jtl
    assert jax.device_count() == WORLD, jax.devices()
    from repro.launch import dryrun as jdry   # its XLA_FLAGS reach no backend now

    def train_case(case, schedule):
        arch, (_, mp) = CASES[case]
        b = _jbundle(arch)
        cfg = b.model
        mesh = make_local_mesh(model_parallel=mp)
        rules, wrules, dp = jdry.build_rules(b, JSHAPES["train_4k"], mesh)
        tc = JTrainConfig()
        _, strict_step, relaxed_step, warmup = jtl.make_step_fns(cfg, tc)
        data = jbatches(cfg, B, S, seed=0)
        batches = [{k: jnp.asarray(v) for k, v in data.next(n).items()}
                   for n in range(STEPS + 1)]
        with jsh.use_sharding(mesh, rules):
            state = jstate.make_state(
                jax.tree.map(jnp.asarray, inputs[arch]),
                jopt.make_optimizer(tc.optimizer, tc.learning_rate, tc),
                jopt.make_optimizer(tc.embed_optimizer, tc.embed_learning_rate))
            if schedule == "relaxed":
                state = jax.jit(warmup)(state, batches[0])
            st_sh = jdry.state_shardings(jax.eval_shape(lambda: state), wrules, mesh,
                                         dp, cfg)
            b_sh = jdry.batch_shardings(cfg, batches[0], mesh, dp)
            state = jax.device_put(state, st_sh)
            losses = []
            if schedule == "relaxed":
                step = jax.jit(relaxed_step, in_shardings=(st_sh, b_sh, b_sh))
                for n in range(STEPS):
                    state, m = step(state, batches[n], batches[n + 1])
                    losses.append(float(m["loss"]))
            else:
                step = jax.jit(strict_step, in_shardings=(st_sh, b_sh))
                for n in range(STEPS):
                    state, m = step(state, batches[n])
                    losses.append(float(m["loss"]))
        specs = {}          # the placement the steps were jitted with
        for key in ("dense", "opt_dense", "embed"):
            for path, x in jax.tree_util.tree_flatten_with_path(state[key])[0]:
                sh = st_sh[key]
                for k in path:
                    sh = sh[getattr(k, "key", getattr(k, "idx", None))]
                specs[f"{key}/{_leaf_path(path)}"] = (tuple(x.shape), tuple(sh.spec))
        return {(case, schedule): {
            "losses": np.asarray(losses), "specs": specs, "rules": (rules, wrules, dp),
            "dense": jax.tree.map(np.asarray, state["dense"]),
            "table": np.asarray(state["embed"]["table"])}}

    def serve_case():
        arch, (_, mp) = CASES["granite"]
        b = _jbundle(arch)
        cfg = b.model
        mesh = make_local_mesh(model_parallel=mp)
        rules, wrules, _ = jdry.build_rules(b, JSHAPES["decode_32k"], mesh)
        prefill_step, decode_step, init_cache = jserve.make_serve_fns(cfg)
        prompt = jnp.asarray(jbatches(cfg, B, S, seed=0).next(0)["tokens"])
        with jsh.use_sharding(mesh, rules):
            params = jax.tree.map(jnp.asarray, inputs[arch])
            specs = jsh.param_specs(params, wrules, set(mesh.axis_names))
            specs = jsh.check_divisibility(params, specs, mesh)
            params = jax.device_put(params, jax.tree.map(
                lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
            caches = init_cache(B, S + NEW)
            logits, caches = jax.jit(prefill_step)(params, {"tokens": prompt}, caches)
            dec = jax.jit(decode_step)
            toks, kept = [jnp.argmax(logits, axis=-1)], [logits]
            for t in range(NEW - 1):
                logits, caches = dec(params, toks[-1][:, None], jnp.asarray(S + t),
                                     caches, {})
                toks.append(jnp.argmax(logits, axis=-1))
                kept.append(logits)
        return {"serve": {"tokens": np.asarray(jnp.stack(toks, axis=1)),
                          "logits": np.asarray(jnp.stack(kept, axis=1)),
                          "rules": (rules, wrules)}}

    jobs = [(train_case, (c, s)) for c in CASES for s in SCHEDULES] + [(serve_case, ())]
    results, lock, errors = {}, threading.Lock(), []

    def run(fn, args):
        try:
            got = fn(*args)
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append((args, repr(e)))
            return
        with lock:
            results.update(got)
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return results


# -- the port at four gloo ranks ------------------------------------------------


def _bundle(arch):
    """The port's smoke model under its full profile's rules."""
    return dataclasses.replace(get_arch(arch, smoke=True), sharding=get_arch(arch).sharding)


def _rules(bundle, shape, mesh):
    act, weights, _ = dryrun.build_rules(bundle, SHAPES[shape], mesh)
    return {**act, **weights}


def _whole(mesh, state, cfg):
    """(the dense tree and the AdamW moments gathered whole from the ranks'
    blocks, the token table gathered whole) as numpy, on every rank."""
    from repro_torch.distributed.checkpoint import _whole_leaves
    dense = interop.params_to_numpy(_whole_leaves(state["dense"], cfg))
    moments = {k: interop.params_to_numpy(_whole_leaves(state["opt_dense"][k], cfg))
               for k in ("m", "v")}
    table = mesh.all_gather(state["embed"]["table"], "model", 0)
    return dense, table.numpy().copy(), moments


def _replicated(state, cfg):
    """Every dense leaf and AdamW moment a rank holds whole, by path."""
    out = {}
    for key, tree in (("dense", state["dense"]), ("m", state["opt_dense"]["m"]),
                      ("v", state["opt_dense"]["v"])):
        tree_map_with_path(lambda path, x, key=key: out.__setitem__(
            f"{key}/{path}", x.numpy().copy())
            if not fsdp.held_dims(cfg, path, x.dim()) else None, tree)
    return out


def _held(state):
    """{path: local shape} of the dense params, their first moments and the
    token table."""
    out = {}
    for key in ("dense", "opt_dense", "embed"):
        tree_map_with_path(lambda path, x, key=key: out.__setitem__(
            f"{key}/{path}", tuple(x.shape)), state[key])
    return out


def _in_place(state):
    return {"dense": state["dense"], "m": state["opt_dense"]["m"],
            "v": state["opt_dense"]["v"], "embed": state["embed"]}


def _train_cases(mesh, inp, case):
    arch, _ = CASES[case]
    b = _bundle(arch)
    cfg = b.model
    rules = _rules(b, "train_4k", mesh)
    out = {}
    for schedule in SCHEDULES:
        norms = []
        with sharding.use_sharding(mesh, rules):
            p = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh,
                                      rules)
            state = train_loop.make_step_fns(cfg, _tc())[0](p)
            out.setdefault("held", _held(state))
            before = mesh.stats()
            state, losses = train_loop.train(
                cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"), STEPS,
                relaxed=schedule == "relaxed", state=state, device="cpu",
                on_metrics=lambda n, m, norms=norms: norms.append(float(m["grad_norm"])))
            moved = {k: v["calls"] - before.get(k, {}).get("calls", 0)
                     for k, v in mesh.stats().items()}
            out[schedule] = {"losses": np.asarray(losses), "norms": np.asarray(norms),
                             "whole": _whole(mesh, state, cfg),
                             "replicated": _replicated(state, cfg), "moved": moved}
    if case == "granite":
        with sharding.use_sharding(mesh, rules):
            p = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh,
                                      rules)
            batch = sharding.shard_batch(
                make_batches(cfg, B, S, seed=0, device="cpu").next(0), mesh, rules)
            out["saved_2d"], out["remat_thread"] = _one_loss_each_way(p, cfg, batch)
    return out


def _one_loss_each_way(params, cfg, batch):
    """The loss's gradients without remat and with it, each backward on a
    thread of its own as autograd runs a card's (the blocks' recompute
    gathers the held blocks again there): (the shapes of the 2-D tensors
    that autograd saves in the forward without remat, the held blocks and
    no gathered weight; whether the gradients with remat are bitwise those
    without)."""
    leaves = [x.requires_grad_() for k, v in params.items() if k != "embed"
              for x in tree_leaves(v)]
    shapes, grads = set(), {}

    def pack(t):
        if t.dim() == 2:
            shapes.add(tuple(t.shape))
        return t
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        with torch.autograd.graph.saved_tensors_hooks(
                pack if not remat else (lambda t: t), lambda t: t):
            loss = get_api(c).loss(params, c, batch)
        got = []
        worker = threading.Thread(target=lambda: got.append(
            torch.autograd.grad(loss, leaves)))
        worker.start()
        worker.join()
        grads[remat] = got[0] if got else None
    for x in leaves:
        x.requires_grad_(False)
    return shapes, grads[True] is not None and all(
        torch.equal(x, y) for x, y in zip(grads[True], grads[False], strict=True))


def _drill(mesh, inp, out_dir):
    """Granite at (2, 2): the writer crashes between step 2's undo COMMIT and
    its mirror apply (tier-M every step), recovery at every rank, one
    resumed step."""
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.pool import FaultSchedule, InjectedCrash
    arch = CASES["granite"][0]
    b = _bundle(arch)
    cfg = b.model
    rules = _rules(b, "train_4k", mesh)
    writer = mesh.axis_index(mesh.axis_names) == 0
    root = os.path.join(out_dir, "ck")
    out = {"ck_root": root}

    def fresh():
        p = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh, rules)
        return train_loop.make_step_fns(cfg, _tc())[0](p)
    with sharding.use_sharding(mesh, rules):
        state = fresh()
        cc = CheckpointConfig(directory=root, dense_interval=1, pool_backend="pmem")
        faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                        occurrence=CRASH_STEP + 1)
        mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                             faults=faults if writer else None)
        snap = {}

        def keep(n, _):
            if n == CRASH_STEP - 1:
                snap["state"] = {k: tree_map_with_path(lambda p, x: x.clone(), v)
                                 for k, v in _in_place(state).items()}
        crashed = False
        try:
            train_loop.train(cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"),
                             CRASH_STEP + 1, state=state, ckpt_manager=mgr, on_metrics=keep,
                             device="cpu")
        except InjectedCrash:
            crashed = True
            mgr.manager.pool.close()       # the writer's process death
        out["crashed"] = crashed
        rec_state, start, rec = recover_on_mesh(cfg, root, fresh())
        out["resume_at"] = start
        out["recovered_bitwise"] = all(
            torch.equal(a, b_) for k, v in _in_place(rec_state).items()
            for a, b_ in zip(tree_leaves(v), tree_leaves(snap["state"][k]), strict=True))
        out["recovered_shapes"] = all(
            a.shape == b_.shape for k, v in _in_place(rec_state).items()
            for a, b_ in zip(tree_leaves(v), tree_leaves(snap["state"][k]), strict=True))
        out["recovered_t"] = int(rec_state["opt_dense"]["t"])
        if writer:
            out["rec"] = (rec.mirror_step, rec.dense_step, rec.rolled_back)
        mgr2 = MeshCheckpoint(cfg, cc, pool=rec.pool if writer else None)
        mgr2.init_mirror(rec_state["embed"], step=start - 1)
        rec_state, tail = train_loop.train(
            cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"), 1, state=rec_state,
            start_step=start, ckpt_manager=mgr2, device="cpu")
        mgr2.close()
        out["resumed"] = np.asarray(tail)
        out["final_whole"] = _whole(mesh, rec_state, cfg)
    return out


def _serve(mesh, inp):
    """Granite at (2, 2) under its decode rules: prefill and NEW - 1 decode
    steps."""
    arch = CASES["granite"][0]
    b = _bundle(arch)
    cfg = b.model
    rules = _rules(b, "decode_32k", mesh)
    with sharding.use_sharding(mesh, rules), torch.no_grad():
        params = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh,
                                       rules)
        caches = get_api(cfg).init_cache(cfg, B, S + NEW, CPU)
        stats = {}
        prompt = make_batches(cfg, B, S, seed=0, device="cpu").next(0)["tokens"]
        toks = serve_loop.greedy_generate(cfg, params, prompt, NEW, stats=stats)
        return {"cache_heads": caches["k"].shape[3], "tokens": toks.numpy(),
                "logits": stats["logits"].numpy()}


def _inputs():
    """Each arch's params from the port's init, as numpy."""
    out = {}
    for arch in ARCHS:
        cfg = _bundle(arch).model
        gen = torch.Generator()
        gen.manual_seed(0)
        out[arch] = interop.params_to_numpy(get_api(cfg).init(gen, cfg))
    return out


def _torch_rank(rank, world, device, inp_path, out_dir):
    torch.set_num_threads(1)
    meshes = {2: pmesh.make_local_mesh(model_parallel=2, device=device),
              4: pmesh.make_local_mesh(model_parallel=4, device=device)}
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {"coords": {m: (mesh.coords["data"], mesh.coords["model"])
                      for m, mesh in meshes.items()}}
    for case, (_, (_, mp)) in CASES.items():
        out[case] = _train_cases(meshes[mp], inp, case)
    out["drill"] = _drill(meshes[2], inp, out_dir)
    out["serve"] = _serve(meshes[2], inp)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _one_rank(inp_path):
    """The port's one-rank strict runs: losses, gradient norms, params."""
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS:
            cfg = _bundle(arch).model
            norms = []
            state = train_loop.make_step_fns(cfg, _tc())[0](
                interop.params_from_numpy(inp[arch], CPU))
            state, losses = train_loop.train(
                cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"), STEPS,
                relaxed=False, state=state, device="cpu",
                on_metrics=lambda n_, m: norms.append(float(m["grad_norm"])))
            out[arch] = {"losses": np.asarray(losses), "norms": np.asarray(norms),
                         "dense": interop.params_to_numpy(state["dense"]),
                         "table": state["embed"]["table"].numpy().copy()}
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, [each rank's results], the port's one-rank runs): the
    inputs written, then the JAX subprocess, one spawn of four ranks and
    the one-rank runs here, all together."""
    d = tmp_path_factory.mktemp("fsdp")
    inp_path, jax_out = d / "inputs.pkl", d / "jax.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(_inputs(), f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, HERE]),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    jax_proc = subprocess.Popen([sys.executable, __file__, str(inp_path), str(jax_out)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    errors = []

    def spawn():
        try:
            pmesh.spawn(_torch_rank, WORLD, backend="gloo", device="cpu",
                        args=(str(inp_path), str(d)), timeout=TIMEOUT)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
    try:
        worker = threading.Thread(target=spawn)
        worker.start()
        one = _one_rank(inp_path)
        worker.join()
        log = jax_proc.communicate(timeout=300)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert not errors, errors
    assert jax_proc.returncode == 0, log
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks, one


def _close(got, want, what):
    """Every leaf within PARAM_MAX of its largest magnitude, the mean
    absolute difference within PARAM_MEAN of it."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w, strict=True):
        assert a.shape == b.shape, what
        scale = max(float(np.abs(b).max()), 1e-30)
        diff = np.abs(np.asarray(a, np.float64) - b)
        assert diff.max() <= PARAM_MAX * scale, (what, diff.max() / scale)
        assert diff.mean() <= PARAM_MEAN * scale, (what, diff.mean() / scale)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(runs, case, schedule):
    """Each rank reports the loss of the global batch, within rtol 2e-5 of
    the reference's sharded step's, and the ranks agree bitwise."""
    want, ranks, _ = runs
    ref = want[(case, schedule)]["losses"]
    for got in ranks:
        np.testing.assert_allclose(got[case][schedule]["losses"], ref, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got[case][schedule]["losses"],
                                      ranks[0][case][schedule]["losses"])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", list(CASES))
def test_params_match_jax(runs, case, schedule):
    """After 3 steps the dense params (gathered whole from the ranks' blocks)
    and the token table match the reference's sharded run's within
    PARAM_MAX / PARAM_MEAN of each leaf's largest magnitude: a gradient
    summed twice over ``data``, or never divided, would be off by 2."""
    want, ranks, _ = runs
    ref = want[(case, schedule)]
    for got in ranks:
        dense, table, _ = got[case][schedule]["whole"]
        _close(dense, ref["dense"], (case, "dense"))
        _close(table, ref["table"], (case, "table"))


@pytest.mark.parametrize("case", list(CASES))
def test_relaxed_equals_strict_bitwise(runs, case):
    """The relaxed schedule's losses, params and moments are the strict
    one's bit for bit, as on one rank."""
    _, ranks, _ = runs
    for got in ranks:
        np.testing.assert_array_equal(got[case]["relaxed"]["losses"],
                                      got[case]["strict"]["losses"])
        for a, b in zip(jax.tree.leaves(got[case]["relaxed"]["whole"]),
                        jax.tree.leaves(got[case]["strict"]["whole"]), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_grad_norm_is_the_one_rank_norm(runs, case):
    """The clipped global gradient norm each rank reports (the blocks'
    squares summed over the axes they lie over, the whole leaves counted
    once) is the port's one-rank norm within rtol 1e-5, the same on every
    rank; and the losses and params are the one-rank run's."""
    _, ranks, one = runs
    arch = CASES[case][0]
    for got in ranks:
        run = got[case]["strict"]
        np.testing.assert_allclose(run["norms"], one[arch]["norms"], rtol=NORM_RTOL)
        np.testing.assert_array_equal(run["norms"], ranks[0][case]["strict"]["norms"])
        np.testing.assert_allclose(run["losses"], one[arch]["losses"], rtol=LOSS_RTOL)
        dense, table, _ = run["whole"]
        _close(dense, one[arch]["dense"], (case, "dense"))
        _close(table, one[arch]["table"], (case, "table"))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_bitwise_across_ranks(runs, case, schedule):
    """After 3 steps every leaf and AdamW moment the ranks hold whole (the
    norms) is bitwise equal on every rank."""
    _, ranks, _ = runs
    reps = [r[case][schedule]["replicated"] for r in ranks]
    assert reps[0] and all(set(r) == set(reps[0]) for r in reps)
    assert all(re.search(r"norm", k) for k in reps[0]), sorted(reps[0])
    for r in reps[1:]:
        for k in reps[0]:
            np.testing.assert_array_equal(r[k], reps[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_jax_layout(runs, case):
    """Each rank holds the block of every leaf that the reference's sharded
    state puts on its device, the AdamW moments laid out like their params:
    under granite's fsdp profile at (2, 2) ``wq|wk|wv|wi|wg`` and
    ``lm_head`` as (data, model) blocks (``wk``/``wv`` too, though the one
    kv head is whole in the compute), both ``wo`` as (model, data) blocks;
    at (1, 4) the column and row blocks over ``model``; the token table by
    vocab over ``model``; the norms whole."""
    want, ranks, _ = runs
    _, (dp, mp) = CASES[case]
    specs = want[(case, "strict")]["specs"]
    w = "data" if case == "granite" else None
    expect = {
        "blocks/attn/wq": (None, w, "model"), "blocks/attn/wk": (None, w, "model"),
        "blocks/attn/wv": (None, w, "model"), "blocks/attn/wo": (None, "model", w),
        "blocks/mlp/wi": (None, w, "model"), "blocks/mlp/wo": (None, "model", w),
        "lm_head": (w, "model"), "final_norm": (None,)}
    for path, spec in expect.items():
        assert specs[f"dense/{path}"][1] == spec, (path, specs[f"dense/{path}"])
    assert specs["embed/table"][1][:1] == ("model",)
    sizes = {"data": dp, "model": mp}
    for got in ranks:
        held = got[case]["held"]
        for path, (shape, spec) in specs.items():
            if path.startswith("opt_dense/t"):
                continue
            local = tuple(d // sizes[ax] if ax else d
                          for d, ax in zip(shape, tuple(spec) + (None,) * len(shape),
                                           strict=False))
            assert held[path] == local, (path, held[path], local)


def test_strict_step_collectives(runs):
    """What one strict granite step moves at (2, 2), counted on each rank:
    each of a layer's 7 projections gathered once forward and once again
    backward (no gathered weight is saved) and its gradient reduce-scattered
    once; the head likewise, plus the recompute of its checkpointed chunk;
    SP's 2 sequence gathers and 2 reduce-scatters a layer each way, the
    head's gather and its reduce-scatter back, the rows' gather back; the
    sparse adjoint's ids and rows' gradients gathered over data; the token
    table gathered for the lookup (a rank's batch of 1 does not split over
    data, so the lookup takes the reference's table_gather route); the
    vocab-parallel loss's max and two sums (twice: the chunk is
    recomputed), the global token count, the partial norms' sum over model,
    the clip's sum over the blocks, the whole leaves' mean over data and
    the loss's."""
    _, ranks, _ = runs
    L = _bundle("granite-20b").model.num_layers
    for got in ranks:
        moved = {k: v for k, v in got["granite"]["strict"]["moved"].items() if v}
        per = {"all_gather": 2 * 7 * L + 3 + (2 * L + 1 + 2 * L + 1) + 2 + 1,
               "reduce_scatter": 7 * L + 1 + (2 * L + 2 * L + 1),
               "all_reduce_max": 2,
               "all_reduce_sum": 2 * 2 + 1 + 1 + 1 + 1 + 1}
        assert moved == {k: STEPS * v for k, v in per.items()}, moved


def test_no_gathered_weight_is_saved(runs):
    """Autograd saves the held blocks of granite's projections and head for
    the backward, never a gathered one: no 2-D tensor saved in the loss's
    forward has a leaf's compute-layout or whole shape."""
    _, ranks, _ = runs
    cfg = _bundle("granite-20b").model
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv, ff, V = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff, cfg.vocab_size
    gathered = {(d, q // 2), (d, kv), (q // 2, d), (d, ff // 2), (ff // 2, d), (d, V // 2),
                (d, q), (q, d), (d, ff), (ff, d), (d, V)}
    held = {(d // 2, q // 2), (d // 2, kv // 2), (q // 2, d // 2), (d // 2, ff // 2),
            (ff // 2, d // 2), (d // 2, V // 2)}
    for got in ranks:
        saved = got["granite"]["saved_2d"]
        assert not saved & gathered, sorted(saved & gathered)
        assert held <= saved, sorted(held - saved)


def test_remat_recompute_on_another_thread(runs):
    """Granite at (2, 2) with remat, its backward on a thread of its own:
    the recompute restores the sharding context, gathers the held blocks
    again in the same order on every rank, and the gradients are bitwise
    those without remat."""
    _, ranks, _ = runs
    assert all(got["granite"]["remat_thread"] for got in ranks)


def test_checkpoint_recovers_at_every_rank(runs):
    """The writer crashed between step 2's undo COMMIT and its mirror apply:
    recovery at all four ranks rolls back to step 1, each rank's blocks of
    the dense tree, its AdamW moments and the table bitwise those it held
    after step 1 (AdamW's step count 2), and the resumed step's loss within
    rtol 2e-5 of the uninterrupted run's step 2 (measured: bitwise)."""
    _, ranks, _ = runs
    r0 = ranks[0]["drill"]
    assert r0["crashed"] and r0["rec"] == (CRASH_STEP - 1, CRASH_STEP - 1, True)
    assert not any(r["drill"]["crashed"] for r in ranks[1:])
    full = ranks[0]["granite"]["relaxed"]["losses"]
    for got in ranks:
        dr = got["drill"]
        assert dr["resume_at"] == CRASH_STEP
        assert dr["recovered_shapes"] and dr["recovered_bitwise"]
        assert dr["recovered_t"] == CRASH_STEP
        np.testing.assert_allclose(dr["resumed"], full[CRASH_STEP:CRASH_STEP + 1],
                                   rtol=LOSS_RTOL)


def test_tier_m_blob_recovers_in_both_packages(runs):
    """After the resumed step, the tier-M blob the writer gathered whole from
    the four ranks' blocks reads back in the JAX package's
    ``recovery.recover`` and the port's into the one-rank tree: every dense
    leaf and AdamW moment bitwise the ranks' tree gathered whole after that
    step, and the mirror bitwise the table gathered whole."""
    from repro_torch.core.checkpoint import recovery
    _, ranks, _ = runs
    r0 = ranks[0]["drill"]
    dense, table, moments = r0["final_whole"]
    for rec in (jrecovery.recover(r0["ck_root"]), recovery.recover(r0["ck_root"])):
        assert (rec.mirror_step, rec.dense_step) == (CRASH_STEP, CRASH_STEP)
        for got, want in ((rec.dense["dense"], dense), (rec.dense["opt_dense"]["m"],
                                                        moments["m"]),
                          (rec.dense["opt_dense"]["v"], moments["v"])):
            got = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), got))
            assert len(got) == len(jax.tree.leaves(want))
            for a, b in zip(got, jax.tree.leaves(want), strict=True):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(rec.embed_rows), table)
        rec.pool.close()


def test_serving_matches_jax(runs):
    """Granite's prefill and 3 greedy decode steps at (2, 2) under its
    decode rules, each layer's blocks gathered a step: each rank's cache
    holds the one kv head over every position, the tokens equal the
    reference's, the logits within 1e-5 of its largest."""
    want, ranks, _ = runs
    ref = want["serve"]
    scale = float(np.abs(ref["logits"]).max())
    for got in ranks:
        sv = got["serve"]
        assert sv["cache_heads"] == 1
        np.testing.assert_array_equal(sv["tokens"], ref["tokens"])
        assert np.abs(sv["logits"] - ref["logits"]).max() <= LOGIT_TOL * scale


def test_rules_and_coords(runs):
    """The rules the ranks trained and served under are the reference's
    (activation rules, weight rules, dp axes), and the two meshes built in
    one spawn lay the ranks out as ``jax.make_mesh`` does."""
    want, ranks, _ = runs
    for case, (arch, shape) in CASES.items():
        mesh = pmesh.Mesh(pmesh.AXES, shape, {"data": 0, "model": 0})
        assert dryrun.build_rules(_bundle(arch), SHAPES["train_4k"], mesh) == \
            want[(case, "strict")]["rules"]
    mesh = pmesh.Mesh(pmesh.AXES, (2, 2), {"data": 0, "model": 0})
    assert dryrun.build_rules(_bundle("granite-20b"), SHAPES["decode_32k"], mesh)[:2] == \
        want["serve"]["rules"]
    for r, got in enumerate(ranks):
        assert got["coords"] == {2: (r // 2, r % 2), 4: (0, r)}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b", "llama3.2-3b",
                                  "granite-20b", "qwen3-moe-235b-a22b", "arctic-480b",
                                  "rwkv6-3b", "jamba-v0.1-52b", "qwen2-vl-7b",
                                  "whisper-base", "dlrm-rm1", "dlrm-rm2", "dlrm-rm3",
                                  "dlrm-rm4"])
def test_build_rules_match_jax(arch):
    """For every shape at (2, 2) and (1, 4), full size and smoke: the port's
    ``build_rules`` returns the reference's activation rules, weight rules
    and dp axes, or, exactly where the reference shards the kv sequence
    (query heads the model axis does not divide), raises naming 10(c)."""
    import types

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_arch as jget
    jax.devices()              # the backend up before the reference's dry run loads
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    assert set(ARCH_IDS) >= {arch}
    for smoke in (False, True):
        for shape in ((2, 2), (1, 4)):
            jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                          devices=np.empty(shape))
            mesh = pmesh.Mesh(pmesh.AXES, shape, {"data": 0, "model": 0})
            for name in SHAPES:
                want = jdry.build_rules(jget(arch, smoke=smoke), JSHAPES[name], jmesh)
                if want[0]["kv_seq"] is not None:
                    with pytest.raises(NotImplementedError, match=re.escape("10(c)")):
                        dryrun.build_rules(get_arch(arch, smoke=smoke), SHAPES[name], mesh)
                    continue
                assert dryrun.build_rules(get_arch(arch, smoke=smoke), SHAPES[name],
                                          mesh) == want, (arch, smoke, shape, name)


if __name__ == "__main__":
    jax.devices()             # the backend up with four devices first
    with open(sys.argv[1], "rb") as fin:
        inputs = pickle.load(fin)
    results = _jax_cases(inputs)
    with open(sys.argv[2], "wb") as fout:
        pickle.dump(results, fout)
