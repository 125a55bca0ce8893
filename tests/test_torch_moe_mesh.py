"""The port's MoE and mamba blocks trained, checkpointed and served under
their models' own profiles (FSDP, dense TP, Megatron-SP, experts over
``model``), against the JAX package's steps jitted under the same rules on
host devices, at the smoke sizes in f32:
  * qwen3-moe-235b-a22b, arctic-480b (its MoE and dense residual) and
    jamba-v0.1-52b (mamba, attention, MoE and dense FFNs) at (data, model)
    = (2, 2) under each profile's train rules: strict for all three,
    relaxed for qwen3-moe and jamba;
  * qwen3-moe at (1, 4): one expert a rank, its 2 kv heads replicated over
    4 model ranks, held against the port's one-rank run as well (a data
    group is the whole batch there, so the capacity is one rank's);
batch 2 x 16 tokens, 2 steps, AdamW (the default ``TrainConfig``, clip
1.0); then jamba at (2, 2): a crash drill with tier-M every step, recovery
at every rank, one resumed step; and qwen3-moe and jamba (its 8 layers,
two attention periods) served at (2, 2) under their decode rules (prefill
and 3 decode steps).

The params come from the port's init (a ``torch.Generator`` seeded 0),
written as numpy for both packages before anything starts; each rank keeps
its blocks (``sharding.shard_params`` with the rules). One module fixture
runs everything that needs more than one process, all started together:
one spawn of four gloo ranks on the CPU that builds both meshes
(``make_local_mesh(2)``, then ``make_local_mesh(4)``) and runs every case;
this file run as a script in a JAX subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, where the
reference's ``strict_step``, ``warmup`` and ``relaxed_step`` are jitted
with ``in_shardings`` and ``out_shardings`` = ``dryrun.state_shardings``
(jamba's stacked (G, nh) mamba leaves come back placed otherwise without
the latter, and the next call refuses them) under ``build_rules``, and
the served ids' prefill and decode with their params placed by
``param_specs`` and ``check_divisibility``; and the port's one-rank runs
here.

Tolerances, as ``tests/test_torch_fsdp.py``'s, each beside what was
measured here: losses within rtol 2e-5 of the reference's (measured
2.2e-7); the params after 2 steps within 2e-3 of each leaf's largest
magnitude (AdamW's first steps move an element whose gradient is near
zero by up to the learning rate on a rounding; measured 8.0e-4) and their
mean absolute difference within 1e-6 of it (measured 1.1e-7; mamba's
zero-initialised conv bias 1e-5, ``ZERO_INIT``); the load-balancing term
of a mesh step's first MoE layer within 1e-6 of the reference
``route``'s on the global batch's rows (measured 1.2e-7, one f32 ulp);
at (1, 4) every gradient gathered whole within 1e-5 of its largest
magnitude of the one-rank gradient's (measured 8.8e-7; with the
load-balancing term counted once a model rank, 4 times, the router's is
0.18 off); the served logits within 1e-5 of the largest (measured
1.2e-6), the tokens equal. Bitwise: relaxed against strict; every leaf and moment that
the ranks hold whole, across the ranks; the recovered blocks against the
ones the ranks held; the tier-M blob, read by either package, against the
ranks' tree gathered whole.
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
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, CheckpointConfig, TrainConfig
    from repro_torch.data.synthetic import make_batches
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models import moe
    from repro_torch.models.registry import get_api
    from repro_torch.training import serve_loop, train_loop
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    CPU = torch.device("cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
QWEN, ARCTIC, JAMBA = "qwen3-moe-235b-a22b", "arctic-480b", "jamba-v0.1-52b"
# case: (arch, (data, model), schedules)
CASES = {"qwen3moe": (QWEN, (2, 2), ("strict", "relaxed")),
         "arctic": (ARCTIC, (2, 2), ("strict",)),
         "jamba": (JAMBA, (2, 2), ("strict", "relaxed")),
         "qwen3moe_1x4": (QWEN, (1, 4), ("strict", "relaxed"))}
RUNS = [(c, s) for c, (_, _, ss) in CASES.items() for s in ss]
# the reference runs each case's strict steps, and the relaxed ones at (2, 2)
JAX_RUNS = [(c, s) for c, s in RUNS if s == "strict" or CASES[c][1] == (2, 2)]
SERVED = (QWEN, JAMBA)
ARCHS = (QWEN, ARCTIC, JAMBA)
B, S, STEPS, NEW = 2, 16, 2, 4
LOSS_RTOL, AUX_TOL, GRAD_TOL = 2e-5, 1e-6, 1e-5
PARAM_MAX, PARAM_MEAN = 2e-3, 1e-6
# mamba's conv bias starts at zero, so its every value is the two AdamW
# updates' sum: a step-2 update's ratio m / sqrt(v) moves with a gradient's
# last bits, and the mean difference is a larger share of the leaf's
# largest (measured 2.7e-6; the leaf's largest difference 3.3e-5)
ZERO_INIT, ZERO_INIT_MEAN = re.compile(r"mamba/conv_b$"), 1e-5
LOGIT_TOL = 1e-5
CRASH_STEP = 1          # the writer crashes between step 1's COMMIT and apply
WORLD, TIMEOUT = 4, 120


def _tc():
    return TrainConfig()


def _leaf_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _first_router(params, cfg):
    """The router of the first MoE layer of a param tree."""
    if "blocks" in params:
        return params["blocks"]["moe"]["router"][0]
    i = cfg.ffn_types.index("moe")
    return params["groups"][i]["moe"]["router"][0]


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
        arch, (_, mp), _ = CASES[case]
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
                step = jax.jit(relaxed_step, in_shardings=(st_sh, b_sh, b_sh),
                               out_shardings=(st_sh, None))
                for n in range(STEPS):
                    state, m = step(state, batches[n], batches[n + 1])
                    losses.append(float(m["loss"]))
            else:
                step = jax.jit(strict_step, in_shardings=(st_sh, b_sh),
                               out_shardings=(st_sh, None))
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

    def serve_case(arch):
        b = _jbundle(arch)
        cfg = b.model
        mesh = make_local_mesh(model_parallel=2)
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
        return {("serve", arch): {"tokens": np.asarray(jnp.stack(toks, axis=1)),
                                  "logits": np.asarray(jnp.stack(kept, axis=1)),
                                  "rules": (rules, wrules)}}

    def placement_fault():
        """Jamba's strict step at (2, 2) jitted with ``in_shardings`` alone,
        as the reference's dry run lowers it: (the dense leaves whose
        placement after one step differs from ``state_shardings``, what the
        second call raises)."""
        arch, (_, mp), _ = CASES["jamba"]
        b = _jbundle(arch)
        cfg = b.model
        mesh = make_local_mesh(model_parallel=mp)
        rules, wrules, dp = jdry.build_rules(b, JSHAPES["train_4k"], mesh)
        tc = JTrainConfig()
        strict_step = jtl.make_step_fns(cfg, tc)[1]
        data = jbatches(cfg, B, S, seed=0)
        batches = [{k: jnp.asarray(v) for k, v in data.next(n).items()} for n in range(2)]
        with jsh.use_sharding(mesh, rules):
            state = jstate.make_state(
                jax.tree.map(jnp.asarray, inputs[arch]),
                jopt.make_optimizer(tc.optimizer, tc.learning_rate, tc),
                jopt.make_optimizer(tc.embed_optimizer, tc.embed_learning_rate))
            st_sh = jdry.state_shardings(jax.eval_shape(lambda: state), wrules, mesh,
                                         dp, cfg)
            b_sh = jdry.batch_shardings(cfg, batches[0], mesh, dp)
            step = jax.jit(strict_step, in_shardings=(st_sh, b_sh))
            state, _ = step(jax.device_put(state, st_sh), batches[0])
            differ = sorted(
                _leaf_path(path) for (path, x), want in zip(
                    jax.tree_util.tree_flatten_with_path(state["dense"])[0],
                    jax.tree.leaves(st_sh["dense"]), strict=True)
                if not x.sharding.is_equivalent_to(want, x.ndim))
            try:
                step(state, batches[1])
                raised = None
            except Exception as e:      # noqa: BLE001 - what the reference raises
                raised = f"{type(e).__name__}: {e}"
        return {"placement_fault": {"differ": differ, "raised": raised}}

    jobs = [(train_case, r) for r in JAX_RUNS] + [(serve_case, (a,)) for a in SERVED] \
        + [(placement_fault, ())]
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
    """{path: local shape} of the dense params, their moments and the
    token table."""
    out = {}
    for key in ("dense", "opt_dense", "embed"):
        tree_map_with_path(lambda path, x, key=key: out.__setitem__(
            f"{key}/{path}", tuple(x.shape)), state[key])
    return out


def _in_place(state):
    return {"dense": state["dense"], "m": state["opt_dense"]["m"],
            "v": state["opt_dense"]["v"], "embed": state["embed"]}


def _fresh(mesh, inp, arch, rules):
    cfg = _bundle(arch).model
    p = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh, rules)
    return train_loop.make_step_fns(cfg, _tc())[0](p)


def _train_cases(mesh, inp, case):
    arch, _, schedules = CASES[case]
    cfg = _bundle(arch).model
    rules = _rules(_bundle(arch), "train_4k", mesh)
    out = {}
    for schedule in schedules:
        with sharding.use_sharding(mesh, rules), moe.recording() as rec:
            state = _fresh(mesh, inp, arch, rules)
            out.setdefault("held", _held(state))
            state, losses = train_loop.train(
                cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"), STEPS,
                relaxed=schedule == "relaxed", state=state, device="cpu")
            out[schedule] = {"losses": np.asarray(losses),
                             "whole": _whole(mesh, state, cfg),
                             "replicated": _replicated(state, cfg)}
            if schedule == "strict":      # step 0's first MoE layer
                out["aux0"] = (rec[0]["x"].detach().numpy().copy(),
                               float(rec[0]["aux"]))
    if mesh.shape == (1, 4):
        out["grads"] = _grads(mesh, inp, arch, rules)
    return out


def _grads(mesh, inp, arch, rules):
    """The dense gradients of step 0's loss as the trainer takes them on
    the mesh (summed over the partial axes, averaged over data) gathered
    whole, as numpy; without ``mesh``, the one-rank gradients."""
    import contextlib

    from repro_torch.distributed.checkpoint import _whole_leaves
    cfg = _bundle(arch).model
    batch = make_batches(cfg, B, S, seed=0, device="cpu").next(0)
    params = interop.params_from_numpy(inp[arch], CPU)
    with (contextlib.nullcontext() if mesh is None
          else sharding.use_sharding(mesh, rules)):
        if mesh is not None:
            params = sharding.shard_params(params, mesh, rules)
            batch = sharding.shard_batch(batch, mesh, rules)
        dense = {k: tree_map(lambda x: x.requires_grad_(), v)
                 for k, v in params.items() if k != "embed"}
        loss = get_api(cfg).loss({**dense, "embed": params["embed"]}, cfg, batch)
        it = iter(torch.autograd.grad(loss, tree_leaves(dense)))
        g = tree_map(lambda _: next(it).detach(), dense)
        if mesh is not None:
            train_loop.sync_dense_(g, loss.detach(), cfg)
            g = _whole_leaves(g, cfg)
    return interop.params_to_numpy(g)


def _drill(mesh, inp, out_dir):
    """Jamba at (2, 2): the writer crashes between step 1's undo COMMIT and
    its mirror apply (tier-M every step), recovery at every rank, one
    resumed step."""
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.pool import FaultSchedule, InjectedCrash
    cfg = _bundle(JAMBA).model
    rules = _rules(_bundle(JAMBA), "train_4k", mesh)
    writer = mesh.axis_index(mesh.axis_names) == 0
    root = os.path.join(out_dir, "ck")
    out = {"ck_root": root}
    with sharding.use_sharding(mesh, rules):
        state = _fresh(mesh, inp, JAMBA, rules)
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
        rec_state, start, rec = recover_on_mesh(cfg, root, _fresh(mesh, inp, JAMBA, rules))
        out["resume_at"] = start
        pairs = [(a, b_) for k, v in _in_place(rec_state).items()
                 for a, b_ in zip(tree_leaves(v), tree_leaves(snap["state"][k]), strict=True)]
        out["recovered_shapes"] = all(a.shape == b_.shape for a, b_ in pairs)
        out["recovered_bitwise"] = all(torch.equal(a, b_) for a, b_ in pairs)
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


def _serve(mesh, inp, arch):
    """Prefill and NEW - 1 decode steps at (2, 2) under the decode rules;
    the shapes of the caches a rank holds."""
    cfg = _bundle(arch).model
    rules = _rules(_bundle(arch), "decode_32k", mesh)
    with sharding.use_sharding(mesh, rules), torch.no_grad():
        params = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh,
                                       rules)
        caches = get_api(cfg).init_cache(cfg, B, S + NEW, CPU)
        stats = {}
        prompt = make_batches(cfg, B, S, seed=0, device="cpu").next(0)["tokens"]
        toks = serve_loop.greedy_generate(cfg, params, prompt, NEW, stats=stats)
        shapes = {}
        tree_map_with_path(lambda path, x: shapes.__setitem__(path, tuple(x.shape)),
                           caches)
        return {"cache_shapes": shapes, "tokens": toks.numpy(),
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
    for case, (_, (_, mp), _) in CASES.items():
        out[case] = _train_cases(meshes[mp], inp, case)
    out["drill"] = _drill(meshes[2], inp, out_dir)
    for arch in SERVED:
        out[("serve", arch)] = _serve(meshes[2], inp, arch)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _one_rank(inp_path):
    """The port's one-rank strict run of qwen3-moe and its step-0
    gradients."""
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _bundle(QWEN).model
        state = train_loop.make_step_fns(cfg, _tc())[0](
            interop.params_from_numpy(inp[QWEN], CPU))
        state, losses = train_loop.train(
            cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"), STEPS,
            relaxed=False, state=state, device="cpu")
        return {"losses": np.asarray(losses),
                "dense": interop.params_to_numpy(state["dense"]),
                "table": state["embed"]["table"].numpy().copy(),
                "grads": _grads(None, inp, QWEN, None)}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, [each rank's results], the port's one-rank run, the
    inputs): the inputs written, then the JAX subprocess, one spawn of four
    ranks and the one-rank run here, all together."""
    d = tmp_path_factory.mktemp("moe_mesh")
    inp_path, jax_out = d / "inputs.pkl", d / "jax.pkl"
    inputs = _inputs()
    with open(inp_path, "wb") as f:
        pickle.dump(inputs, f)
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
    return want, ranks, one, inputs


def _close(got, want, what, tol_max=PARAM_MAX, tol_mean=PARAM_MEAN):
    """Every leaf within ``tol_max`` of its largest magnitude, the mean
    absolute difference within ``tol_mean`` of it (``ZERO_INIT_MEAN`` for
    a leaf that starts at zero, where ``tol_mean`` is PARAM_MEAN)."""
    g = jax.tree.leaves(got)
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g) == len(w), what
    for a, (path, b) in zip(g, w, strict=True):
        assert a.shape == b.shape, what
        scale = max(float(np.abs(b).max()), 1e-30)
        diff = np.abs(np.asarray(a, np.float64) - b)
        mean = ZERO_INIT_MEAN if tol_mean == PARAM_MEAN and ZERO_INIT.search(
            _leaf_path(path)) else tol_mean
        assert diff.max() <= tol_max * scale, (what, path, diff.max() / scale)
        assert diff.mean() <= mean * scale, (what, path, diff.mean() / scale)


@pytest.mark.parametrize("case,schedule", JAX_RUNS)
def test_losses_match_jax(runs, case, schedule):
    """Each rank reports the loss of the global batch (the load-balancing
    term the global batch's), within rtol 2e-5 of the reference's sharded
    step's, and the ranks agree bitwise."""
    want, ranks, _, _ = runs
    ref = want[(case, schedule)]["losses"]
    for got in ranks:
        np.testing.assert_allclose(got[case][schedule]["losses"], ref, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got[case][schedule]["losses"],
                                      ranks[0][case][schedule]["losses"])


@pytest.mark.parametrize("case,schedule", JAX_RUNS)
def test_params_match_jax(runs, case, schedule):
    """After 2 steps the dense params (gathered whole from the ranks'
    blocks: the router, the experts, the mamba projections included) and
    the token table match the reference's sharded run's within PARAM_MAX /
    PARAM_MEAN of each leaf's largest magnitude: a gradient summed twice
    over ``model`` or ``data``, or never summed, would be off by 2."""
    want, ranks, _, _ = runs
    ref = want[(case, schedule)]
    for got in ranks:
        dense, table, _ = got[case][schedule]["whole"]
        _close(dense, ref["dense"], (case, schedule, "dense"))
        _close(table, ref["table"], (case, schedule, "table"))


@pytest.mark.parametrize("case", [c for c, (_, _, s) in CASES.items() if "relaxed" in s])
def test_relaxed_equals_strict_bitwise(runs, case):
    """The relaxed schedule's losses, params and moments are the strict
    one's bit for bit, as on one rank."""
    _, ranks, _, _ = runs
    for got in ranks:
        np.testing.assert_array_equal(got[case]["relaxed"]["losses"],
                                      got[case]["strict"]["losses"])
        for a, b in zip(jax.tree.leaves(got[case]["relaxed"]["whole"]),
                        jax.tree.leaves(got[case]["strict"]["whole"]), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case,schedule", RUNS)
def test_replicated_leaves_bitwise_across_ranks(runs, case, schedule):
    """After 2 steps every leaf and AdamW moment the ranks hold whole (the
    norms; jamba's conv and per-head leaves; at (1, 4) the router, whose
    embed dimension no data axis splits) is bitwise equal on every rank:
    their partial gradients summed over ``model`` once, the same on every
    rank."""
    _, ranks, _, _ = runs
    reps = [r[case][schedule]["replicated"] for r in ranks]
    assert reps[0] and all(set(r) == set(reps[0]) for r in reps)
    if CASES[case][0] == JAMBA:
        assert any(k.endswith("mamba/a_log") for k in reps[0]), sorted(reps[0])
    for r in reps[1:]:
        for k in reps[0]:
            np.testing.assert_array_equal(r[k], reps[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_jax_layout(runs, case):
    """Each rank holds the block of every leaf that the reference's sharded
    state puts on its device, the AdamW moments laid out like their params:
    the router (data, None), the experts (model, data, None), arctic's
    dense residual as an MLP, mamba's in_proj (data, model), out_proj
    (model, data), bc_proj and dt_proj (model, None) (at (1, 4) the data
    axis has one rank); the token table by vocab over ``model``."""
    want, ranks, _, _ = runs
    arch, (dp, mp), _ = CASES[case]
    specs = want[(case, "strict")]["specs"]
    w = "data"
    expect = {"blocks/moe/router": (None, w, None),
              "blocks/moe/wi": (None, "model", w, None),
              "blocks/moe/wo": (None, "model", None, w)}
    if arch == ARCTIC:
        expect.update({"blocks/moe/dense/wi": (None, w, "model"),
                       "blocks/moe/dense/wo": (None, "model", w)})
    if arch == JAMBA:
        expect = {"groups/0/mamba/in_proj": (None, w, "model"),
                  "groups/0/mamba/out_proj": (None, "model", w),
                  "groups/0/mamba/bc_proj": (None, "model", None),
                  "groups/0/mamba/dt_proj": (None, "model", None),
                  "groups/1/moe/router": (None, w, None),
                  "groups/1/moe/wi": (None, "model", w, None)}
    for path, spec in expect.items():
        assert specs[f"dense/{path}"][1] == spec, (path, specs[f"dense/{path}"])
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


@pytest.mark.parametrize("case", list(CASES))
def test_aux_is_the_global_batch_aux(runs, case):
    """The load-balancing term of step 0's first MoE layer, as each rank of
    a mesh step forms it from its data group's tokens (the probabilities'
    and counts' sums taken over ``data`` first), equals the reference
    ``route``'s over the global batch's rows (the ranks' rows in data
    order) within 1e-6, on every rank."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    _, ranks, _, inputs = runs
    arch, (dp, mp), _ = CASES[case]
    cfg = _bundle(arch).model
    x = np.concatenate([ranks[d * mp][case]["aux0"][0] for d in range(dp)])
    assert x.shape == (B * S, cfg.d_model)
    router = _first_router(inputs[arch], cfg)
    _, _, aux = jmoe.route(jnp.asarray(router), jnp.asarray(x), cfg.moe.top_k)
    for got in ranks:
        assert abs(got[case]["aux0"][1] - float(aux)) <= AUX_TOL, (
            got[case]["aux0"][1], float(aux))


def test_gradients_at_1x4_are_the_one_rank_gradients(runs):
    """At (1, 4) the batch is one data group, so step 0's gradients taken on
    the mesh (the router's partial sums over ``model`` once, its
    load-balancing part counted once, the experts' blocks, the column,
    row and vocab blocks) gathered whole equal the one-rank gradients
    within 1e-5 of each leaf's largest magnitude; the losses and params
    after 2 steps are the one-rank run's too."""
    _, ranks, one, _ = runs
    for got in ranks:
        run = got["qwen3moe_1x4"]
        _close(run["grads"], one["grads"], "grads", GRAD_TOL, GRAD_TOL)
        np.testing.assert_allclose(run["strict"]["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        dense, table, _ = run["strict"]["whole"]
        _close(dense, one["dense"], "dense")
        _close(table, one["table"], "table")


def test_checkpoint_recovers_at_every_rank(runs):
    """The writer crashed between step 1's undo COMMIT and its mirror apply:
    recovery at all four ranks rolls back to step 0, each rank's blocks of
    jamba's dense tree (the mamba projections' and the experts' blocks
    included), its AdamW moments and the table bitwise those it held after
    step 0 (AdamW's step count 1), and the resumed step's loss within rtol
    2e-5 of the uninterrupted run's step 1."""
    _, ranks, _, _ = runs
    r0 = ranks[0]["drill"]
    assert r0["crashed"] and r0["rec"] == (CRASH_STEP - 1, CRASH_STEP - 1, True)
    assert not any(r["drill"]["crashed"] for r in ranks[1:])
    full = ranks[0]["jamba"]["relaxed"]["losses"]
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
    _, ranks, _, _ = runs
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


@pytest.mark.parametrize("arch", SERVED)
def test_serving_matches_jax(runs, arch):
    """Prefill and 3 greedy decode steps at (2, 2) under the decode rules
    (the experts over model, each data group routed on its own): the
    tokens equal the reference's, the logits within 1e-5 of its largest;
    each rank's caches hold its kv head and, for jamba, its SSD heads'
    state (h over its 1 of 2 heads, the conv window over its 64 of 128
    channels), over every position."""
    want, ranks, _, _ = runs
    ref = want[("serve", arch)]
    cfg = _bundle(arch).model
    scale = float(np.abs(ref["logits"]).max())
    for got in ranks:
        sv = got[("serve", arch)]
        shapes = sv["cache_shapes"]
        if arch == JAMBA:
            di = cfg.mamba.d_inner(cfg.d_model)
            G = cfg.num_layers // cfg.attn_layer_period
            assert shapes["0/h"] == (G, B, di // 64 // 2, cfg.mamba.d_state, 64)
            assert shapes["0/conv"] == (G, B, cfg.mamba.d_conv - 1, di // 2)
            assert shapes["1/k"] == (G, B, S + NEW, cfg.num_kv_heads // 2,
                                     cfg.resolved_head_dim)
        else:
            assert shapes["k"] == (cfg.num_layers, B, S + NEW, cfg.num_kv_heads // 2,
                                   cfg.resolved_head_dim)
        np.testing.assert_array_equal(sv["tokens"], ref["tokens"])
        assert np.abs(sv["logits"] - ref["logits"]).max() <= LOGIT_TOL * scale


def test_jamba_state_placement_reference_refuses_port_runs(runs):
    """A fault of the reference's dry-run layout: jitted with its own
    ``state_shardings`` as ``in_shardings`` alone, jamba's strict step at
    (2, 2) hands back stacked mamba leaves that ``state_shardings`` keeps
    whole (the (G, nh) ``a_log``, the (G, di) ``conv_b``) placed over
    ``model``, and its second call refuses the state it was handed; the
    reference's steps run here with ``out_shardings`` too. The port runs
    jamba's steps at (2, 2) as they come, those leaves held whole and
    bitwise equal across the ranks."""
    want, ranks, _, _ = runs
    fault = want["placement_fault"]
    assert fault["raised"] is not None and "sharding" in fault["raised"].lower(), fault
    assert fault["differ"] and all(re.search(r"mamba/(a_log|dt_bias|d_skip|conv_[wb])$", p)
                                   for p in fault["differ"]), fault["differ"]
    for got in ranks:
        assert np.isfinite(got["jamba"]["strict"]["losses"]).all()
        reps = got["jamba"]["strict"]["replicated"]
        assert all(f"dense/{p}" in reps for p in fault["differ"])


def test_rules_and_coords(runs):
    """The rules the ranks trained and served under are the reference's
    (activation rules, weight rules, dp axes), and the two meshes built in
    one spawn lay the ranks out as ``jax.make_mesh`` does."""
    want, ranks, _, _ = runs
    for case, (arch, shape, _) in CASES.items():
        mesh = pmesh.Mesh(pmesh.AXES, shape, {"data": 0, "model": 0})
        assert dryrun.build_rules(_bundle(arch), SHAPES["train_4k"], mesh) == \
            want[(case, "strict")]["rules"]
    mesh = pmesh.Mesh(pmesh.AXES, (2, 2), {"data": 0, "model": 0})
    for arch in SERVED:
        assert dryrun.build_rules(_bundle(arch), SHAPES["decode_32k"], mesh)[:2] == \
            want[("serve", arch)]["rules"]
    for r, got in enumerate(ranks):
        assert got["coords"] == {2: (r // 2, r % 2), 4: (0, r)}


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_shape_is_every_dense_leaf(arch):
    """``fsdp.whole_shape`` gives the one-rank shape of every leaf that
    ``fsdp.is_dense_leaf`` names (``sharding.TP_LEAVES`` and the expert
    stacks), and it names every leaf that ``sharding.held_spec`` may
    block: the blocked set has one source."""
    cfg = _bundle(arch).model
    gen = torch.Generator().manual_seed(0)
    named = []

    def one(path, x):
        if fsdp.is_dense_leaf(path):
            named.append(path)
            assert fsdp.whole_shape(cfg, path, x.dim()) == tuple(x.shape), path
        else:
            assert not (sharding.is_tp_leaf(path) or sharding.is_expert_leaf(path)), path
            with pytest.raises(ValueError):
                fsdp.whole_shape(cfg, path, x.dim())
    tree_map_with_path(one, get_api(cfg).init(gen, cfg))
    assert any("moe/router" in p for p in named) and any(re.search(r"moe/wi$", p)
                                                         for p in named)


@pytest.mark.parametrize("case", ["rwkv6", "whisper", "jamba_ssd_heads"])
def test_refusals_that_stay(case):
    """Under a heads rule rwkv6-3b and whisper-base raise, naming ROADMAP
    item 10(c); jamba's smoke model under its profile's rules at (1, 4),
    where its 2 SSD heads do not split over 4 model ranks, raises in
    training and in serving."""
    mesh = pmesh.Mesh(pmesh.AXES, (1, 4), {"data": 0, "model": 0})
    if case == "jamba_ssd_heads":
        cfg = _bundle(JAMBA).model
        for kind in ("train_4k", "decode_32k"):
            with sharding.use_sharding(mesh, _rules(_bundle(JAMBA), kind, mesh)), \
                    pytest.raises(NotImplementedError, match="SSD heads do not split"):
                if kind == "train_4k":
                    train_loop.make_step_fns(cfg, _tc())
                else:
                    get_api(cfg).init_cache(cfg, B, S, CPU)
        return
    cfg = get_arch("rwkv6-3b" if case == "rwkv6" else "whisper-base", smoke=True).model
    with sharding.use_sharding(mesh, {"heads": "model"}), \
            pytest.raises(NotImplementedError, match=re.escape("10(c)")):
        train_loop.make_step_fns(cfg, _tc())


if __name__ == "__main__":
    jax.devices()             # the backend up with four devices first
    with open(sys.argv[1], "rb") as fin:
        inputs = pickle.load(fin)
    results = _jax_cases(inputs)
    with open(sys.argv[2], "wb") as fout:
        pickle.dump(results, fout)
