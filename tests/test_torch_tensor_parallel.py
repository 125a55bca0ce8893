"""The port's dense decoders trained and served under a ``data x model`` mesh
with dense tensor parallelism and the Megatron-SP residual stream
(``distributed/tensor_parallel.py``, ``launch/dryrun.py``'s ``build_rules``),
against the JAX package's steps jitted under the same rules on host devices,
at the smoke sizes in f32: tinyllama-1.1b, qwen3-0.6b (``qk_norm``) and
llama3.2-3b at (data, model) = (1, 2) under their profile's train rules
(heads, kv heads and the sequence over ``model``), and tinyllama at (2, 1);
batch 2 x 16 tokens, 3 steps, AdamW (the default ``TrainConfig``, clip 1.0).

The params come from the JAX package's init (``PRNGKey(0)``); the port
takes them through ``interop`` and each rank keeps its blocks
(``sharding.shard_params`` with the rules). One module fixture runs
everything that needs more than one process, all started together:
  * one spawn of two gloo ranks on the CPU per layout; each rank runs every
    case of its layout and writes its results;
  * this file run as a script in a JAX subprocess under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=2`` (it writes the
    inputs first; the ranks wait for them): for each case the reference's
    ``strict_step``, ``warmup`` and ``relaxed_step`` jitted with
    ``dryrun.state_shardings`` / ``batch_shardings`` (``param_specs`` and
    ``check_divisibility``) on ``make_local_mesh``, the rules from the
    reference's ``dryrun.build_rules`` (imported after the backend is up,
    so its 512-device ``XLA_FLAGS`` reaches no backend), on threads; and
    prefill plus 3 decode steps at (1, 2) under its decode rules, and the
    same for the served id with its head tied to the token table, under
    rules with no heads rule (the table's vocab rows over ``model``, the
    vocab-parallel head with every other leaf whole).
On the CPU the ranks' kernels are their plain versions (by the tensors'
device), as everywhere in the port. Without the fixture: every id's
``ShardingProfile`` and ``SHAPES`` against the reference's, and the
refusals (query heads the mesh does not divide, jamba's SSD heads that the
mesh does not divide under its fsdp profile's rules, the other families
under a ``heads`` rule, a ``seq`` rule alone). FSDP and kv heads the mesh does not divide are
``tests/test_torch_fsdp.py``'s.

Tolerances, each set from the measured difference: losses within rtol
2e-5 (``tests/test_relaxed.py``'s; measured 1.5e-7 from the reference's);
the gradient norms within rtol 1e-5 of the port's one-rank run's
(measured 1.2e-7; 2.1e-7 from the reference's); the params after 3 steps
within 2e-3 of each leaf's largest magnitude (AdamW's first steps divide
by the root of the squared gradient, so an element whose gradient is near
zero moves by up to the learning rate on a rounding; measured up to
3.4e-4 from the reference's, 2.8e-4 from the port's one-rank run) and
the mean absolute difference within 1e-6 of it (measured 8.5e-8); the
served logits within 1e-5 of the largest (measured 4.0e-7), the tokens
equal. Bitwise: every replicated leaf across the ranks; relaxed against
strict at each layout; the recovered blocks against the ones the ranks
held; the tier-M blob, read by either package, against the ranks' tree
gathered whole; remat's recompute on another thread against no remat.
"""
import os
import pickle
import re
import subprocess
import sys
import threading
import time

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
    from repro_torch.distributed import sharding, tensor_parallel
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models.registry import get_api
    from repro_torch.training import serve_loop, train_loop
    from repro_torch.tree import tree_map_with_path

    CPU = torch.device("cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCHS = ("tinyllama-1.1b", "qwen3-0.6b", "llama3.2-3b")
LAYOUTS = {"1x2": ((1, 2), ARCHS), "2x1": ((2, 1), ("tinyllama-1.1b",))}
CASES = [(lay, a) for lay, (_, archs) in LAYOUTS.items() for a in archs]
SCHEDULES = ("strict", "relaxed")
B, S, STEPS, NEW = 2, 16, 3, 4
LOSS_RTOL, NORM_RTOL = 2e-5, 1e-5
PARAM_MAX, PARAM_MEAN = 2e-3, 1e-6
LOGIT_TOL = 1e-5
CRASH_STEP = 2          # the writer crashes between step 2's COMMIT and apply
SERVED = "tinyllama-1.1b"
TIED = "tied"           # SERVED with its head tied to the token table
TIED_RULES = {"batch": None}     # no heads rule: the vocab rows over model alone
TIMEOUT = 120


def _bundle(arch):
    return get_arch(arch, smoke=True)


def _tied(cfg):
    return cfg.replace(tie_embeddings=True)


def _tc():
    return TrainConfig()


# -- the JAX package on two host devices (run as a script) ----------------------


def _jax_inputs():
    """Each arch's params from the reference's init at ``PRNGKey(0)`` (the
    inits compiled on threads)."""
    from repro.configs import get_arch as jget
    from repro.models.registry import get_api as jget_api
    out = {}

    def init(arch):
        cfg = _tied(jget(SERVED, smoke=True).model) if arch == TIED \
            else jget(arch, smoke=True).model
        params = jax.jit(lambda k: jget_api(cfg).init(k, cfg))(jax.random.PRNGKey(0))
        out[arch] = jax.tree.map(np.asarray, params)
    threads = [threading.Thread(target=init, args=(a,)) for a in (*ARCHS, TIED)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(out) == {*ARCHS, TIED}
    return out


def _jax_cases(inputs):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_arch as jget
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data.synthetic import make_batches as jbatches
    from repro.distributed import sharding as jsh
    from repro.launch.mesh import make_local_mesh
    from repro.optim import optimizers as jopt
    from repro.training import serve_loop as jserve
    from repro.training import state as jstate
    from repro.training import train_loop as jtl
    assert jax.device_count() == 2, jax.devices()
    from repro.launch import dryrun as jdry   # its XLA_FLAGS reach no backend now

    def train_case(layout, arch, schedule):
        shape, _ = LAYOUTS[layout]
        b = jget(arch, smoke=True)
        cfg = b.model
        mesh = make_local_mesh(model_parallel=shape[1])
        rules, wrules, dp = jdry.build_rules(b, JSHAPES["train_4k"], mesh)
        tc = JTrainConfig()
        _, strict_step, relaxed_step, warmup = jtl.make_step_fns(cfg, tc)
        data = jbatches(cfg, B, S, seed=0)
        batches = [{k: jnp.asarray(v) for k, v in data.next(n).items()}
                   for n in range(STEPS + 1)]
        with jsh.use_sharding(mesh, rules):
            # init_fn's state at PRNGKey(0), from its params drawn once
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
            losses, norms = [], []
            if schedule == "relaxed":
                step = jax.jit(relaxed_step, in_shardings=(st_sh, b_sh, b_sh))
                for n in range(STEPS):
                    state, m = step(state, batches[n], batches[n + 1])
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            else:
                step = jax.jit(strict_step, in_shardings=(st_sh, b_sh))
                for n in range(STEPS):
                    state, m = step(state, batches[n])
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
        specs = {}          # the placement the steps were jitted with
        for key in ("dense", "opt_dense", "embed"):
            for path, x in jax.tree_util.tree_flatten_with_path(state[key])[0]:
                name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                sh = st_sh[key]
                for k in path:
                    sh = sh[getattr(k, "key", getattr(k, "idx", None))]
                specs[f"{key}/{name}"] = (tuple(x.shape), tuple(sh.spec))
        return {(layout, arch, schedule): {
            "losses": np.asarray(losses), "norms": np.asarray(norms), "specs": specs,
            "rules": rules,
            "dense": jax.tree.map(np.asarray, state["dense"]),
            "table": np.asarray(state["embed"]["table"])}}

    def serve_case(key):
        b = jget(SERVED, smoke=True)
        cfg = b.model
        mesh = make_local_mesh(model_parallel=2)
        if key == TIED:
            cfg, rules, wrules = _tied(cfg), TIED_RULES, None
        else:
            rules, wrules, _ = jdry.build_rules(b, JSHAPES["decode_32k"], mesh)
        prefill_step, decode_step, init_cache = jserve.make_serve_fns(cfg)
        prompt = jnp.asarray(jbatches(cfg, B, S, seed=0).next(0)["tokens"])
        with jsh.use_sharding(mesh, rules):
            params = jax.tree.map(jnp.asarray, inputs[SERVED if key == "serve" else TIED])
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
        return {key: {"tokens": np.asarray(jnp.stack(toks, axis=1)),
                          "logits": np.asarray(jnp.stack(kept, axis=1)),
                          "rules": rules}}

    jobs = [(train_case, (lay, a, s)) for lay, a in CASES for s in SCHEDULES]
    jobs += [(serve_case, ("serve",)), (serve_case, (TIED,))]
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


# -- the port at gloo ranks -----------------------------------------------------


def _whole(mesh, state, cfg):
    """(the dense tree gathered whole from the ranks' blocks, the token table
    gathered whole) as numpy, on every rank (under the context)."""
    from repro_torch.distributed.checkpoint import _whole_leaves
    dense = interop.params_to_numpy(_whole_leaves(state["dense"], cfg))
    table = mesh.all_gather(state["embed"]["table"], "model", 0)
    return dense, table.numpy().copy()


def _replicated(state):
    """Every dense leaf a rank holds whole, by path, as numpy."""
    out = {}
    tree_map_with_path(lambda path, x: out.__setitem__(path, x.numpy().copy())
                       if not sharding.is_tp_leaf(path) else None, state["dense"])
    return out


def _held(state):
    """{path: local shape} of the dense params, their first moments and the
    token table."""
    out = {}
    for key in ("dense", "opt_dense", "embed"):
        tree_map_with_path(lambda path, x, key=key: out.__setitem__(
            f"{key}/{path}", tuple(x.shape)), state[key])
    return out


def _rank_cases(mesh, inp, out_dir, layout, archs):
    from repro_torch.distributed.checkpoint import MeshCheckpoint, recover_on_mesh
    from repro_torch.pool import FaultSchedule, InjectedCrash
    out = {"coords": (mesh.coords["data"], mesh.coords["model"])}
    writer = mesh.axis_index(mesh.axis_names) == 0

    def fresh(cfg, rules, arch):
        p = sharding.shard_params(interop.params_from_numpy(inp[arch], CPU), mesh, rules)
        return train_loop.make_step_fns(cfg, _tc())[0](p)

    for arch in archs:
        b = _bundle(arch)
        cfg = b.model
        rules, _, _ = dryrun.build_rules(b, SHAPES["train_4k"], mesh)
        for schedule in SCHEDULES:
            norms = []
            with sharding.use_sharding(mesh, rules):
                state = fresh(cfg, rules, arch)
                out.setdefault(("held", arch), _held(state))
                before = mesh.stats()
                state, losses = train_loop.train(
                    cfg, _tc(), make_batches(cfg, B, S, seed=0, device="cpu"), STEPS,
                    relaxed=schedule == "relaxed", state=state, device="cpu",
                    on_metrics=lambda n, m, norms=norms: norms.append(float(m["grad_norm"])))
                moved = {k: v["calls"] - before.get(k, {}).get("calls", 0)
                         for k, v in mesh.stats().items()}
                out[(arch, schedule)] = {"losses": np.asarray(losses),
                                         "norms": np.asarray(norms),
                                         "whole": _whole(mesh, state, cfg),
                                         "replicated": _replicated(state),
                                         "moved": moved}
    if layout != "1x2":
        return out

    # remat's recompute on a thread of its own, as autograd runs a card's
    # backward: the gradients of the loss without remat
    b = _bundle("tinyllama-1.1b")
    rules, _, _ = dryrun.build_rules(b, SHAPES["train_4k"], mesh)
    batch = make_batches(b.model, B, S, seed=0, device="cpu").next(0)
    grads = {}
    with sharding.use_sharding(mesh, rules):
        whole = interop.params_from_numpy(inp[b.model.name], CPU)
        params = sharding.shard_params(whole, mesh, rules)
        for remat in (False, True):
            cfg = b.model.replace(remat=remat)
            leaves = [x.requires_grad_() for k, v in params.items() if k != "embed"
                      for x in _leaves(v)]
            loss = get_api(cfg).loss(params, cfg, batch)
            got = []
            worker = threading.Thread(target=lambda: got.append(
                torch.autograd.grad(loss, leaves)))
            worker.start()
            worker.join()
            grads[remat] = got[0] if got else None
    out["remat_thread"] = grads[True] is not None and all(
        torch.equal(x, y) for x, y in zip(grads[True], grads[False], strict=True))

    # the LM checkpoint through the one writer: crash between step 2's undo
    # COMMIT and its mirror apply, recovery at both ranks, one resumed step
    b = _bundle("tinyllama-1.1b")
    cfg = b.model
    rules, _, _ = dryrun.build_rules(b, SHAPES["train_4k"], mesh)
    root = os.path.join(out_dir, "ck")
    out["ck_root"] = root
    with sharding.use_sharding(mesh, rules):
        state = fresh(cfg, rules, cfg.name)
        cc = CheckpointConfig(directory=root, dense_interval=1, pool_backend="pmem")
        faults = FaultSchedule.crash_at("tier_e.between-commit-and-apply",
                                        occurrence=CRASH_STEP + 1)
        mgr = MeshCheckpoint(cfg, cc, embed_init=state["embed"],
                             faults=faults if writer else None)
        snap = {}

        def keep(n, _):
            if n == CRASH_STEP - 1:
                # (updated in place; the step count ``t`` is a new tensor a step)
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
        rec_state, start, rec = recover_on_mesh(cfg, root, fresh(cfg, rules, cfg.name))
        out["resume_at"] = start
        out["recovered_bitwise"] = all(
            torch.equal(a, b_) for k, v in _in_place(rec_state).items()
            for a, b_ in zip(_leaves(v), _leaves(snap["state"][k]), strict=True))
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

    # serving: prefill and NEW - 1 decode steps under the decode rules
    b = _bundle(SERVED)
    cfg = b.model
    rules, _, _ = dryrun.build_rules(b, SHAPES["decode_32k"], mesh)
    with sharding.use_sharding(mesh, rules), torch.no_grad():
        params = sharding.shard_params(interop.params_from_numpy(inp[SERVED], CPU), mesh,
                                       rules)
        caches = get_api(cfg).init_cache(cfg, B, S + NEW, CPU)
        out["cache_heads"] = caches["k"].shape[3]
        stats = {}
        prompt = make_batches(cfg, B, S, seed=0, device="cpu").next(0)["tokens"]
        out["serve"] = {"tokens": serve_loop.greedy_generate(cfg, params, prompt, NEW,
                                                             stats=stats).numpy(),
                        "logits": stats["logits"].numpy()}

    # the tied head over the rank's vocab block of the table, no heads rule
    cfg = _tied(cfg)
    with sharding.use_sharding(mesh, TIED_RULES), torch.no_grad():
        params = sharding.shard_params(interop.params_from_numpy(inp[TIED], CPU), mesh,
                                       TIED_RULES)
        out["tied_held"] = {"table": tuple(params["embed"]["table"].shape),
                            "wq": tuple(params["blocks"]["attn"]["wq"].shape),
                            "lm_head": "lm_head" in params}
        stats = {}
        prompt = make_batches(cfg, B, S, seed=0, device="cpu").next(0)["tokens"]
        out[TIED] = {"tokens": serve_loop.greedy_generate(cfg, params, prompt, NEW,
                                                          stats=stats).numpy(),
                     "logits": stats["logits"].numpy()}
    return out


def _in_place(state):
    """The parts of a train state that the steps update in place: the dense
    params, the AdamW moments and the token table."""
    return {"dense": state["dense"], "m": state["opt_dense"]["m"],
            "v": state["opt_dense"]["v"], "embed": state["embed"]}


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _torch_rank(rank, world, device, layout, inp_path, out_dir):
    torch.set_num_threads(1)
    deadline = time.monotonic() + 180
    while not os.path.exists(inp_path):
        assert time.monotonic() < deadline, f"no {inp_path} from the JAX subprocess"
        time.sleep(0.1)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    (_, mp), archs = LAYOUTS[layout]
    mesh = pmesh.make_local_mesh(model_parallel=mp, device=device)
    out = _rank_cases(mesh, inp, out_dir, layout, archs)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _one_rank(inp_path):
    """The port's one-rank strict runs: losses and gradient norms."""
    deadline = time.monotonic() + 180
    while not os.path.exists(inp_path):
        assert time.monotonic() < deadline, f"no {inp_path} from the JAX subprocess"
        time.sleep(0.1)
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
    """(JAX results, {layout: [rank 0's, rank 1's]}, the port's one-rank
    runs): the JAX subprocess (which makes the inputs first), one spawn a
    layout and the one-rank runs here, all together."""
    d = tmp_path_factory.mktemp("tensor-parallel")
    inp_path, jax_out = d / "inputs.pkl", d / "jax.pkl"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, HERE]),
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    jax_proc = subprocess.Popen([sys.executable, __file__, str(inp_path), str(jax_out)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    errors = {}

    def spawn(layout):
        try:
            os.makedirs(d / layout, exist_ok=True)
            pmesh.spawn(_torch_rank, 2, backend="gloo", device="cpu",
                        args=(layout, str(inp_path), str(d / layout)), timeout=TIMEOUT)
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
    for layout in LAYOUTS:
        ranks[layout] = []
        for r in range(2):
            with open(d / layout / f"rank{r}.pkl", "rb") as f:
                ranks[layout].append(pickle.load(f))
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
@pytest.mark.parametrize("layout,arch", CASES)
def test_losses_match_jax(runs, layout, arch, schedule):
    """Each rank reports the loss of the global batch, within rtol 2e-5 of
    the reference's sharded step's (strict; relaxed after its warm-up), and
    the ranks agree bitwise."""
    want, ranks, _ = runs
    ref = want[(layout, arch, schedule)]["losses"]
    for got in ranks[layout]:
        np.testing.assert_allclose(got[(arch, schedule)]["losses"], ref, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got[(arch, schedule)]["losses"],
                                      ranks[layout][0][(arch, schedule)]["losses"])


@pytest.mark.parametrize("layout,arch", CASES)
def test_relaxed_equals_strict_bitwise(runs, layout, arch):
    """At each layout the relaxed schedule's losses and params are the
    strict one's bit for bit, as on one rank."""
    _, ranks, _ = runs
    for got in ranks[layout]:
        np.testing.assert_array_equal(got[(arch, "relaxed")]["losses"],
                                      got[(arch, "strict")]["losses"])
        for a, b in zip(jax.tree.leaves(got[(arch, "relaxed")]["whole"]),
                        jax.tree.leaves(got[(arch, "strict")]["whole"]), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout,arch", CASES)
def test_params_match_jax(runs, layout, arch, schedule):
    """After 3 steps the dense params (gathered whole from the ranks'
    blocks) and the token table match the reference's sharded run's within
    PARAM_MAX / PARAM_MEAN of each leaf's largest magnitude."""
    want, ranks, _ = runs
    ref = want[(layout, arch, schedule)]
    for got in ranks[layout]:
        dense, table = got[(arch, schedule)]["whole"]
        _close(dense, ref["dense"], (arch, "dense"))
        _close(table, ref["table"], (arch, "table"))


@pytest.mark.parametrize("layout,arch", CASES)
def test_grad_norm_is_the_one_rank_norm(runs, layout, arch):
    """The clipped global gradient norm each rank reports (its blocks'
    squares summed over ``model``, the replicated leaves counted once) is
    the port's one-rank norm within rtol 1e-5 and the reference's within
    rtol 2e-5, the same on both ranks."""
    want, ranks, one = runs
    for got in ranks[layout]:
        norms = got[(arch, "strict")]["norms"]
        np.testing.assert_allclose(norms, one[arch]["norms"], rtol=NORM_RTOL)
        np.testing.assert_allclose(norms, want[(layout, arch, "strict")]["norms"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(norms, ranks[layout][0][(arch, "strict")]["norms"])


@pytest.mark.parametrize("layout,arch", CASES)
def test_layouts_agree_with_one_rank(runs, layout, arch):
    """The port's two-rank params after 3 strict steps against its one-rank
    run's, at PARAM_MAX / PARAM_MEAN, and the losses at rtol 2e-5."""
    _, ranks, one = runs
    for got in ranks[layout]:
        dense, table = got[(arch, "strict")]["whole"]
        _close(dense, one[arch]["dense"], (arch, "dense"))
        _close(table, one[arch]["table"], (arch, "table"))
        np.testing.assert_allclose(got[(arch, "strict")]["losses"], one[arch]["losses"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout,arch", CASES)
def test_replicated_leaves_bitwise_across_ranks(runs, layout, arch, schedule):
    """After 3 steps every leaf the ranks hold whole (the norms, qwen3's q/k
    norms, and at (2, 1) every leaf) is bitwise equal on both ranks."""
    _, ranks, _ = runs
    a, b = (r[(arch, schedule)]["replicated"] for r in ranks[layout])
    assert set(a) == set(b) and a
    if layout == "1x2" and _bundle(arch).model.qk_norm:
        assert any(k.endswith("q_norm") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout,arch", CASES)
def test_each_rank_holds_the_jax_layout(runs, layout, arch):
    """Each rank holds the block of every leaf that the reference's sharded
    state puts on its device: ``wq|wk|wv|wi|wg`` by columns, both ``wo`` by
    rows, ``lm_head`` and the token table by vocab, the norms whole, and the
    AdamW moments laid out like their params (the reference's specs, each
    ``model`` dimension halved at (1, 2))."""
    want, ranks, _ = runs
    specs = want[(layout, arch, "strict")]["specs"]
    n = LAYOUTS[layout][0][1]
    expect = {
        "blocks/attn/wq": (None, None, "model"), "blocks/attn/wo": (None, "model", None),
        "blocks/mlp/wi": (None, None, "model"), "blocks/mlp/wo": (None, "model", None),
        "lm_head": (None, "model"), "final_norm": (None,)}
    for path, spec in expect.items():
        assert specs[f"dense/{path}"][1] == spec, (path, specs[f"dense/{path}"])
    assert specs["embed/table"][1][:1] == ("model",)
    for got in ranks[layout]:
        held = got[("held", arch)]
        for path, (shape, spec) in specs.items():
            if path.startswith("opt_dense/t"):
                continue
            local = tuple(d // n if ax == "model" else d
                          for d, ax in zip(shape, tuple(spec) + (None,) * len(shape),
                                           strict=False))
            assert held[path] == local, (path, held[path], local)


def test_rules_match_jax(runs):
    """The port's ``build_rules`` gives the reference's activation rules at
    each case (train) and for serving (decode at batch 2)."""
    want, _, _ = runs
    for layout, arch in CASES:
        (d, m), _ = LAYOUTS[layout]
        mesh = pmesh.Mesh(pmesh.AXES, (d, m), {"data": 0, "model": 0})
        rules, _, _ = dryrun.build_rules(_bundle(arch), SHAPES["train_4k"], mesh)
        assert rules == want[(layout, arch, "strict")]["rules"]
    mesh = pmesh.Mesh(pmesh.AXES, (1, 2), {"data": 0, "model": 0})
    rules, _, _ = dryrun.build_rules(_bundle(SERVED), SHAPES["decode_32k"], mesh)
    assert rules == want["serve"]["rules"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b", "llama3.2-3b",
                                  "granite-20b", "qwen3-moe-235b-a22b", "arctic-480b",
                                  "rwkv6-3b", "jamba-v0.1-52b", "qwen2-vl-7b",
                                  "whisper-base", "dlrm-rm1", "dlrm-rm4"])
def test_sharding_profiles_match_jax(arch, smoke):
    """Each id's ``ShardingProfile`` (full and smoke) is the reference's,
    field by field, and ``SHAPES`` are its cells: ``build_rules`` reads
    them."""
    import dataclasses

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_arch as jget
    assert dataclasses.asdict(get_arch(arch, smoke=smoke).sharding) == \
        dataclasses.asdict(jget(arch, smoke=smoke).sharding)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def test_strict_step_collectives(runs):
    """What one strict tinyllama step moves at (1, 2) under SP, counted on
    each rank: per layer 2 sequence gathers and 2 reduce-scatters forward
    and the same backward (no remat at the smoke size); the head's gather
    and its reduce-scatter back; the rows' gather back; the vocab-parallel
    loss's max and two sums, twice (the chunk is recomputed in the
    backward); the lookup's near-data sum, the partial norms' sum and the
    clip's sum."""
    _, ranks, _ = runs
    L = _bundle("tinyllama-1.1b").model.num_layers
    for got in ranks["1x2"]:
        moved = {k: v for k, v in got[("tinyllama-1.1b", "strict")]["moved"].items() if v}
        per = {"all_gather": 2 * L + 1 + 1 + 2 * L,
               "reduce_scatter": 2 * L + 2 * L + 1,
               "all_reduce_max": 2,
               "all_reduce_sum": 2 * 2 + 1 + 1 + 1}
        assert moved == {k: STEPS * v for k, v in per.items()}, moved


def test_checkpoint_recovers_at_two_ranks(runs):
    """The writer crashed between step 2's undo COMMIT and its mirror
    apply: recovery at both ranks rolls back to step 1, each rank's blocks of
    the dense tree, its AdamW moments and the table bitwise those it held
    after step 1 (and AdamW's step count 2), and the resumed step's loss within rtol 2e-5 of the
    uninterrupted run's step 2 (measured: bitwise)."""
    _, ranks, _ = runs
    r0 = ranks["1x2"][0]
    assert r0["crashed"] and r0["rec"] == (CRASH_STEP - 1, CRASH_STEP - 1, True)
    assert not ranks["1x2"][1]["crashed"]
    full = r0[("tinyllama-1.1b", "relaxed")]["losses"]
    for got in ranks["1x2"]:
        assert got["resume_at"] == CRASH_STEP and got["recovered_bitwise"]
        assert got["recovered_t"] == CRASH_STEP      # AdamW's step count at step 1
        np.testing.assert_allclose(got["resumed"], full[CRASH_STEP:CRASH_STEP + 1],
                                   rtol=LOSS_RTOL)


def test_tier_m_blob_recovers_in_both_packages(runs):
    """After the resumed step, the tier-M blob the writer gathered whole from
    the ranks' blocks reads back in the JAX package's ``recovery.recover``
    and the port's into the one-rank tree: every dense leaf bitwise the
    ranks' tree gathered whole after that step, and the mirror bitwise the
    table gathered whole."""
    from repro_torch.core.checkpoint import recovery
    _, ranks, _ = runs
    r0 = ranks["1x2"][0]
    dense, table = r0["final_whole"]
    for rec in (jrecovery.recover(r0["ck_root"]), recovery.recover(r0["ck_root"])):
        assert (rec.mirror_step, rec.dense_step) == (CRASH_STEP, CRASH_STEP)
        got = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                           rec.dense["dense"]))
        assert len(got) == len(jax.tree.leaves(dense))
        for a, b in zip(got, jax.tree.leaves(dense), strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(rec.embed_rows), table)
        rec.pool.close()


def test_remat_recompute_on_another_thread(runs):
    """With remat, the blocks' recompute runs where autograd runs the
    backward, a thread of its own on a card: it restores the forward's
    sharding context, and the gradients at (1, 2) are bitwise those
    without remat."""
    _, ranks, _ = runs
    assert all(got["remat_thread"] for got in ranks["1x2"])


def test_serving_matches_jax(runs):
    """Prefill and 3 greedy decode steps at (1, 2) under the decode rules:
    each rank holds 1 of the 2 kv heads over every position, the tokens
    equal the reference's, the logits within 1e-5 of its largest."""
    want, ranks, _ = runs
    ref = want["serve"]
    scale = float(np.abs(ref["logits"]).max())
    for got in ranks["1x2"]:
        assert got["cache_heads"] == _bundle(SERVED).model.num_kv_heads // 2
        np.testing.assert_array_equal(got["serve"]["tokens"], ref["tokens"])
        assert np.abs(got["serve"]["logits"] - ref["logits"]).max() <= LOGIT_TOL * scale


def test_tied_head_over_a_vocab_block_serves_as_jax(runs):
    """The served id with its head tied to the token table, at (1, 2) under
    rules with no heads rule: each rank holds its vocab block of the table
    (the head's columns) and every dense leaf whole; prefill and 3 greedy
    decode steps through the vocab-parallel head give the reference's
    tokens, the logits within 1e-5 of its largest."""
    want, ranks, _ = runs
    ref = want[TIED]
    scale = float(np.abs(ref["logits"]).max())
    cfg = _bundle(SERVED).model
    for got in ranks["1x2"]:
        assert got["tied_held"] == {"table": (cfg.vocab_size // 2, cfg.d_model),
                                    "wq": (cfg.num_layers, cfg.d_model,
                                           cfg.num_heads * cfg.resolved_head_dim),
                                    "lm_head": False}
        np.testing.assert_array_equal(got[TIED]["tokens"], ref["tokens"])
        assert np.abs(got[TIED]["logits"] - ref["logits"]).max() <= LOGIT_TOL * scale


@pytest.mark.parametrize("case", ["query_heads", "moe_fsdp", "rwkv6", "whisper",
                                  "seq_alone"])
def test_what_the_port_does_not_lay_out_raises(case):
    """``build_rules`` refuses query heads the model axis does not divide
    (llama3.2-3b's 6 at the smoke size over 4 model ranks: the reference
    shards the kv sequence there); jamba under its fsdp profile's rules at
    (1, 4), whose 2 SSD heads at the smoke size do not split over 4 model
    ranks, rwkv6-3b and whisper-base under a heads rule and a seq rule
    without one raise; each names ROADMAP item 10(c), the SSD heads or the
    missing rule."""
    mesh = pmesh.Mesh(pmesh.AXES, (1, 2), {"data": 0, "model": 0})
    if case == "query_heads":
        b = get_arch("llama3.2-3b", smoke=True)
        with pytest.raises(NotImplementedError, match=re.escape("10(c)")):
            dryrun.build_rules(b, SHAPES["train_4k"],
                               pmesh.Mesh(pmesh.AXES, (1, 4), {"data": 0, "model": 0}))
        return
    if case == "moe_fsdp":
        b = get_arch("jamba-v0.1-52b", smoke=True)
        mesh = pmesh.Mesh(pmesh.AXES, (1, 4), {"data": 0, "model": 0})
        act, weights, _ = dryrun.build_rules(
            get_arch("jamba-v0.1-52b"), SHAPES["train_4k"], mesh)
        assert weights == {"w_embed": "data"}
        with sharding.use_sharding(mesh, {**act, **weights}), \
                pytest.raises(NotImplementedError, match="SSD heads do not split"):
            train_loop.make_step_fns(b.model, _tc())
        return
    if case == "seq_alone":
        cfg = _bundle("tinyllama-1.1b").model
        with sharding.use_sharding(mesh, {"seq": "model", "vocab": None}), \
                pytest.raises(NotImplementedError, match="heads rule"):
            get_api(cfg).loss(get_api(cfg).init(_gen(), cfg), cfg,
                              make_batches(cfg, B, S, device="cpu").next(0))
        return
    cfg = get_arch("rwkv6-3b" if case == "rwkv6" else "whisper-base", smoke=True).model
    with sharding.use_sharding(mesh, {"heads": "model"}), \
            pytest.raises(NotImplementedError, match=re.escape("10(c)")):
        train_loop.make_step_fns(cfg, _tc())


def _gen():
    g = torch.Generator()
    g.manual_seed(0)
    return g


def test_tensor_parallel_ops_outside_a_mesh_are_the_identity():
    """Without a context (and at one model rank) the conjugate operators
    move nothing: ``enter``, ``leave``, ``shard_stream`` and
    ``gather_stream`` return their input."""
    x = torch.ones(2, 4, 3)
    for fn in (tensor_parallel.enter, tensor_parallel.leave,
               tensor_parallel.shard_stream, tensor_parallel.gather_stream):
        assert fn(x) is x
    mesh = pmesh.Mesh(pmesh.AXES, (2, 1), {"data": 0, "model": 0})
    with sharding.use_sharding(mesh, {"heads": "model", "seq": "model"}):
        assert tensor_parallel.size() == 1 and tensor_parallel.seq_parallel()
        for fn in (tensor_parallel.enter, tensor_parallel.leave,
                   tensor_parallel.shard_stream, tensor_parallel.gather_stream):
            assert fn(x) is x


if __name__ == "__main__":
    jax.devices()             # the backend up with two devices first
    inputs = _jax_inputs()
    with open(sys.argv[1] + ".tmp", "wb") as fout:
        pickle.dump(inputs, fout)
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
    results = _jax_cases(inputs)
    with open(sys.argv[2], "wb") as fout:
        pickle.dump(results, fout)
