"""The port's serving under a mesh (``repro_torch.launch.mesh``,
``repro_torch.distributed``, the near-data lookup and bag, context-parallel
decode, expert-parallel MoE) against the JAX package's, at two shards, at
the smoke size in f32.

Inputs come from numpy with a seed, and the params from the JAX package's
init; the port takes them through ``interop`` and each rank keeps its part
(``sharding.shard_params``). Two module-scoped fixtures run every two-shard
case once:
  * ``torch_ranks``: two gloo ranks on the CPU, spawned once
    (``mesh.spawn``); each runs every case and writes its results;
  * ``jax_run``: this file run as a script in a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=2``, under
    ``make_local_mesh(model_parallel=2)`` and the same rules.
Both start together. On the CPU the shards use the kernels' plain
versions (by the tensors' device), as everywhere in the port.

Each case states its tolerance: lookups bitwise; bags 1e-5 (as
``tests/test_embedding_ops.py`` holds its bag modes); context-parallel
decode 2e-5 (``tests/test_attention_and_moe.py:46``), its cache bitwise;
MoE 1e-5 (``test_moe_ep_matches_local``); served tokens equal and logits
within 1e-5 of the largest; the rm1 forward 1e-5. The rest runs in this
process: the specs against the JAX package's for every arch id, the
context's specs and ``_pick``, the shard slices, and what raises.
"""
import concurrent.futures
import os
import pickle
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding_ops as jeo
from repro.data.synthetic import DLRMBatches as JaxDLRMBatches
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.distributed import sharding as jsh
from repro.models import moe as jmoe
from repro.models.registry import get_api as jax_get_api
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import embedding_ops as eo
from repro_torch.distributed import context_parallel as cp
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as pmesh
from repro_torch.models import moe, transformer
from repro_torch.models.registry import get_api

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CPU = torch.device("cpu")
WORLD = 2
SERVE_RULES = {"batch": None, "cache_seq": "model"}
MOE_IDS = ("qwen3-moe-235b-a22b", "arctic-480b", "jamba-v0.1-52b")
MOE_RULES = {"nobatch": {"batch": None}, "batch": {"batch": "data"}}
SERVED = ("jamba-v0.1-52b", "qwen3-moe-235b-a22b")
# (mode, ids shape): 20 ids pick near_data under auto, 40 table_gather
LOOKUPS = {"near_data": ("near_data", (4, 5)), "table_gather": ("table_gather", (4, 5)),
           "auto": ("auto", (4, 5)), "auto_large": ("auto", (4, 10))}
BAGS = [(m, c) for m in ("near_data", "table_gather") for c in ("sum", "mean")]
CP_POS = (3, 7, 8, 12)     # 16 positions, 8 a shard: each shard and the boundary
PROMPT, NEW, MAX_SEQ = 6, 4, 10   # the prefill spans both shards, decode in shard 1
TIMEOUT = 120      # seconds a collective may wait before it raises (a lost rank)


def _parallel(jobs):
    """Runs the thunks on threads, each returning a dict, and merges them:
    XLA compiles without the interpreter lock, and the sharding context
    and lookup mode are per thread."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        out = {}
        for part in ex.map(lambda job: job(), jobs):
            out.update(part)
    return out


def _inputs():
    """Every case's inputs and params, as numpy trees (seed 0); each init
    one compiled call (op by op, smoke jamba's takes about 10 s here)."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    inp = {"table": rng.standard_normal((64, 8)).astype(f32),
           "ids": {k: rng.integers(0, 64, shape).astype(np.int32)
                   for k, (_, shape) in LOOKUPS.items()},
           "tables": rng.standard_normal((3, 32, 8)).astype(f32),
           "bag_ids": rng.integers(0, 32, (4, 3, 6)).astype(np.int32)}
    B, S, Hq, Hkv, D = 2, 16, 4, 2, 8
    inp["cp"] = {n: rng.standard_normal(s).astype(f32) for n, s in (
        ("q", (B, 1, Hq, D)), ("kc", (B, S, Hkv, D)), ("vc", (B, S, Hkv, D)),
        ("nk", (B, 1, Hkv, D)), ("nv", (B, 1, Hkv, D)))}
    cfgs = {a: jax_get_arch(a, smoke=True).model for a in MOE_IDS + ("dlrm-rm1",)}
    xs = {a: rng.standard_normal((2, 8, cfgs[a].d_model)).astype(f32) for a in MOE_IDS}

    def init(key, init_fn, cfg):
        def job():
            p = jax.jit(lambda k: init_fn(k, cfg))(jax.random.PRNGKey(0))
            return {key: jax.tree.map(np.asarray, p)}
        return job
    params = _parallel([init(("moe", a), jmoe.init_moe, cfgs[a]) for a in MOE_IDS]
                       + [init(("serve", a), jax_get_api(cfgs[a]).init, cfgs[a])
                          for a in SERVED + ("dlrm-rm1",)])
    inp["moe"] = {a: {"p": params[("moe", a)], "x": xs[a]} for a in MOE_IDS}
    inp["serve"] = {a: {"params": params[("serve", a)],
                        "prompt": JaxLMBatches(cfgs[a], 2, PROMPT).next(0)["tokens"]}
                    for a in SERVED}
    batch = JaxDLRMBatches(cfgs["dlrm-rm1"], 4, seed=0).next(0)
    inp["rm1"] = {"params": params[("serve", "dlrm-rm1")],
                  "batch": {k: np.asarray(batch[k]) for k in ("dense", "sparse")}}
    return inp


# -- the JAX package at two host devices (run as a script) ---------------------


def _jax_cases(inp):
    from repro.distributed.context_parallel import decode_attention_cp
    from repro.launch.mesh import make_local_mesh
    from repro.models import dlrm as jdlrm
    from repro.training.serve_loop import make_serve_fns
    assert jax.device_count() == WORLD, jax.devices()
    mesh = make_local_mesh(model_parallel=WORLD)

    def lookup(name, mode):
        with jsh.use_sharding(mesh, {"batch": "data"}), jeo.lookup_mode(mode):
            # a lambda of its own: the mode is read while tracing
            return {f"lookup/{name}": np.asarray(jax.jit(lambda t, i: jeo.lookup(t, i))(
                jnp.asarray(inp["table"]), jnp.asarray(inp["ids"][name])))}

    def bag(mode, comb):
        with jsh.use_sharding(mesh, {"batch": "data"}), jeo.lookup_mode(mode):
            return {f"bag/{mode}/{comb}": np.asarray(jax.jit(
                lambda t, i: jeo.bag_lookup(t, i, combine=comb))(
                    jnp.asarray(inp["tables"]), jnp.asarray(inp["bag_ids"])))}

    def cp_decode():
        c = {k: jnp.asarray(v) for k, v in inp["cp"].items()}
        out = {}
        with jsh.use_sharding(mesh, {"batch": None, "cache_seq": "model"}):
            f = jax.jit(decode_attention_cp)
            for pos in CP_POS:
                o, kc, vc = f(c["q"], c["kc"], c["vc"], c["nk"], c["nv"], jnp.asarray(pos))
                out[f"cp/{pos}"] = tuple(np.asarray(a) for a in (o, kc, vc))
        return out

    def moe_ep(arch, name, rules):
        cfg = jax_get_arch(arch, smoke=True).model
        p = jax.tree.map(jnp.asarray, inp["moe"][arch]["p"])
        with jsh.use_sharding(mesh, rules):
            o, aux = jax.jit(lambda p, x: jmoe.moe_fwd(p, cfg, x))(
                p, jnp.asarray(inp["moe"][arch]["x"]))
        return {f"moe/{arch}/{name}": (np.asarray(o), float(aux))}

    def serve(arch):
        cfg = jax_get_arch(arch, smoke=True).model
        params = jax.tree.map(jnp.asarray, inp["serve"][arch]["params"])
        prefill_step, decode_step, init_cache = make_serve_fns(cfg)
        with jsh.use_sharding(mesh, SERVE_RULES):
            logits, caches = jax.jit(prefill_step)(
                params, {"tokens": jnp.asarray(inp["serve"][arch]["prompt"])},
                init_cache(2, MAX_SEQ))
            dec = jax.jit(decode_step)
            toks, kept = [jnp.argmax(logits, -1)], [logits]
            for s in range(NEW - 1):
                logits, caches = dec(params, toks[-1][:, None], jnp.asarray(PROMPT + s),
                                     caches)
                toks.append(jnp.argmax(logits, -1))
                kept.append(logits)
        return {f"serve/{arch}": (np.asarray(jnp.stack(toks, 1)),
                                  np.asarray(jnp.stack(kept, 1)))}

    def rm1():
        cfg = jax_get_arch("dlrm-rm1", smoke=True).model
        params = jax.tree.map(jnp.asarray, inp["rm1"]["params"])
        batch = {k: jnp.asarray(v) for k, v in inp["rm1"]["batch"].items()}
        with jsh.use_sharding(mesh, {"batch": None}):
            return {"rm1": np.asarray(jax.jit(lambda p, b: jdlrm.forward(p, cfg, b))(
                params, batch))}

    moe_cases = [(a, n, r) for a in MOE_IDS for n, r in MOE_RULES.items()]
    moe_cases.append((MOE_IDS[0], "seq", {"batch": None, "seq": "model"}))
    return _parallel(
        [lambda a=a: serve(a) for a in SERVED] + [rm1, cp_decode]
        + [lambda c=c: moe_ep(*c) for c in moe_cases]
        + [lambda n=n, m=m: lookup(n, m) for n, (m, _) in LOOKUPS.items()]
        + [lambda m=m, c=c: bag(m, c) for m, c in BAGS])


# -- the port at two gloo ranks -------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_rank(rank, world, device, inp_path, out_dir):
    """One rank: every case under the port's mesh, its results pickled to
    ``out_dir/rank{rank}.pkl``. The inputs come from the JAX subprocess,
    which writes them before its own cases."""
    from repro_torch.models import dlrm
    from repro_torch.training.serve_loop import greedy_generate
    deadline = time.monotonic() + 120
    while not os.path.exists(inp_path):
        assert time.monotonic() < deadline, f"no {inp_path} from the JAX subprocess"
        time.sleep(0.1)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    mesh = pmesh.make_local_mesh(model_parallel=world, device=device)
    out = {}
    held = sharding.shard_params({"embed": {"table": _t(inp["table"])}}, mesh)
    for name, (mode, _) in LOOKUPS.items():
        with sharding.use_sharding(mesh, {"batch": "data"}), eo.lookup_mode(mode):
            out[f"lookup/{name}"] = eo.lookup(held["embed"]["table"], _t(inp["ids"][name]),
                                              rows=64).numpy()
    out["lookup_rows"] = held["embed"]["table"].shape[0]
    tables = sharding.shard_params({"embed": {"emb_tables": _t(inp["tables"])}},
                                   mesh)["embed"]["emb_tables"]
    for mode, comb in BAGS:
        with sharding.use_sharding(mesh, {"batch": "data"}), eo.lookup_mode(mode):
            out[f"bag/{mode}/{comb}"] = eo.bag_lookup(
                tables, _t(inp["bag_ids"]), combine=comb, rows=32).numpy()
    c = {k: _t(v) for k, v in inp["cp"].items()}
    S_loc = c["kc"].shape[1] // world
    mine = slice(rank * S_loc, (rank + 1) * S_loc)
    for pos in CP_POS:
        kc, vc = c["kc"][:, mine].clone(), c["vc"][:, mine].clone()
        with sharding.use_sharding(mesh, {"batch": None, "cache_seq": "model"}):
            o, kc, vc = cp.decode_attention_cp(c["q"], kc, vc, c["nk"], c["nv"], pos)
        out[f"cp/{pos}"] = (o.numpy(), kc.numpy(), vc.numpy())
    for arch in MOE_IDS:
        cfg = get_arch(arch, smoke=True).model
        p = sharding.shard_params({"moe": interop.params_from_numpy(
            inp["moe"][arch]["p"], CPU)}, mesh)["moe"]
        x = _t(inp["moe"][arch]["x"])
        rules = dict(MOE_RULES)
        if arch == MOE_IDS[0]:
            rules["seq"] = {"batch": None, "seq": "model"}
        for name, r in rules.items():
            xi = x[:, rank * 4:(rank + 1) * 4] if name == "seq" else x
            with sharding.use_sharding(mesh, r):
                o, aux = moe.moe_fwd(p, cfg, xi)
            out[f"moe/{arch}/{name}"] = (o.numpy(), float(aux))
        out[f"moe_experts/{arch}"] = p["wi"].shape[0]
    for arch in SERVED:
        cfg = get_arch(arch, smoke=True).model
        params = sharding.shard_params(
            interop.params_from_numpy(inp["serve"][arch]["params"], CPU), mesh)
        stats = {}
        with sharding.use_sharding(mesh, SERVE_RULES):
            toks = greedy_generate(cfg, params, _t(inp["serve"][arch]["prompt"]), NEW,
                                   max_seq=MAX_SEQ, stats=stats)
        out[f"serve/{arch}"] = (toks.numpy(), stats["logits"].numpy())
    cfg = get_arch("dlrm-rm1", smoke=True).model
    params = sharding.shard_params(interop.params_from_numpy(inp["rm1"]["params"], CPU),
                                   mesh)
    batch = {k: _t(v) for k, v in inp["rm1"]["batch"].items()}
    before = mesh.stats().get("all_reduce_sum", {"bytes": 0})["bytes"]
    with sharding.use_sharding(mesh, {"batch": None}), torch.no_grad():
        out["rm1"] = dlrm.forward(params, cfg, batch).numpy()
    out["rm1_moved"] = mesh.stats()["all_reduce_sum"]["bytes"] - before
    out["rm1_rows"] = params["embed"]["emb_tables"].shape[1]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, [rank 0's, rank 1's]): the JAX subprocess (which makes
    the inputs first) and the two torch ranks, started together."""
    d = tmp_path_factory.mktemp("dist")
    inp_path, jax_out = d / "inputs.pkl", d / "jax.pkl"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, HERE]),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    jax_proc = subprocess.Popen([sys.executable, __file__, str(inp_path), str(jax_out)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        pmesh.spawn(_torch_rank, WORLD, backend="gloo", device="cpu",
                    args=(str(inp_path), str(d)), timeout=TIMEOUT)
        log = jax_proc.communicate(timeout=300)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_lookup_bitwise_at_two_shards(runs, name):
    """Every mode bitwise the JAX package's, on both ranks; each rank holds
    32 of the 64 rows."""
    want, ranks = runs
    for got in ranks:
        assert got["lookup_rows"] == 32
        np.testing.assert_array_equal(got[f"lookup/{name}"], want[f"lookup/{name}"])


@pytest.mark.parametrize("mode,combine", BAGS)
def test_bag_lookup_at_two_shards(runs, mode, combine):
    """Sum and mean, near-data and table-gather: within 1e-5."""
    want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[f"bag/{mode}/{combine}"],
                                   want[f"bag/{mode}/{combine}"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos", CP_POS)
def test_decode_attention_cp_at_two_shards(runs, pos):
    """The output within 2e-5 on both ranks; each rank's cache part bitwise
    its block of the JAX package's (the new row written by its owner)."""
    want, ranks = runs
    wo, wk, wv = want[f"cp/{pos}"]
    for r, got in enumerate(ranks):
        o, kc, vc = got[f"cp/{pos}"]
        np.testing.assert_allclose(o, wo, rtol=2e-5, atol=2e-5)
        S_loc = kc.shape[1]
        np.testing.assert_array_equal(kc, wk[:, r * S_loc:(r + 1) * S_loc])
        np.testing.assert_array_equal(vc, wv[:, r * S_loc:(r + 1) * S_loc])


@pytest.mark.parametrize("arch", MOE_IDS)
@pytest.mark.parametrize("rules", ["nobatch", "batch"])
def test_moe_ep_at_two_shards(runs, arch, rules):
    """Expert-parallel MoE (2 of 4 experts a rank) within 1e-5, aux too,
    with no batch rule and with the batch over ``data``."""
    want, ranks = runs
    wo, waux = want[f"moe/{arch}/{rules}"]
    for got in ranks:
        assert got[f"moe_experts/{arch}"] == 2
        o, aux = got[f"moe/{arch}/{rules}"]
        np.testing.assert_allclose(o, wo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, waux, rtol=1e-5)


def test_moe_ep_under_a_seq_rule(runs):
    """Under ``seq: model`` each rank hands in its half of the sequence:
    gathered, routed whole, reduce-scattered back; within 1e-5 of its half
    of the JAX package's output."""
    want, ranks = runs
    wo, waux = want[f"moe/{MOE_IDS[0]}/seq"]
    for r, got in enumerate(ranks):
        o, aux = got[f"moe/{MOE_IDS[0]}/seq"]
        np.testing.assert_allclose(o, wo[:, r * 4:(r + 1) * 4], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, waux, rtol=1e-5)


@pytest.mark.parametrize("arch", SERVED)
def test_served_under_the_mesh(runs, arch):
    """greedy_generate under {batch: None, cache_seq: model} (the prefill's
    cache spans both shards, decode runs in shard 1): the tokens equal the
    JAX package's and each other rank's, the logits within 1e-5 of the
    largest."""
    want, ranks = runs
    wt, wl = want[f"serve/{arch}"]
    for got in ranks:
        toks, logits = got[f"serve/{arch}"]
        np.testing.assert_array_equal(toks, wt)
        assert np.abs(logits - wl).max() <= 1e-5 * np.abs(wl).max()
    np.testing.assert_array_equal(ranks[0][f"serve/{arch}"][1], ranks[1][f"serve/{arch}"][1])


def test_rm1_forward_under_the_mesh(runs):
    """The smoke rm1 forward with each rank's half of every table (the
    near-data bag): within 1e-5; the all-reduce a bag lookup moves is B*T*d
    f32 whatever L is."""
    want, ranks = runs
    cfg = get_arch("dlrm-rm1", smoke=True).model
    B, (T, L) = 4, (cfg.dlrm_num_tables, cfg.dlrm_num_sparse)
    for got in ranks:
        assert got["rm1_rows"] == cfg.dlrm_rows_per_table // WORLD
        assert got["rm1_moved"] == B * T * cfg.dlrm_bottom_mlp[-1] * 4, (B, T, L)
        np.testing.assert_allclose(got["rm1"], want["rm1"], rtol=1e-5, atol=1e-5)


# -- single-process cases -------------------------------------------------------


def _mesh(shape, coords=None):
    return pmesh.Mesh(pmesh.AXES, shape, coords or {"data": 0, "model": 0})


def _jax_mesh(shape):
    # check_divisibility reads only the axis names and the devices' shape
    return types.SimpleNamespace(axis_names=pmesh.AXES, devices=np.empty(shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_divisibility_match_jax(arch):
    """For every arch id's smoke params (the JAX package's by
    ``jax.eval_shape``, the port's drawn on the CPU): the same tree of
    specs, with and without the mesh's axes, and the same downgrades on
    meshes of 1 x 2 and 1 x 3."""
    jcfg = jax_get_arch(arch, smoke=True).model
    jshapes = jax.eval_shape(lambda: jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg))
    cfg = get_arch(arch, smoke=True).model
    gen = torch.Generator()
    gen.manual_seed(0)
    params = get_api(cfg).init(gen, cfg)

    def flat(specs):
        leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, (tuple, jax.sharding.PartitionSpec)))
        return [tuple(s) for s in leaves]
    for axes in (None, set(pmesh.AXES)):
        want = jsh.param_specs(jshapes, mesh_axes=axes)
        got = sharding.param_specs(params, mesh_axes=axes)
        assert flat(got) == flat(want)
    for shape in ((1, 2), (1, 3), (2, 2)):
        want = jsh.check_divisibility(jshapes, jsh.param_specs(jshapes), _jax_mesh(shape))
        got = sharding.check_divisibility(params, sharding.param_specs(params), _mesh(shape))
        assert flat(got) == flat(want), shape


def test_context_spec_and_pick_match_jax():
    """``ShardingContext.spec`` against the reference's on the same rules
    (names not in the mesh dropped), and ``_pick`` on the cases of
    ``test_auto_strategy_picks_by_traffic``. The heads rules are given as
    the reference's defaults (the port's defaults leave them out)."""
    rules = {"batch": ("pod", "data"), "seq": "model", "cache_seq": ("data", "model"),
             "vocab": "pod", "heads": "model", "kv_heads": "model"}
    logical = [("batch", None, "heads", None), ("batch", "seq", "embed"),
               ("cache_seq", "vocab", "experts", "kv_heads"), (None,), ()]
    jmesh = jax.make_mesh((1, 1), pmesh.AXES)
    with sharding.use_sharding(_mesh((1, 2)), rules) as ctx, \
            jsh.use_sharding(jmesh, rules) as jctx:
        for lg in logical:
            assert ctx.spec(lg) == tuple(jctx.spec(lg))
            assert sharding.named_sharding(lg) == ctx.spec(lg)
        x = torch.ones(2)
        assert sharding.constrain(x, ("batch",)) is x
    assert sharding.current() is None and sharding.named_sharding(("batch",)) is None
    for args in (("auto", 128, 150000, 16), ("auto", 1_000_000, 32000, 16),
                 ("auto", 10, 100, 1), ("near_data", 10, 100, 1), ("auto", 20, 64, 2),
                 ("auto", 40, 64, 2)):
        assert eo._pick(*args) == jeo._pick(*args), args


def test_shard_slices():
    """A rank's block of each island leaf by its spec (a (1, 2) mesh, rank
    1; a (2, 2) mesh, rank (1, 0)); dense leaves whole; a spec over a tuple
    of axes cut by the linear index."""
    m = _mesh((1, 2), {"data": 0, "model": 1})
    table, experts = torch.arange(40.).reshape(10, 4), torch.arange(48.).reshape(2, 4, 3, 2)
    wq = torch.ones(4, 6)
    tree = {"embed": {"table": table}, "blocks": {"moe": {"wi": experts}, "attn": {"wq": wq}}}
    got = sharding.shard_params(tree, m)
    assert torch.equal(got["embed"]["table"], table[5:])
    assert torch.equal(got["blocks"]["moe"]["wi"], experts[:, 2:])
    assert got["blocks"]["attn"]["wq"] is wq          # heads over model: held whole
    assert sharding.held_spec("blocks/attn/wq", (4, 6), m) == ()
    assert sharding.held_spec("embed/table", (9, 4), m) == (None, None)   # 9 rows: whole
    m4 = _mesh((2, 2), {"data": 1, "model": 0})
    assert m4.axis_index(("data", "model")) == 2 and m4.axis_size(("data", "model")) == 4
    assert sharding.local_slices((8, 3), (("data", "model"), None), m4) == \
        (slice(4, 6), slice(0, 3))
    keep = sharding.keep_shard(m)
    assert torch.equal(keep("moe/wo", experts[0]), experts[0][2:])


def test_cp_prefill_past_zero_and_whisper_cache_raise():
    """Under a cache_seq rule: a prefill at cache_index > 0 raises (it would
    need the filled prefix gathered), a cache of positions the ranks do not
    divide raises, the cache holds Smax / n positions, a prefill longer
    than the ranks' positions together raises (as past a whole cache), and
    whisper's decoder cache raises."""
    cfg = get_arch("tinyllama-1.1b", smoke=True).model
    api = get_api(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = api.init(gen, cfg)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    # the table whole (no vocab rule): this mesh has no process group
    with sharding.use_sharding(_mesh((1, 2)), {**SERVE_RULES, "vocab": None}):
        caches = api.init_cache(cfg, 1, 8, CPU)
        assert caches["k"].shape[2] == 4
        with pytest.raises(NotImplementedError, match="cache_index 2"):
            transformer.forward_hidden(params, cfg, toks[:, :2], caches=caches,
                                       cache_index=2)
        with pytest.raises(ValueError, match="does not split"):
            api.init_cache(cfg, 1, 7, CPU)
        with pytest.raises(ValueError, match="cannot take 10 tokens"):
            api.prefill(params, cfg, torch.zeros((1, 10), dtype=torch.int64), caches)
        wcfg = get_arch("whisper-base", smoke=True).model
        with pytest.raises(NotImplementedError, match="whisper"):
            get_api(wcfg).init_cache(wcfg, 1, 8, CPU)


def test_mesh_collectives_need_groups():
    """A mesh made without a process group answers questions of shape but
    runs no collective over an axis of more than one rank."""
    m = _mesh((1, 2))
    x = torch.ones(3)
    assert m.all_reduce(x, "data") is x
    with pytest.raises(ValueError, match="no process group"):
        m.all_reduce(x, "model")


if __name__ == "__main__":
    inputs = _inputs()
    with open(sys.argv[1] + ".tmp", "wb") as fout:
        pickle.dump(inputs, fout)
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
    results = _jax_cases(inputs)
    with open(sys.argv[2], "wb") as fout:
        pickle.dump(results, fout)
