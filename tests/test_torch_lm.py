"""The port's LM serving path against the JAX package, at the smoke size (f32).

Inputs come from numpy with a seed; the port starts from the JAX package's
params through ``repro_torch.interop``. On the CPU the flash-attention
wrapper runs its plain version; the CUDA kernel itself is held against
that plain version in ``test_torch_cuda.py``.
"""
import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import get_api as jax_get_api
from repro.training.serve_loop import greedy_generate as jax_greedy_generate
from repro_torch import interop
from repro_torch.configs import LM_IDS, get_arch
from repro_torch.core import embedding_ops
from repro_torch.data.synthetic import LMBatches, make_batches
from repro_torch.kernels import ops
from repro_torch.models import layers, transformer
from repro_torch.models.registry import get_api
from repro_torch.training.serve_loop import greedy_generate
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
# the transformer ids, dense and MoE; rwkv6-3b (test_torch_rwkv.py) and
# jamba (test_torch_mamba.py) have their own tests
DENSE_IDS = [a for a in LM_IDS if get_arch(a).model.arch_type == "transformer"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _lm(arch):
    """(JAX cfg, port cfg, JAX params, the same params as port tensors)."""
    jcfg = jax_get_arch(arch, smoke=True).model
    cfg = get_arch(arch, smoke=True).model
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, interop.params_from_numpy(jparams, CPU)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_config_matches_jax(arch):
    for smoke in (True, False):
        jcfg = jax_get_arch(arch, smoke=smoke).model
        cfg = get_arch(arch, smoke=smoke).model
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.layer_types == jcfg.layer_types
        assert cfg.ffn_types == jcfg.ffn_types
        assert cfg.param_counts() == jcfg.param_counts()


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_init_lm_has_the_reference_tree(arch):
    jcfg, cfg, jparams, _ = _lm(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = transformer.init_lm(gen, cfg)
    want = jax.tree_util.tree_map(np.asarray, jparams)
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [a.shape for a in tree_leaves(want)]
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))


def test_rms_norm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = layers.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta,offset", [(10000.0, 0), (1e6, 1000)])
def test_apply_rope_matches_jax(rng, theta, offset):
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = offset + np.arange(9, dtype=np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# the cases of tests/test_attention_and_moe.py::test_chunked_attention_vs_ref
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (2, 64, 4, 2, 16, True), (1, 96, 4, 4, 32, False),
    (2, 33, 6, 2, 16, True), (2, 64, 8, 1, 16, True)])
def test_chunked_attention_matches_jax(rng, B, S, Hq, Hkv, D, causal):
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal, q_chunk=16)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_chunked_attention_query_offset_matches_jax(rng):
    """Queries at positions 7..11 over 12 keys (a prefill into a cache that
    already holds 7 entries)."""
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    want = jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        positions_q=7 + jnp.arange(5), positions_k=jnp.arange(12))
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=True, q_offset=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_len", [20, 32])
def test_decode_attention_matches_jax(rng, kv_len):
    B, S, Hq, Hkv, D = 2, 32, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), kv_len)
    got = layers.decode_attention(_t(q), _t(kc), _t(vc), kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_lookup_is_the_row_gather(rng):
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = embedding_ops.lookup(_t(table), _t(ids))
    assert got.shape == (3, 7, 8)
    np.testing.assert_array_equal(got.numpy(), table[ids])   # bitwise


@pytest.mark.parametrize("seed,step", [(0, 0), (5, 3)])
def test_lm_batches_bitwise(seed, step):
    jcfg, cfg = (jax_get_arch("tinyllama-1.1b", smoke=True).model,
                 get_arch("tinyllama-1.1b", smoke=True).model)
    want = JaxLMBatches(jcfg, 4, 17, seed=seed).next(step)
    got = LMBatches(cfg, 4, 17, device="cpu").next(step)   # no seed: see its doc
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(got["tokens"].numpy()[:, 1:], got["labels"].numpy()[:, :-1])
    assert isinstance(make_batches(cfg, 4, 17, device="cpu"), LMBatches)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_prefill_and_decode_match_jax(rng, arch):
    jcfg, cfg, jparams, params = _lm(arch)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    jc = japi.init_cache(jcfg, 2, 16)
    jl_pre, jc = japi.prefill(jparams, jcfg, jnp.asarray(toks[:, :8]), jc)
    jl_dec, jc = japi.decode_step(jparams, jcfg, jnp.asarray(toks[:, 8:9]), 8, jc)
    c = api.init_cache(cfg, 2, 16, CPU)
    l_pre, c = api.prefill(params, cfg, _t(toks[:, :8]), c)
    l_dec, c = api.decode_step(params, cfg, _t(toks[:, 8:9]), 8, c)
    for got, want in ((l_pre, jl_pre), (l_dec, jl_dec)):
        assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for n in ("k", "v"):   # the caches too, in the reference's layout
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_greedy_generate_matches_jax(arch):
    """4 new tokens, max_seq 16, as tests/test_smoke_archs.py::test_decode_shapes."""
    jcfg, cfg, jparams, params = _lm(arch)
    prompt = JaxLMBatches(jcfg, 2, 8).next(0)["tokens"]
    want = jax_greedy_generate(jcfg, jparams, prompt, 4, max_seq=16)
    stats = {}
    got = greedy_generate(cfg, params, _t(prompt), 4, max_seq=16, stats=stats)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["logits"].shape == (2, 4, cfg.vocab_size)
    assert torch.equal(stats["logits"].argmax(-1).to(torch.int32), got)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_greedy_generate_enters_part_around_prefill_and_decode(monkeypatch):
    """``part`` wraps the prefill, then the decode loop (one token-embedding
    gather in the prefill, one per decode step); tokens unchanged."""
    _, cfg, _, params = _lm("tinyllama-1.1b")
    prompt = _t(np.arange(16, dtype=np.int32).reshape(2, 8))
    want = greedy_generate(cfg, params, prompt, 4, max_seq=16)
    gathers, seen = [0], []
    real = ops.gather_rows

    def counted(*a):
        gathers[0] += 1
        return real(*a)
    monkeypatch.setattr(ops, "gather_rows", counted)

    @contextlib.contextmanager
    def part(name):
        before = gathers[0]
        seen.append(name)
        yield
        seen.append(gathers[0] - before)

    got = greedy_generate(cfg, params, prompt, 4, max_seq=16, part=part)
    assert seen == ["prefill", 1, "decode", 3]
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_decode_matches_own_prefill(rng, arch):
    """As tests/test_sequence_mixers.py::test_transformer_decode_matches_prefill."""
    _, cfg, _, params = _lm(arch)
    api = get_api(cfg)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    _, c = api.prefill(params, cfg, toks[:, :8], api.init_cache(cfg, 2, 16, CPU))
    l_dec, _ = api.decode_step(params, cfg, toks[:, 8:9], 8, c)
    l_full, _ = api.prefill(params, cfg, toks, api.init_cache(cfg, 2, 16, CPU))
    np.testing.assert_allclose(l_dec.numpy(), l_full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_lm_loss_matches_jax(arch):
    jcfg, cfg, jparams, params = _lm(arch)
    jb = JaxLMBatches(jcfg, 2, 300).next(1)    # 300 > loss_chunk: two chunks
    want = jtransformer.lm_loss(jparams, jcfg, jb)
    got = transformer.lm_loss(params, cfg, {k: _t(v) for k, v in jb.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_unported_families_raise():
    """The decoder stack refuses a family it does not run: whisper (an
    encoder and a decoder, ``models/whisper.py``) and DLRM. Vision embeds,
    once refused here, now run (tests/test_torch_qwen2vl.py,
    ``test_vision_embeds_replace_the_first_rows``)."""
    cfg = get_arch("tinyllama-1.1b", smoke=True).model
    gen = torch.Generator()
    with pytest.raises(NotImplementedError):
        transformer.init_lm(gen, cfg.replace(arch_type="whisper"))
    params = transformer.init_lm(gen, cfg)
    with pytest.raises(NotImplementedError):
        transformer.forward_hidden(params, cfg.replace(arch_type="dlrm"),
                                   torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        transformer.init_kv_cache(cfg.replace(arch_type="whisper"), 1, 4, CPU)


def _run(args):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", LM_IDS)
def test_serve_cli_runs_on_cpu(arch):
    r = _run(["--arch", arch, "--smoke", "--device", "cpu", "--new-tokens", "4"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"{arch} on cpu" in r.stdout and "ms per token" in r.stdout


def test_serve_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(["--new-tokens", "2"])
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr


def test_serve_cli_pool_backend_not_ported():
    """A sharded pool without its nodes' addresses, a read-only tenant of
    anything but a remote pool, and a remote pool without a node's address
    raise; dram, pmem, remote and sharded serve
    (``tests/test_torch_serve.py``, ``tests/test_torch_remote_pool.py``,
    ``tests/test_torch_sharded_pool.py``)."""
    for args, msg in ((["--pool-backend", "sharded"], "needs --pool-shards"),
                      (["--pool-backend", "pmem", "--pool-readonly"],
                       "needs --pool-backend remote"),
                      (["--pool-backend", "remote"], "needs --pool-addr")):
        r = _run(["--device", "cpu", *args])
        assert r.returncode != 0 and msg in r.stderr, args
