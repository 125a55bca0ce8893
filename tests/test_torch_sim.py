"""The port's simulator of paper Figs. 11-13 against the JAX package's, on the
CPU.

``repro_torch.sim`` keeps its own copy of ``repro.sim``'s model: the stage
engine, the energy model, the RM workloads (Table 3) and the calibration
rig. Every batch time, stack, timeline segment, joule and workload property
must equal the JAX package's exactly (the same float operations), with and
without a calibration loaded; ``tests/test_sim.py``'s claims run on the
port; ``calibrate_from_pool`` reads the port's ``PoolMetrics`` as the JAX
package reads its own; and ``measured_pool_batch`` gives the JAX package's
byte counters on both backends in both capture modes.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sim.py
"""
import numpy as np
import pytest

from repro.pool import PoolMetrics as JPoolMetrics
from repro.sim import calibration as jcal
from repro.sim import energy as jenergy
from repro.sim import engine as jengine
from repro.sim import models_rm as jrm
from repro_torch.pool import PoolMetrics
from repro_torch.sim import calibration as cal
from repro_torch.sim import energy, engine, models_rm

RMS = list(models_rm.RMS)
RM_PROPS = ("bottom_flops", "top_flops", "mlp_param_bytes", "n_lookups",
            "n_updated_rows", "vec_bytes", "reduced_bytes", "raw_bytes",
            "embed_flops")

# measured_pool_batch at the reference's default sizes (seed 0): the link
# and media bytes of the batch and the undo payload's raw and stored bytes,
# the same on dram and pmem. chip_smoke.py phase 26 holds the card
# machine's run to these numbers.
PINNED = {"wire": {"link_bytes": 11549832, "media_bytes": 22232728,
                   "comp": {}},
          "pool": {"link_bytes": 4505352, "media_bytes": 18335402,
                   "comp": {"undo": [3522264, 1573601]}}}


def _recorded(cls, device, comp):
    """A PoolMetrics of ``cls`` holding the same recorded traffic: persists,
    reads of every kind the calibration reads, link bytes both ways, and
    the compression tallies ``comp`` ("undo", "blob" or none)."""
    m = cls(device_name=device)
    for kind, nbytes, t in (("persist", 7_340_032, 7.1e-4),
                            ("persist", 4_096, 5.9e-7),
                            ("gather", 2_621_440, 4.3e-5),
                            ("bag_gather", 5_242_880, 8.6e-5),
                            ("undo_snapshot", 3_522_264, 5.7e-5),
                            ("undo_scan", 1_280, 2.4e-7),
                            ("read", 65_536, 1.1e-6),
                            ("row_update", 3_522_264, 3.4e-4)):
        m.record(kind, nbytes, t)
    m.record_link("link_in", 3_990_000)
    m.record_link("link_out", 655_360)
    if comp == "undo":
        m.record_comp(3_522_264, 1_573_601, 8.8e-4, kind="undo")
        m.record_comp(1 << 20, 4_000, 2.6e-4, kind="blob")
    elif comp == "blob":
        m.record_comp(1 << 20, 4_000, 2.6e-4, kind="blob")
    return m


@pytest.fixture
def calibrated(request):
    """Loads the same calibration into both packages' engines (or none),
    and clears both afterwards."""
    device, comp = request.param
    if device is not None:
        got = engine.calibrate_from_pool(_recorded(PoolMetrics, device, comp))
        want = jengine.calibrate_from_pool(_recorded(JPoolMetrics, device, comp))
        assert got == want
    yield request.param
    engine.clear_pool_calibration()
    jengine.clear_pool_calibration()


def _segments(res):
    return [(s.component, s.start, s.end, s.label) for s in res.trace]


@pytest.mark.parametrize("calibrated", [(None, None), ("pmem", "undo")],
                         ids=["analytic", "calibrated"], indirect=True)
@pytest.mark.parametrize("rm", RMS)
@pytest.mark.parametrize("system", engine.SYSTEMS)
def test_simulate_and_energy_match_jax(system, rm, calibrated):
    """Batch time, the Fig. 11 stacks, every Fig. 12 segment, the Fig. 13
    terms and the workload's properties: equal to the JAX package's."""
    assert engine.SYSTEMS == jengine.SYSTEMS
    w, jw = models_rm.RMS[rm], jrm.RMS[rm]
    assert w == type(w)(**vars(jw))
    for prop in RM_PROPS:
        assert getattr(w, prop) == getattr(jw, prop), prop
    got, want = engine.simulate(system, w), jengine.simulate(system, jw)
    assert (got.system, got.rm) == (want.system, want.rm)
    assert got.batch_time == want.batch_time
    assert got.breakdown == want.breakdown
    assert _segments(got) == _segments(want)
    assert energy.energy_of(system, w) == jenergy.energy_of(system, jw)


@pytest.mark.parametrize("calibrated", [(None, None), ("pmem", "undo")],
                         ids=["analytic", "calibrated"], indirect=True)
def test_energy_table_matches_jax(calibrated):
    assert energy.energy_table() == jenergy.energy_table()


def _times():
    return {rm: {s: engine.simulate(s, w).batch_time
                 for s in engine.SYSTEMS[:-1]}
            for rm, w in models_rm.RMS.items()}


def _ordering():
    for rm, t in _times().items():
        assert t["SSD"] > 3 * t["PMEM"], rm
        assert t["PMEM"] > t["PCIe"] * 0.99, rm
        assert t["PCIe"] >= t["CXL-D"] * 0.999, rm
        assert t["CXL"] == min(t.values()), rm


def _speedup_5_2x():
    t = _times()
    avg = np.mean([t[r]["PMEM"] / t[r]["CXL"] for r in RMS])
    assert 4.2 <= avg <= 6.2, avg      # paper: 5.2x


def _cxl_d_vs_pcie():
    t = _times()
    avg = np.mean([1 - t[r]["CXL-D"] / t[r]["PCIe"] for r in RMS])
    assert 0.10 <= avg <= 0.35, avg    # paper: 23%


def _relaxation_gain():
    t = _times()
    avg = np.mean([1 - t[r]["CXL"] / t[r]["CXL-B"] for r in RMS])
    assert 0.07 <= avg <= 0.25, avg    # paper: 14%


def _energy_76pct():
    t = energy.energy_table()
    sav = np.mean([1 - t[r]["CXL"] for r in t])
    assert 0.66 <= sav <= 0.86, sav    # paper: 76%


def _energy_dram_vs_pmem():
    t = energy.energy_table()
    assert t["RM1"]["DRAM"] > 1.0
    assert t["RM2"]["DRAM"] > 1.0


def _breakdown_fields():
    r = engine.simulate("CXL-B", models_rm.RMS["RM1"])
    assert set(r.breakdown) == {"B-MLP", "T-MLP", "Embedding", "Transfer",
                                "Checkpoint"}
    assert r.batch_time > 0
    assert all(seg.end >= seg.start for seg in r.trace)


def _relaxed_checkpoint_hidden():
    for rm, w in models_rm.RMS.items():
        d = engine.simulate("CXL-D", w).breakdown["Checkpoint"]
        c = engine.simulate("CXL", w).breakdown["Checkpoint"]
        assert c <= d * 0.8 + 1e-9, rm
    for rm in ("RM3", "RM4"):
        d = engine.simulate("CXL-D", models_rm.RMS[rm]).breakdown["Checkpoint"]
        c = engine.simulate("CXL", models_rm.RMS[rm]).breakdown["Checkpoint"]
        assert c <= d * 0.2 + 1e-9, rm


@pytest.mark.parametrize("claim", [
    _ordering, _speedup_5_2x, _cxl_d_vs_pcie, _relaxation_gain, _energy_76pct,
    _energy_dram_vs_pmem, _breakdown_fields, _relaxed_checkpoint_hidden],
    ids=lambda f: f.__name__.lstrip("_"))
def test_paper_claims_hold_on_the_port(claim):
    """tests/test_sim.py's claims, with its bands, on the port's model."""
    claim()


@pytest.mark.parametrize("device,comp", [("pmem", "undo"), ("pmem", "blob"),
                                         ("pmem", None), ("dram", "undo")])
def test_calibrate_from_pool_matches_jax(device, comp):
    """The same recorded tallies in both packages' PoolMetrics give the same
    calibration dict and the same calibrated results for every system and
    RM; clearing it restores the analytic ones."""
    analytic = {(s, rm): engine.simulate(s, w)
                for s in engine.SYSTEMS for rm, w in models_rm.RMS.items()}
    try:
        got = engine.calibrate_from_pool(_recorded(PoolMetrics, device, comp))
        want = jengine.calibrate_from_pool(
            _recorded(JPoolMetrics, device, comp))
        assert got == want
        assert got["write_bps"] > 0 and got["read_bps"] > 0
        assert ("undo_comp_ratio" in got) == (comp is not None)
        if comp == "undo":    # the undo payload's ratio, not the blended one
            assert got["undo_comp_ratio"] == 1_573_601 / 3_522_264
        moved = 0
        for (s, rm), res in analytic.items():
            c = engine.simulate(s, models_rm.RMS[rm])
            j = jengine.simulate(s, jrm.RMS[rm])
            assert c.batch_time == j.batch_time and c.breakdown == j.breakdown
            assert _segments(c) == _segments(j)
            assert np.isfinite(c.batch_time) and c.batch_time > 0
            moved += c.batch_time != res.batch_time
        # a pmem calibration moves the PMEM-backed systems; a dram one moves
        # nothing (the DRAM system checkpoints nothing, and the link's
        # counters are timed at the CXL link's own rate)
        assert (moved > 0) == (device == "pmem")
    finally:
        engine.clear_pool_calibration()
        jengine.clear_pool_calibration()
    for (s, rm), res in analytic.items():
        again = engine.simulate(s, models_rm.RMS[rm])
        assert again.batch_time == res.batch_time
        assert _segments(again) == _segments(res)


def _counters(m):
    return {side: {k: (s.ops, s.nbytes) for k, s in getattr(m, side).items()}
            for side in ("media", "link")}


@pytest.mark.parametrize("mode", ["wire", "pool"])
@pytest.mark.parametrize("backend", ["dram", "pmem"])
def test_measured_pool_batch_matches_jax(tmp_path, backend, mode):
    """Every byte counter and the compression tallies equal the JAX
    package's, and the pinned numbers; the modelled times are positive, and
    pool mode moves fewer link bytes than wire mode."""
    got = cal.measured_pool_batch(backend, mode,
                                  path=str(tmp_path / "port.img"))
    want = jcal.measured_pool_batch(backend, mode,
                                    path=str(tmp_path / "jax.img"))
    assert got.device_name == want.device_name == backend
    assert _counters(got) == _counters(want)
    assert got.comp == want.comp
    assert (got.comp_raw_bytes, got.comp_stored_bytes) == \
        (want.comp_raw_bytes, want.comp_stored_bytes)
    assert got.link_bytes() == PINNED[mode]["link_bytes"]
    assert got.media_bytes() == PINNED[mode]["media_bytes"]
    assert got.comp == PINNED[mode]["comp"]
    assert PINNED["pool"]["link_bytes"] < PINNED["wire"]["link_bytes"]
    assert got.link_time() > 0 and got.media_time() > 0
    assert all(s.time_s > 0 for s in got.media.values())
    assert got.energy() == want.energy()
    assert cal.embedding_like_table(np.random.default_rng(1), (3, 4)).tobytes() \
        == jcal.embedding_like_table(np.random.default_rng(1), (3, 4)).tobytes()
