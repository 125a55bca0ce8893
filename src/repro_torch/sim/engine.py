"""Timeline simulator of the paper's evaluation systems (Figs. 11-13):
SSD, PMEM, PCIe, CXL-D, CXL-B and CXL, and DRAM for the energy study
(counterpart of ``repro.sim.engine``: the same constants and the same float
operations, so every batch time, stack and segment equals the JAX
package's).

The stage graph of one batch in steady state:

    [GPU]  B-MLP ------------\\            FI + T-MLP (fwd+bwd)
    [MEM]  embedding lookup --+-> transfer -----------------> grad transfer
           -> embedding update -> checkpoint -> (next batch)

How each system overlaps the stages:
  * SSD, PMEM: embedding ops on the host CPU; a synchronise and copy in
    host software per transfer; a redo-log checkpoint on the critical path
    at the batch's end.
  * PCIe: near-data processing (reduced vectors cross the link), but the
    PCIe software stack stays on the path; redo log.
  * CXL-D: CXL.cache moves the data, so the software overhead is gone; the
    checkpointing logic reads the MLP params behind the embedding ops.
  * CXL-B: + the batch-aware undo log: checkpoint work runs in CXL-MEM's
    idle window (the GPU's FI + T-MLP phase); only the spill is on the
    critical path. Lookups pay the read-after-write penalty (the undo and
    update writes land right before the next batch's reads).
  * CXL: + the relaxed lookup (no read-after-write, the next batch's lookup
    overlapped with this batch's compute) and relaxed MLP logging (spread
    across batches, only ever in idle time).

The model describes the paper's testbed (RTX 3090, i5-9600K, DDR4, Optane
PMEM): its batch times are the model's outputs, not measurements of any
card. ``calibrate_from_pool`` replaces some of its analytic rates with
those a run of the port's emulated pool measured.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.sim import devices as dv
from repro_torch.sim.models_rm import RMWorkload

SYSTEMS = ("SSD", "PMEM", "PCIe", "CXL-D", "CXL-B", "CXL", "DRAM")

# Constants fitted once, by the JAX package, to the paper's four headline
# ratios (5.2x CXL/PMEM, -23% CXL-D/PCIe, -14% CXL/CXL-B, about 10x
# PMEM/SSD; EXPERIMENTS.md, Fig. 11); every other input is Table 2 or 3.
SSD_CACHE_HIT = 0.5       # host-DRAM cache in front of SSD (zipf hot rows)
N_SYNCS = 10              # host sw round-trips per batch (submit/poll/copy x5)
MLP_LOG_SPREAD = 10       # relaxed ckpt: MLP log amortised over K batches
GPU_STAGE_OVERHEAD = 1e-3 # kernel launch / optimizer / framework per phase
MLP_LOG_FRACTION = 0.125  # undo-tier MLP log is differential/quantised
                          # (Check-N-Run-style), ~8x smaller than raw fp32

# Measured overrides (bytes/s and the undo compression ratio) from a pool
# run's counters, set by calibrate_from_pool(): keyed by the device's name
# ("dram" or "pmem"), and "_link:<name>" for a link.
_POOL_CAL: dict = {}


def calibrate_from_pool(metrics) -> dict:
    """Replace the analytic bulk rates of one device (and of the CXL link)
    with the effective rates of a run of the port's emulated pool: its
    bytes over the seconds it charged (the pool charges each op Table 2's
    time for its bytes, so the bytes and the op mix are the run's).

    ``metrics`` is a ``repro_torch.pool.PoolMetrics`` (or anything with its
    ``media``, ``comp``, ``comp_ratio``, ``comp_raw_bytes``, ``link_time``,
    ``link_bytes`` and ``device_name``). Persist traffic calibrates the
    checkpoint's write path, gather and read traffic the undo's read path,
    the link counters the transfer segments, and the undo payload's
    compression ratio shrinks the undo log's writes in the CXL-B and CXL
    checkpoint segments. Returns the calibration dict applied."""
    cal: dict = {}
    w = metrics.media.get("persist")
    if w is not None and w.time_s > 0:
        cal["write_bps"] = w.nbytes / w.time_s
    r_bytes = r_time = 0.0
    for kind in ("read", "gather", "bag_gather", "undo_snapshot",
                 "undo_scan"):
        s = metrics.media.get(kind)
        if s is not None:
            r_bytes += s.nbytes
            r_time += s.time_s
    if r_time > 0:
        cal["read_bps"] = r_bytes / r_time
    # calibrate the undo segment from the UNDO payload ratio alone — dense
    # blobs (near-zero optimizer state) compress far better and would skew
    # the blended pool-wide ratio
    if metrics.comp.get("undo", (0, 0))[0] > 0:
        cal["undo_comp_ratio"] = metrics.comp_ratio("undo")
    elif metrics.comp_raw_bytes > 0:
        cal["undo_comp_ratio"] = metrics.comp_ratio()
    _POOL_CAL[metrics.device_name] = cal
    if metrics.link_time() > 0:
        # pool link counters model the CXL link; calibrate only that link so
        # PCIe-based baseline systems keep their analytic bandwidth
        _POOL_CAL["_link:" + dv.CXL_LINK.name] = {
            "bps": metrics.link_bytes() / metrics.link_time()}
    return cal


def clear_pool_calibration():
    _POOL_CAL.clear()


def _bulk_write_t(dev, nbytes: int) -> float:
    cal = _POOL_CAL.get(dev.name, {})
    if "write_bps" in cal:
        return nbytes / cal["write_bps"] + dev.write_lat
    return dev.t_bulk_write(nbytes)


def _bulk_read_t(dev, nbytes: int) -> float:
    cal = _POOL_CAL.get(dev.name, {})
    if "read_bps" in cal:
        return nbytes / cal["read_bps"] + dev.read_lat
    return dev.t_bulk_read(nbytes)


def _link_bw(link) -> float:
    return _POOL_CAL.get("_link:" + link.name, {}).get("bps", link.bw)


def _undo_comp_ratio(dev) -> float:
    """Measured pool-side undo-log compression ratio (1.0 when the pool ran
    uncompressed or no calibration is loaded)."""
    return _POOL_CAL.get(dev.name, {}).get("undo_comp_ratio", 1.0)


@dataclass
class Segment:
    component: str   # "gpu" | "mem" | "link" | "ckpt"
    start: float
    end: float
    label: str


@dataclass
class SimResult:
    system: str
    rm: str
    batch_time: float
    breakdown: dict            # Fig 11 stacks (seconds)
    trace: list = field(default_factory=list)   # Fig 12 segments
    energy: dict = field(default_factory=dict)  # Fig 13 terms


def _stage_times(system: str, w: RMWorkload):
    gpu = dv.GPU_3090.flops
    t_bmlp = 3 * w.bottom_flops / gpu + GPU_STAGE_OVERHEAD   # fwd + bwd
    t_tmlp = 3 * w.top_flops / gpu + GPU_STAGE_OVERHEAD

    if system == "SSD":
        dev, near = dv.SSD, False
    elif system in ("PMEM", "PCIe", "CXL-D", "CXL-B", "CXL"):
        dev, near = dv.PMEM, system not in ("PMEM",)
    else:
        dev, near = dv.DRAM, False

    raw_frac = 0.0
    if dev is dv.PMEM and system != "CXL":
        raw_frac = w.consec_overlap            # RAW on consecutive batches

    # lookup. Host-side access (SSD/PMEM/DRAM systems) is bounded by the
    # CPU's memory-level parallelism; NDP systems run at device bank
    # parallelism behind a deep-queue DMA engine.
    def host_read(device, n, raw=0.0):
        eff = min(device.channels, dv.HOST_MLP)
        lat = device.read_lat * (1.0 + raw * (device.raw_penalty - 1.0))
        return max(n * lat / eff, n * w.vec_bytes / device.read_bw)

    if system == "SSD":
        n_miss = int(w.n_lookups * (1 - SSD_CACHE_HIT))
        t_read = (host_read(dev, n_miss)
                  + host_read(dv.DRAM, w.n_lookups - n_miss))
    elif not near:
        t_read = host_read(dev, w.n_lookups, raw_frac)
    else:
        t_read = dev.t_random_read(w.n_lookups, w.vec_bytes, raw_frac)
    t_reduce = w.embed_flops / (dv.NDP_LOGIC.flops if near
                                else dv.HOST_CPU.flops)
    t_lookup = t_read + t_reduce

    # link transfer (fwd activations + bwd gradients)
    link = dv.CXL_LINK if system.startswith("CXL") or system == "DRAM" \
        else dv.PCIE4_X16
    nbytes = w.reduced_bytes if (near or system in ("SSD", "PMEM", "DRAM")) \
        else w.raw_bytes
    t_link = 2 * nbytes / _link_bw(link)
    t_sw = 0.0 if system.startswith("CXL") or system == "DRAM" \
        else N_SYNCS * link.sw_overhead

    # update (unique rows)
    if near or system in ("DRAM",):
        t_update = dev.t_random_write(w.n_updated_rows, w.vec_bytes)
    else:
        eff = min(dev.channels, dv.HOST_MLP)
        t_update = max(w.n_updated_rows * dev.write_lat / eff,
                       w.n_updated_rows * w.vec_bytes / dev.write_bw)

    # checkpoint work
    row_bytes = w.n_updated_rows * w.vec_bytes
    if system == "DRAM":
        t_ckpt_emb = t_ckpt_mlp = 0.0          # no persistence at all
    elif system in ("SSD", "PMEM", "PCIe", "CXL-D"):
        # redo log: write updated rows + full MLP params to the device
        t_ckpt_emb = _bulk_write_t(dev, row_bytes)
        t_ckpt_mlp = _bulk_write_t(dev, w.mlp_param_bytes)
        if system in ("SSD", "PMEM", "PCIe"):
            # MLP params must cross the link from the GPU, synchronised by
            # host software; CXL-D's checkpointing logic instead pulls them
            # via CXL.cache during the embedding phase (hidden)
            link_ck = dv.PCIE4_X16
            t_ckpt_mlp += (w.mlp_param_bytes / link_ck.bw
                           + link_ck.sw_overhead)
    else:
        # undo log: read old rows (data region) + write to log region —
        # shrunk by the measured pool-side compression ratio when a pool
        # calibration is loaded; MLP log is differential/quantised
        # (MLP_LOG_FRACTION)
        t_ckpt_emb = (_bulk_read_t(dev, row_bytes)
                      + _bulk_write_t(dev,
                                      int(row_bytes
                                          * _undo_comp_ratio(dev))))
        t_ckpt_mlp = _bulk_write_t(
            dev, int(w.mlp_param_bytes * MLP_LOG_FRACTION))
        if system == "CXL":
            t_ckpt_mlp /= MLP_LOG_SPREAD       # relaxed: amortised over K

    return dict(t_bmlp=t_bmlp, t_tmlp=t_tmlp, t_lookup=t_lookup,
                t_link=t_link, t_sw=t_sw, t_update=t_update,
                t_ckpt_emb=t_ckpt_emb, t_ckpt_mlp=t_ckpt_mlp)


def simulate(system: str, rm: RMWorkload) -> SimResult:
    s = _stage_times(system, rm)
    tr: list[Segment] = []
    ckpt_total = s["t_ckpt_emb"] + s["t_ckpt_mlp"]

    if system == "CXL":
        # steady state: this batch's lookup already ran in the PREVIOUS
        # batch's idle window (relaxed lookup, RAW-free). The MEM idle work
        # this batch = undo log + amortised MLP log + NEXT batch's lookup.
        tA = s["t_bmlp"]
        tr.append(Segment("gpu", 0, s["t_bmlp"], "B-MLP"))
        t0 = tA + s["t_link"] / 2
        tr.append(Segment("link", tA, t0, "Transfer"))
        t1 = t0 + s["t_tmlp"]
        tr.append(Segment("gpu", t0, t1, "FI+T-MLP"))
        # MEM is idle through B-MLP (lookup left the path) AND FI+T-MLP
        idle = s["t_bmlp"] + s["t_link"] / 2 + s["t_tmlp"]
        mem_idle_work = ckpt_total + s["t_lookup"]
        overlapped = min(mem_idle_work, idle)
        tr.append(Segment("ckpt", t0, t0 + min(ckpt_total, idle),
                          "undo+MLP log (idle)"))
        tr.append(Segment("mem", t0 + min(ckpt_total, idle), t0 + overlapped,
                          "next-batch lookup (relaxed)"))
        spill = mem_idle_work - overlapped
        t2 = t1 + s["t_link"] / 2
        tr.append(Segment("link", t1, t2, "Grad transfer"))
        t3 = t2 + s["t_update"]
        tr.append(Segment("mem", t2, t3, "Embedding update"))
        t4 = t3 + spill
        if spill > 0:
            tr.append(Segment("mem", t3, t4, "lookup/ckpt spill"))
        breakdown = {"B-MLP": s["t_bmlp"], "T-MLP": s["t_tmlp"],
                     "Embedding": s["t_update"] + max(0.0, spill - ckpt_total),
                     "Transfer": s["t_link"],
                     "Checkpoint": min(max(spill, 0.0), ckpt_total)}
        return SimResult(system, rm.name, t4, breakdown, tr)

    # dependent schedules -----------------------------------------------
    tA = max(s["t_bmlp"], s["t_lookup"])
    tr.append(Segment("gpu", 0, s["t_bmlp"], "B-MLP"))
    tr.append(Segment("mem", 0, s["t_lookup"], "Embedding lookup"))
    t0 = tA + s["t_sw"] / 2 + s["t_link"] / 2
    tr.append(Segment("link", tA, t0, "Transfer"))
    t1 = t0 + s["t_tmlp"]
    tr.append(Segment("gpu", t0, t1, "FI+T-MLP"))

    ckpt_cp = ckpt_total
    if system == "CXL-B":
        # batch-aware undo log inside the idle window (MEM free once its
        # lookup completes, through transfer + FI/T-MLP); spill is exposed
        idle = max(0.0, tA - s["t_lookup"]) + s["t_link"] / 2 + s["t_tmlp"]
        overlapped = min(ckpt_total, idle)
        tr.append(Segment("ckpt", t0, t0 + overlapped, "undo log (idle)"))
        ckpt_cp = ckpt_total - overlapped
    t2 = t1 + s["t_sw"] / 2 + s["t_link"] / 2
    tr.append(Segment("link", t1, t2, "Grad transfer"))
    t3 = t2 + s["t_update"]
    tr.append(Segment("mem", t2, t3, "Embedding update"))
    t4 = t3 + ckpt_cp
    if ckpt_cp > 0:
        tr.append(Segment("ckpt", t3, t4, "checkpoint"))

    # Fig-11 style stacks: Embedding = lookup + update (lookup partially
    # hidden behind B-MLP is still shown as embedding work in the paper)
    breakdown = {
        "B-MLP": s["t_bmlp"],
        "T-MLP": s["t_tmlp"],
        "Embedding": s["t_lookup"] + s["t_update"],
        "Transfer": s["t_link"] + s["t_sw"],
        "Checkpoint": ckpt_cp,
    }
    return SimResult(system, rm.name, t4, breakdown, tr)
