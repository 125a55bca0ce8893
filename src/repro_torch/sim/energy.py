"""Energy model of paper Fig. 13 (counterpart of ``repro.sim.energy``): the
energy of a batch is, summed over the components, active power x busy time
+ static power x batch time, over the simulator's timeline.

DRAM holds the whole tables: fast, but it needs 8x the modules of PMEM for
the same capacity, so its static power dominates; it also checkpoints
nothing, which is why PMEM can still beat it on MLP-heavy RMs where PMEM
pays for logging. The joules are the model's outputs for the paper's
testbed, not measurements.
"""
from __future__ import annotations

from repro_torch.sim import devices as dv
from repro_torch.sim.engine import simulate
from repro_torch.sim.models_rm import RMS, RMWorkload

P = dv.POWER


def _busy(trace, component):
    return sum(seg.end - seg.start for seg in trace if seg.component == component)


def energy_of(system: str, w: RMWorkload) -> dict:
    res = simulate(system, w)
    T = res.batch_time
    gpu_busy = _busy(res.trace, "gpu")
    mem_busy = _busy(res.trace, "mem") + _busy(res.trace, "ckpt")
    link_busy = _busy(res.trace, "link")

    if system == "DRAM":
        static = P["dram_per_module_static"] * P["dram_modules_full"]
        mem_w = P["dram_access_w"]
    elif system == "SSD":
        static = P["ssd_static"] + P["dram_per_module_static"] * 4
        mem_w = P["ssd_access_w"]
    else:
        static = P["pmem_per_module_static"] * P["pmem_modules"]
        mem_w = 0.5 * (P["pmem_read_w"] + P["pmem_write_w"])
        if system.startswith("CXL") or system == "PCIe":
            static += P["ndp_logic_w"] * 0.2   # idle NDP card
    cpu_active = system in ("SSD", "PMEM")     # host runs embedding ops
    e = {
        "gpu": P["gpu_active"] * gpu_busy + P["gpu_idle"] * (T - gpu_busy),
        "cpu": (P["cpu_active"] * (mem_busy if cpu_active else 0.0)
                + P["cpu_idle"] * T),
        "mem": mem_w * mem_busy + static * T,
        "ndp": (P["ndp_logic_w"] * mem_busy
                if system.startswith("CXL") or system == "PCIe" else 0.0),
        "link": 5.0 * link_busy,
    }
    e["total"] = sum(e.values())
    e["batch_time"] = T
    return e


def energy_table():
    """Fig. 13: each RM's energy a batch, normalised to PMEM's."""
    out = {}
    for rm, w in RMS.items():
        row = {s: energy_of(s, w)["total"]
               for s in ("SSD", "PMEM", "DRAM", "CXL")}
        out[rm] = {k: v / row["PMEM"] for k, v in row.items()}
    return out
