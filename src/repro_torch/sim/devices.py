"""Device profiles of the paper's testbed (Table 2), read by the emulated
pool and by the simulator of Figs. 11-13 (counterpart of
``repro.sim.devices``, with the same constants).

| device | read lat | write lat | read BW | write BW |
| PMEM   |   3x     |   7x      |  0.6x   |  0.1x    |
| SSD    |  165x    |  165x     |  0.02x  |  0.02x   |

normalised to DRAM: 80 ns load-to-use latency, 102.4 GB/s (4-channel
DDR4-2666, the paper's i5-9600K + 4 x 16 GB testbed). The CXL-MEM backend
has 4 memory controllers (paper Fig. 10): bank-level parallelism multiplies
its random-access throughput. The GPU is the testbed's RTX 3090; nothing
here describes the card the port runs on.
"""
from __future__ import annotations

from dataclasses import dataclass

DRAM_LAT_S = 80e-9
DRAM_BW = 102.4e9


@dataclass(frozen=True)
class MemDevice:
    name: str
    read_lat: float          # seconds per dependent access
    write_lat: float
    read_bw: float           # bytes/s
    write_bw: float
    channels: int = 1        # independent controllers (access parallelism)
    raw_penalty: float = 1.0  # read-after-write latency multiplier (PMEM)

    def t_random_read(self, n_access: int, bytes_each: int,
                      raw_frac: float = 0.0) -> float:
        """n random reads with `channels`-way parallelism, a share
        ``raw_frac`` of them right after a write to the same row."""
        lat = self.read_lat * (1.0 + raw_frac * (self.raw_penalty - 1.0))
        t_lat = n_access * lat / self.channels
        t_bw = n_access * bytes_each / self.read_bw
        return max(t_lat, t_bw)

    def t_random_write(self, n_access: int, bytes_each: int) -> float:
        t_lat = n_access * self.write_lat / self.channels
        t_bw = n_access * bytes_each / self.write_bw
        return max(t_lat, t_bw)

    def t_bulk_write(self, nbytes: int) -> float:
        return nbytes / self.write_bw + self.write_lat

    def t_bulk_read(self, nbytes: int) -> float:
        return nbytes / self.read_bw + self.read_lat


DRAM = MemDevice("dram", DRAM_LAT_S, DRAM_LAT_S, DRAM_BW, DRAM_BW,
                 channels=256)   # bank parallelism behind a deep-queue DMA engine
# PMEM's read-after-write penalty, about 2.5x on a hit (paper ref. 9)
PMEM = MemDevice("pmem", 3 * DRAM_LAT_S, 7 * DRAM_LAT_S,
                 0.6 * DRAM_BW, 0.1 * DRAM_BW, channels=128, raw_penalty=2.5)
SSD = MemDevice("ssd", 165 * DRAM_LAT_S, 165 * DRAM_LAT_S,
                0.02 * DRAM_BW, 0.02 * DRAM_BW, channels=32)

# A host CPU keeps far fewer misses in flight than a near-data DMA engine
# with deep queues: the asymmetry that makes near-data embedding ops win.
HOST_MLP = 24   # outstanding misses (6 cores x about 4 usable MSHRs)


@dataclass(frozen=True)
class Link:
    name: str
    bw: float                # bytes/s
    sw_overhead: float       # host software a synchronised transfer costs
                             # (stream synchronise + copy dispatch), s


PCIE4_X16 = Link("pcie4x16", 32e9, 55e-6)
CXL_LINK = Link("cxl", 32e9, 0.0)    # CXL.cache moves data itself: no software


@dataclass(frozen=True)
class Compute:
    name: str
    flops: float


GPU_3090 = Compute("rtx3090", 35.6e12)        # fp32, the testbed's GPU
HOST_CPU = Compute("i5-9600K", 0.6e12)        # 6-core AVX2 fp32
NDP_LOGIC = Compute("cxl-mem-logic", 1.2e12)  # adder/mult array near PMEM


# Power (W) of the energy model (Fig. 13). DRAM needs 8x the modules of
# PMEM for the same capacity, so its static power dominates.
POWER = {
    "gpu_active": 320.0, "gpu_idle": 60.0,
    "cpu_active": 95.0, "cpu_idle": 20.0,
    "dram_per_module_static": 3.0, "dram_access_w": 12.0,
    "pmem_per_module_static": 1.5, "pmem_read_w": 10.0, "pmem_write_w": 15.0,
    "ssd_static": 2.0, "ssd_access_w": 8.0,
    "ndp_logic_w": 15.0,
    "comp_engine_w": 2.0,      # in-controller (de)compression block
    "dram_modules_full": 768,  # production-scale tables wholly in DRAM
    "pmem_modules": 8,
}
