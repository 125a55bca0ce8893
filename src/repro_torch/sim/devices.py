"""Device profiles the emulated pool charges its traffic to (paper Table 2).

The part of ``repro.sim.devices`` that the pool reads: the DRAM and PMEM
memory profiles, the CXL link, the near-memory adder array and the power
figures of the energy model (Fig. 13). The simulator itself is not ported.

| device | read lat | write lat | read BW | write BW |
| PMEM   |   3x     |   7x      |  0.6x   |  0.1x    |

normalised to DRAM: 80 ns load-to-use latency, 102.4 GB/s (4-channel
DDR4-2666, the paper's testbed).
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

    def t_random_read(self, n_access: int, bytes_each: int) -> float:
        """n random reads with `channels`-way parallelism."""
        t_lat = n_access * self.read_lat / self.channels
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
                 channels=256)
PMEM = MemDevice("pmem", 3 * DRAM_LAT_S, 7 * DRAM_LAT_S,
                 0.6 * DRAM_BW, 0.1 * DRAM_BW, channels=128)


@dataclass(frozen=True)
class Link:
    name: str
    bw: float                # bytes/s


CXL_LINK = Link("cxl", 32e9)


@dataclass(frozen=True)
class Compute:
    name: str
    flops: float


NDP_LOGIC = Compute("cxl-mem-logic", 1.2e12)  # adder/mult array near PMEM


# Active power (W) of the pool's media, near-memory logic and compression
# engine (Fig. 13).
POWER = {
    "dram_access_w": 12.0,
    "pmem_read_w": 10.0, "pmem_write_w": 15.0,
    "ndp_logic_w": 15.0,
    "comp_engine_w": 2.0,   # in-controller (de)compression block
}
