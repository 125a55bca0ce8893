"""RM1-RM4 workload descriptions (paper Table 3), the work of one training
batch (counterpart of ``repro.sim.models_rm``, with the same numbers)."""
from __future__ import annotations

from dataclasses import dataclass

BATCH = 256  # samples per training batch (calibrated to Fig. 12's ms scale)


@dataclass(frozen=True)
class RMWorkload:
    name: str
    dim: int
    n_tables: int
    n_sparse: int            # lookups per table per sample
    bottom_mlp: tuple
    top_mlp: tuple
    n_dense: int = 13
    batch: int = BATCH
    consec_overlap: float = 0.8   # rows the next batch touches again (ref. 10)

    def _mlp_flops(self, dims, batch):
        return 2 * batch * sum(a * b for a, b in zip(dims[:-1], dims[1:], strict=True))

    @property
    def bottom_flops(self):
        return self._mlp_flops(self.bottom_mlp, self.batch)

    @property
    def top_flops(self):
        feats = self.n_tables + 1
        inter = self.batch * feats * feats * self.dim * 2
        top_in = self.dim + feats * (feats - 1) // 2
        return inter + self._mlp_flops((top_in,) + self.top_mlp, self.batch)

    @property
    def mlp_param_bytes(self):
        dims = self.bottom_mlp
        n = sum(a * b for a, b in zip(dims[:-1], dims[1:], strict=True))
        feats = self.n_tables + 1
        top_in = self.dim + feats * (feats - 1) // 2
        dims = (top_in,) + self.top_mlp
        n += sum(a * b for a, b in zip(dims[:-1], dims[1:], strict=True))
        return 4 * n

    @property
    def n_lookups(self):
        return self.batch * self.n_tables * self.n_sparse

    @property
    def n_updated_rows(self):
        # distinct rows updated a batch (zipf's in-batch dedup, about 0.25)
        return int(self.n_lookups * 0.25)

    @property
    def vec_bytes(self):
        return 4 * self.dim

    @property
    def reduced_bytes(self):
        """Bytes across the link after the near-data reduction: B x T x dim."""
        return self.batch * self.n_tables * self.vec_bytes

    @property
    def raw_bytes(self):
        """Bytes across the link without the near-data reduction."""
        return self.n_lookups * self.vec_bytes

    @property
    def embed_flops(self):
        return self.n_lookups * self.dim * 2   # the bags' adds


RMS = {
    "RM1": RMWorkload("RM1", 32, 20, 80, (13, 8192, 2048, 32), (64, 1)),
    "RM2": RMWorkload("RM2", 32, 80, 80, (13, 8192, 2048, 32), (128, 1)),
    "RM3": RMWorkload("RM3", 32, 20, 20, (13, 10240, 4096, 32), (128, 1)),
    "RM4": RMWorkload("RM4", 16, 52, 1, (13, 16384, 2048, 512, 16), (128, 1)),
}
