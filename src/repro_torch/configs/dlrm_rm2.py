"""dlrm-rm2 — paper Table 3 [arXiv:1906.00091 + DeepRecSys]"""
from repro_torch.configs import base


def full() -> base.ArchBundle:
    m = base.ModelConfig(
        name="dlrm-rm2", family="recsys", arch_type="dlrm",
        num_layers=0, d_model=32, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=0,
        dlrm_bottom_mlp=(13, 8192, 2048, 32), dlrm_top_mlp=(128, 1),
        dlrm_num_tables=80, dlrm_num_sparse=80,
        dlrm_rows_per_table=1000000, dlrm_num_dense=13,
        source="paper Table 3")
    return base.ArchBundle(model=m)

def smoke() -> base.ArchBundle:
    b = full()
    return base.ArchBundle(
        model=b.model.replace(dlrm_rows_per_table=2048,
                              dlrm_bottom_mlp=(13, 64, 32),
                              dlrm_top_mlp=(32, 1),
                              dtype="float32", remat=False))
