"""Examples of the port (counterparts of the JAX package's ``examples/``).

Each runs as ``python -m repro_torch.examples.<name>`` with ``PYTHONPATH=src``
and takes ``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
versions):

    fault_tolerance_demo  crash drills over the pmem and dram pools, bitwise
                          recovery against a clean replay, resume
    train_dlrm_e2e        a ~100M-param DLRM, checkpointed, crash and resume
    quickstart            a smoke LM trained relaxed and strict, then decoded
    serve_batched         prefill and stepped decode of a smoke LM
"""
