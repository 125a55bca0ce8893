"""Two-tier checkpointing over the emulated pool (counterpart of ``repro.core.checkpoint``)."""
