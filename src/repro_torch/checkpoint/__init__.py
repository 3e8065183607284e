"""Checkpointing (``repro_torch.checkpoint.manager``), ported from ``repro.checkpoint``."""
