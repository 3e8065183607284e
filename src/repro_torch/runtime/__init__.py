"""The fault-tolerant training driver (``repro_torch.runtime.trainer``), ported from
``repro.runtime``."""
