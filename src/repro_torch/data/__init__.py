"""Token pipelines (``repro_torch.data.pipeline``), ported from ``repro.data``."""
