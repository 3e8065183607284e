"""Model zoo: the 10 assigned architectures behind one API
(``repro_torch.models.api``), ported from ``repro.models``."""
