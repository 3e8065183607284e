"""Accelerator backends, as :class:`~repro_torch.accel.target.AcceleratorTarget`
plugins + the custom-numerics library.

Importing this package registers the bundled targets with the core registry
(``repro_torch.core.ila.TARGETS``), in the reference's order: FlexASR,
HLSCNN, VecUnit, VTA.
"""
from . import flexasr, hlscnn, target, vecunit, vta  # noqa: F401
