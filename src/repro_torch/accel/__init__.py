"""Accelerator backends, as :class:`~repro_torch.accel.target.AcceleratorTarget`
plugins + the custom-numerics library.

Importing this package registers the ported targets with the core registry
(``repro_torch.core.ila.TARGETS``). FlexASR is ported; HLSCNN, VTA and
VecUnit are not yet.
"""
from . import flexasr, target  # noqa: F401
