"""Device resolution: the one place every entry point passes through.

``resolve(None)`` means the GPU. A host without CUDA raises instead of
falling back to the CPU; callers that want the CPU (the tests) say so.

Resolving a CUDA device also turns TF32 off for matrix products and
convolutions: the FlexASR linear product and the fused plain leg are fp32
``torch.matmul`` products that the reference leaves to XLA in full fp32, and
TF32 would round their operands to 10 mantissa bits.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (``None`` -> ``"cuda"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run on the CPU"
            )
        disable_tf32()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tf32_off() -> bool:
    """True when neither matmul nor cuDNN may use TF32."""
    return not (
        torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    )
