"""Device resolution: the one place every entry point passes through.

``resolve(None)`` means the GPU. A host without CUDA raises instead of
falling back to the CPU; callers that want the CPU (the tests) say so.

Resolving a CUDA device also turns TF32 off for matrix products and
convolutions: the FlexASR linear product and the fused plain leg are fp32
``torch.matmul`` products that the reference leaves to XLA in full fp32, and
TF32 would round their operands to 10 mantissa bits.

:func:`deterministic` makes a block of work reproducible run to run on the
card (training uses it).
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Union

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


#: cuBLAS's workspace setting for reproducible results across streams
CUBLAS_WORKSPACE = ("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """Deterministic algorithms and cuDNN for the block
    (``torch.use_deterministic_algorithms(True)``, ``cudnn.deterministic``,
    no ``cudnn.benchmark``); an op without a deterministic implementation
    raises. The caller's settings come back on exit.

    cuBLAS gives the same bits run to run on one stream; PyTorch's
    deterministic mode also asks for ``CUBLAS_WORKSPACE_CONFIG``, which the
    block sets unless the caller did and removes again on exit. Set for a
    whole process it slows cuBLAS everywhere else, such as LM decode."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark)
    name, value = CUBLAS_WORKSPACE
    set_env = name not in os.environ
    if set_env:
        os.environ[name] = value
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.deterministic, cudnn.benchmark = saved[2], saved[3]
        if set_env:
            os.environ.pop(name, None)
