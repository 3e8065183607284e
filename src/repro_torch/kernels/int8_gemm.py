"""int8 x int8 -> int32 GEMM (the VTA GEMM core): the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/int8_gemm.py``. The kernel is
``csrc/int8_gemm.cu`` (int8 ``mma.sync`` on fragments loaded straight from
global memory, one round trip; its header says what bounds it);
its plain PyTorch version is :func:`repro_torch.kernels.ref.int8_gemm_ref`.
Both are exact, so they agree bit for bit.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version. ``int8_gemm.launches``
counts kernel launches (never the plain version's calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: int32 sums of int8 products (|a·b| <= 2^14) cannot overflow below this K
MAX_K = 2 ** 17 - 1

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_gemm")
    if lib.int8_gemm_launch.argtypes is None:
        lib.int8_gemm_launch.argtypes = _ARGTYPES
        lib.int8_gemm_launch.restype = ctypes.c_int
        lib.int8_gemm_empty_launch.argtypes = [ctypes.c_void_p]
        lib.int8_gemm_empty_launch.restype = ctypes.c_int
        lib.int8_gemm_error_string.argtypes = [ctypes.c_int]
        lib.int8_gemm_error_string.restype = ctypes.c_char_p
    return lib


def empty_launch() -> None:
    """Launch an empty kernel of int8_gemm's block shape on the current
    stream: the launch floor ``chip_smoke.py`` times the small GEMMs
    against. Counts no launch."""
    lib = _lib()
    err = lib.int8_gemm_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.int8_gemm_error_string(err).decode()
        raise RuntimeError(f"empty kernel launch failed: {msg} (cudaError {err})")


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"int8_gemm: {name} is on {t.device}, a on {device}")
    if t.dtype != torch.int8:
        raise TypeError(f"int8_gemm: {name} must be int8, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"int8_gemm: {name} has {t.dim()} dims, expected 2")
    if not t.is_contiguous():
        raise ValueError(f"int8_gemm: {name} must be contiguous")


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K) int8, b: (N, K) int8 -> (M, N) int32, exact."""
    if a.shape[-1] > MAX_K:
        raise ValueError(f"int8_gemm: K={a.shape[-1]} may overflow int32 sums")
    if a.device.type == "cpu":
        return ref.int8_gemm_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm: no kernel for device {a.device}")
    dev = a.device
    _check("a", a, dev)
    _check("b", b, dev)
    (M, K), N = a.shape, b.shape[0]
    if b.shape[1] != K:
        raise ValueError(f"int8_gemm: shapes a{tuple(a.shape)} b{tuple(b.shape)}")
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M * N > 0:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            # fragments load 16 bytes at a time where every row starts on 16
            wide = int(K % 16 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
            err = lib.int8_gemm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                       M, N, K, wide, stream)
        if err != 0:
            msg = lib.int8_gemm_error_string(err).decode()
            raise RuntimeError(f"int8_gemm launch failed: {msg} (cudaError {err})")
        int8_gemm.launches += 1
    return out


#: kernel launches since the counter was last set to 0
int8_gemm.launches = 0
