"""Fixed-point quantized GEMM (the HLSCNN conv PE array): the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/fx_gemm.py``. The kernel is
``csrc/fx_gemm.cu`` (its header gives the design and what bounds it); its
plain PyTorch version is :func:`repro_torch.kernels.ref.fx_gemm_ref`.
Both accumulate exactly (the plain version in float64; the kernel splits
each lattice integer into two bytes, multiplies them on the int8 tensor
cores and adds the exact sums of its K slices in float64), so they agree
bit for bit at every shape the wrapper accepts.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version. One call is
:data:`CUDA_LAUNCHES` CUDA launch (clusters of eight K-slice blocks that
combine their partial sums in shared memory). ``fx_gemm.launches`` counts
calls that reach the card (never the plain version's calls).
"""
from __future__ import annotations

import ctypes

import torch

from ..accel.numerics import FixedPointSpec
from . import build, ref

#: CUDA launches per call on the card
CUDA_LAUNCHES = 1
#: widest operand the kernel takes: it multiplies a signed high byte and an
#: unsigned low byte of each lattice integer on the int8 tensor cores
MAX_BITS = 16
_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    + [ctypes.c_float] * 9 + [ctypes.c_double, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load("fx_gemm")
    if lib.fx_gemm_launch.argtypes is None:
        lib.fx_gemm_launch.argtypes = _ARGTYPES
        lib.fx_gemm_launch.restype = ctypes.c_int
        lib.fx_gemm_error_string.argtypes = [ctypes.c_int]
        lib.fx_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, dims) -> None:
    if t.device != device:
        raise ValueError(f"fx_gemm: {name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"fx_gemm: {name} must be float32, got {t.dtype}")
    if t.dim() not in dims:
        raise ValueError(f"fx_gemm: {name} has {t.dim()} dims, expected one of {dims}")
    if not t.is_contiguous():
        raise ValueError(f"fx_gemm: {name} must be contiguous")


def check_exact(K: int, x_spec: FixedPointSpec, w_spec: FixedPointSpec) -> None:
    """Raise unless a sum of ``K`` lattice products is exact in float64:
    ``K * 2^(bx-1) * 2^(bw-1) < 2^53``."""
    if K * 2 ** (x_spec.n_bits - 1) * 2 ** (w_spec.n_bits - 1) >= 2 ** 53:
        raise ValueError(
            f"fx_gemm: K={K} with {x_spec.n_bits}- and {w_spec.n_bits}-bit operands "
            "overflows an exact float64 sum")


def _spec_args(spec: FixedPointSpec):
    return [spec.scale, float(spec.qmin), float(spec.qmax)]


def fx_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    x_spec: FixedPointSpec,
    w_spec: FixedPointSpec,
    o_spec: FixedPointSpec,
) -> torch.Tensor:
    """``FXq_o(FXq_x(x) @ FXq_w(w)^T)`` in fp32, summed exactly.

    x: (M, K) or (B, M, K); w: (N, K) or (B, N, K), an unbatched weight
    shared across the batch. Returns (M, N) or (B, M, N).
    """
    check_exact(x.shape[-1], x_spec, w_spec)
    if x.device.type == "cpu":
        return ref.fx_gemm_ref(x, w, x_spec, w_spec, o_spec)
    if x.device.type != "cuda":
        raise ValueError(f"fx_gemm: no kernel for device {x.device}")
    dev = x.device
    _check("x", x, dev, (2, 3))
    _check("w", w, dev, (2, 3))
    batched = x.dim() == 3
    B = x.shape[0] if batched else 1
    M, K = x.shape[-2:]
    N = w.shape[-2]
    if w.shape[-1] != K:
        raise ValueError(f"fx_gemm: shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if w.dim() == 3 and w.shape[0] != B:
        raise ValueError(f"fx_gemm: w batch {w.shape[0]} != x batch {B}")
    if max(x_spec.n_bits, w_spec.n_bits) > MAX_BITS:
        raise ValueError(f"fx_gemm: the kernel splits operands of at most {MAX_BITS} bits "
                         f"into two bytes, got {x_spec.n_bits} and {w_spec.n_bits}")
    w_bs = N * K if w.dim() == 3 else 0
    out = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    if B * M * N > 0:
        lib = _lib()
        inv_xw = 2.0 ** -(x_spec.n_frac + w_spec.n_frac)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fx_gemm_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), B, M, N, K, M * K, w_bs,
                *_spec_args(x_spec), *_spec_args(w_spec), *_spec_args(o_spec), inv_xw,
                stream,
            )
        if err != 0:
            msg = lib.fx_gemm_error_string(err).decode()
            raise RuntimeError(f"fx_gemm launch failed: {msg} (cudaError {err})")
        fx_gemm.launches += 1
    return out if batched else out[0]


#: calls that reached the card since the counter was last set to 0
fx_gemm.launches = 0
