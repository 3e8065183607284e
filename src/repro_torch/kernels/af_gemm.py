"""AdaptivFloat quantized GEMM (the FlexASR PE array): the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/af_gemm.py``. The kernel is
``csrc/af_gemm.cu`` (its header gives the design and what bounds it); its
plain PyTorch version is :func:`repro_torch.kernels.ref.af_gemm_ref`.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version. One call makes
:data:`CUDA_LAUNCHES` CUDA launches (quantize every operand element once
into scratch, then the product). ``af_gemm.launches`` counts calls that
reach the card, one per GEMM (never the plain version's calls).
"""
from __future__ import annotations

import ctypes

import torch

from ..accel.numerics import AdaptivFloatSpec
from . import build, ref

_SPEC = AdaptivFloatSpec(8, 3)
#: CUDA launches per call on the card: the quantize pass, then the product
CUDA_LAUNCHES = 2
#: the widest exponent field whose window (2^n_exp powers) the kernel holds
MAX_N_EXP = 5
_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load("af_gemm")
    if lib.af_gemm_launch.argtypes is None:
        lib.af_gemm_launch.argtypes = _ARGTYPES
        lib.af_gemm_launch.restype = ctypes.c_int
        lib.af_gemm_error_string.argtypes = [ctypes.c_int]
        lib.af_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _bias_vec(v, B: int, device: torch.device):
    """An exponent bias as a contiguous fp32 device vector and its batch
    stride: one value shared by the batch (stride 0) or one per sample."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).contiguous()
    if t.numel() not in (1, B):
        raise ValueError(f"exponent bias has {t.numel()} values for a batch of {B}")
    return t, (0 if t.numel() == 1 else 1)


def _check(name: str, t: torch.Tensor, device: torch.device, dims) -> None:
    if t.device != device:
        raise ValueError(f"af_gemm: {name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"af_gemm: {name} must be float32, got {t.dtype}")
    if t.dim() not in dims:
        raise ValueError(f"af_gemm: {name} has {t.dim()} dims, expected one of {dims}")
    if not t.is_contiguous():
        raise ValueError(f"af_gemm: {name} must be contiguous")


def af_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    exp_bias_x,
    exp_bias_w,
    exp_bias_o,
    *,
    spec: AdaptivFloatSpec = _SPEC,
) -> torch.Tensor:
    """``AFq_o(AFq_x(x) @ AFq_w(w)^T + b)`` in fp32.

    x: (M, K) or (B, M, K); w: (N, K) or (B, N, K); b: (N,) or (B, N), the
    unbatched ones shared across the batch. Exponent biases are numbers or
    tensors with one value or one per sample. Returns (M, N) or (B, M, N).
    """
    if x.device.type == "cpu":
        return ref.af_gemm_ref(x, w, b, exp_bias_x, exp_bias_w, exp_bias_o, spec)
    if x.device.type != "cuda":
        raise ValueError(f"af_gemm: no kernel for device {x.device}")
    if spec.n_exp > MAX_N_EXP:
        raise ValueError(f"af_gemm: n_exp {spec.n_exp} > {MAX_N_EXP}, the kernel's window")
    dev = x.device
    _check("x", x, dev, (2, 3))
    _check("w", w, dev, (2, 3))
    _check("b", b, dev, (1, 2))
    batched = x.dim() == 3
    B = x.shape[0] if batched else 1
    M, K = x.shape[-2:]
    N = w.shape[-2]
    if w.shape[-1] != K or b.shape[-1] != N:
        raise ValueError(f"af_gemm: shapes x{tuple(x.shape)} w{tuple(w.shape)} b{tuple(b.shape)}")
    for name, t, nd in (("w", w, 3), ("b", b, 2)):
        if t.dim() == nd and t.shape[0] != B:
            raise ValueError(f"af_gemm: {name} batch {t.shape[0]} != x batch {B}")
    w_bs = N * K if w.dim() == 3 else 0
    b_bs = N if b.dim() == 2 else 0
    bx, bx_bs = _bias_vec(exp_bias_x, B, dev)
    bw, bw_bs = _bias_vec(exp_bias_w, B, dev)
    bo, bo_bs = _bias_vec(exp_bias_o, B, dev)
    out = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    if B * M * N > 0:
        lib = _lib()
        # lattice scratch, k-major, rows padded to multiples of 4; w once, or
        # per sample when its bias is per sample
        mp, np_ = -(-M // 4) * 4, -(-N // 4) * 4
        bq = 1 if w_bs == 0 and bw_bs == 0 else B
        xq = torch.empty((B * K * mp,), dtype=torch.float32, device=dev)
        wq = torch.empty((bq * K * np_,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.af_gemm_launch(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), bx.data_ptr(),
                bw.data_ptr(), bo.data_ptr(), out.data_ptr(), xq.data_ptr(),
                wq.data_ptr(), B, M, N, K,
                M * K, w_bs, b_bs, bx_bs, bw_bs, bo_bs, spec.n_exp, spec.n_man,
                stream,
            )
        if err != 0:
            msg = lib.af_gemm_error_string(err).decode()
            raise RuntimeError(f"af_gemm launch failed: {msg} (cudaError {err})")
        af_gemm.launches += 1
    return out if batched else out[0]


#: calls that reached the card since the counter was last set to 0
af_gemm.launches = 0
