"""FlashAttention with GQA and causal masking: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``. The
kernel is ``csrc/flash_attention.cu`` (its header says what bounds it and the
later design); its plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The wrapper takes the Pallas kernel's layout, q (B, Hq, S, D) and k, v
(B, Hkv, Sk, D), at any strides with a unit head-dim stride: a model's
(B, S, H, D) activations pass as ``x.transpose(1, 2)`` views, with no copy.
The output is laid out (B, S, Hq, D) in memory and returned as a
(B, Hq, S, D) view, so ``out.transpose(1, 2)`` is contiguous again. Unlike
the Pallas wrapper nothing is padded: ragged S and Sk are masked in the
kernel, and padded keys never get weight.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version.
``flash_attention.launches`` counts kernel launches (never the plain
version's calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the largest head dim the kernel takes (Gemma's 256)
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {like.dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} has {t.dim()} dims, expected 4")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a unit head-dim stride, "
                         f"got strides {t.stride()}")


def _strides(t: torch.Tensor):
    """(batch, sequence, head) element strides of a (B, H, S, D) view."""
    return [t.stride(0), t.stride(2), t.stride(1)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, Hq, S, D) x (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's dtype.

    Query head h reads KV head ``h // (Hq // Hkv)``; ``causal`` masks
    ``q_idx < k_idx`` (aligned top-left, as the Pallas kernel).
    """
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() > 0:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, Hq, Hkv, S, Sk, D,
                *_strides(q), *_strides(k), *_strides(v), *_strides(out),
                1.0 / D ** 0.5, int(causal), stream)
        if err != 0:
            msg = lib.flash_attention_error_string(err).decode()
            raise RuntimeError(f"flash_attention launch failed: {msg} (cudaError {err})")
        flash_attention.launches += 1
    return out


#: kernel launches since the counter was last set to 0
flash_attention.launches = 0
