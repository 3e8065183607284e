"""FlashAttention with GQA and causal masking: the CUDA kernels' wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py`` with two
instantiations of one CUDA source (``csrc/flash_attention_sm90.cu``, whose
header says what bounds them), chosen by a fixed rule on the dtype
(:data:`DESIGNS`):

* ``"wgmma"`` for bfloat16: Q.K^T and P.V on Hopper's tensor cores, P split
  into three bf16 terms whose sum is the fp32 P exactly, K/V tiles staged
  by TMA;
* ``"wgmma3"`` for float32: a split pass writes q, k and v as three bf16
  terms each into scratch (exact, :func:`repro_torch.kernels.ref.bf16x3_split`),
  and the same kernel sums the six pairs of terms whose indices add to at
  most 2 in Q.K^T and in P.V; the three pairs it drops each weigh at most
  2^-24 of the product. Two CUDA launches a call. TF32 is never used.

Both compute the plain PyTorch version
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The wrapper takes the Pallas kernel's layout, q (B, Hq, S, D) and k, v
(B, Hkv, Sk, D), at any strides with a unit head-dim stride: a model's
(B, S, H, D) activations pass as ``x.transpose(1, 2)`` views, with no copy.
The output is laid out (B, S, Hq, D) in memory and returned as a
(B, Hq, S, D) view, so ``out.transpose(1, 2)`` is contiguous again. Unlike
the Pallas wrapper nothing is padded: ragged S and Sk are masked in the
kernels, and padded keys never get weight. The bf16 design reads its
operands through TMA tensor maps, which need more of them
(:func:`wgmma_refusal`); an input it refuses raises, and is never handed to
the other design or to the plain version. The fp32 design's maps read its
own aligned scratch, so it takes any strides with a unit head-dim stride.

On a CUDA tensor the wrapper launches a kernel on the current stream or
raises; on a CPU tensor it runs the plain version.
``flash_attention.launches`` counts kernel launches (never the plain
version's calls), and ``flash_attention.launches_by_design`` counts them per
design.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

#: the largest head dim either design takes (Gemma's 256)
MAX_HEAD_DIM = 256
#: the design each dtype takes on the card
DESIGNS = {torch.bfloat16: "wgmma", torch.float32: "wgmma3"}
#: CUDA launches one call of each design makes (the fp32 split pass + kernel)
CUDA_LAUNCHES = {"wgmma": 1, "wgmma3": 2}
_TAIL = [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
#: design -> (C entry point, its argument types)
_ENTRY = {
    "wgmma": ("flash_attention_sm90_launch",
              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + _TAIL),
    "wgmma3": ("flash_attention_sm90_fp32_launch",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + _TAIL),
}


def _lib(design: str):
    """(launch function, error-string function) of a design."""
    name, argtypes = _ENTRY[design]
    lib = build.load("flash_attention_sm90")
    launch, errstr = getattr(lib, name), lib.flash_attention_sm90_error_string
    if launch.argtypes is None:
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
    return launch, errstr


def _split_scratch(B: int, Hq: int, Hkv: int, S: int, Sk: int, D: int,
                   device: torch.device):
    """The fp32 design's bf16 scratch for the three terms of q, k and v,
    laid out (3, B, H, L, D8) each (D8: D rounded up to 8, so every row
    starts on 16 bytes), as three flat tensors."""
    d8 = -(-D // 8) * 8
    sizes = [3 * B * Hq * S * d8] + [3 * B * Hkv * Sk * d8] * 2
    return list(torch.empty(sum(sizes), dtype=torch.bfloat16, device=device).split(sizes))


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


def wgmma_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why the wgmma design cannot take these (B, H, S, D) operands, or None.

    Its preconditions: head dim D in 1..MAX_HEAD_DIM; for each of q, k and v
    a unit head-dim stride, a 16-byte aligned start (storage offset
    included) and (batch, head, sequence) strides that are multiples of 16
    bytes, except along a dimension of extent 1, which is never stepped.
    A TMA tensor map cannot be built otherwise.
    """
    D = q.shape[-1]
    if not 1 <= D <= MAX_HEAD_DIM:
        return f"head dim {D} outside 1..{MAX_HEAD_DIM}"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            return f"{name} needs a unit head-dim stride, got strides {t.stride()}"
        if t.data_ptr() % 16:
            return (f"{name} does not start on 16 bytes (storage offset "
                    f"{t.storage_offset()} elements)")
        for dim in range(3):
            if t.shape[dim] > 1 and t.stride(dim) * t.element_size() % 16:
                return (f"{name}'s stride {t.stride(dim)} along dim {dim} is not a multiple "
                        "of 16 bytes")
    return None


def _strides(t: torch.Tensor):
    """(batch, sequence, head) element strides of a (B, H, S, D) view."""
    return [t.stride(0), t.stride(2), t.stride(1)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """(B, Hq, S, D) x (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's dtype.

    Query head h reads KV head ``h // (Hq // Hkv)``; ``causal`` masks
    ``q_idx < k_idx`` (aligned top-left, as the Pallas kernel); the scores
    are scaled by ``scale`` (default ``1 / sqrt(D)``, the Pallas kernel's).
    """
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / D ** 0.5 if scale is None else float(scale)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    design = DESIGNS.get(q.dtype)
    if design is None:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if design == "wgmma":   # the fp32 design reads its own aligned scratch
        reason = wgmma_refusal(q, k, v)
        if reason is not None:
            raise ValueError(f"flash_attention: the wgmma design refuses bf16 input: {reason}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() > 0:
        launch, errstr = _lib(design)
        scratch = [] if design == "wgmma" else _split_scratch(B, Hq, Hkv, S, Sk, D, q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         *(t.data_ptr() for t in scratch), B, Hq, Hkv, S, Sk, D,
                         *_strides(q), *_strides(k), *_strides(v), *_strides(out),
                         scale, int(causal), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention ({design} design) launch failed: "
                               f"{errstr(err).decode()} (cudaError {err})")
        flash_attention.launches += 1
        flash_attention.launches_by_design[design] += 1
    return out


def reset_launches() -> None:
    """Set the total and the per-design launch counts to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_design = dict.fromkeys(sorted(set(DESIGNS.values())), 0)


#: kernel launches since the counter was last set to 0, in all and per design
reset_launches()
