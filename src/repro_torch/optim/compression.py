"""Gradient compression with error feedback (cross-pod DP traffic saver).

Port of ``repro/optim/compression.py``: int8 block-quantized gradients
with a residual ("error feedback") carried in optimizer state:
compress(g + residual) is what travels; the quantization error is added
back next step, so the scheme is unbiased in the long run (Seide et al. /
Karimireddy et al.). ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 codes equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (q int8, scales f32)."""
    flat = g.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def error_feedback_update(g: torch.Tensor, residual: torch.Tensor):
    """Quantize (g + residual); return (dequantized value, new residual)."""
    target = g.float() + residual
    q, s = compress_int8(target)
    deq = decompress_int8(q, s, g.shape)
    return deq.to(g.dtype), target - deq
