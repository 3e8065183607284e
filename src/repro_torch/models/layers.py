"""Shared model layers: norms, rotary, GQA/MLA attention, GLU MLPs, MoE.

Port of ``repro/models/layers.py``. Conventions as there: activations x are
(B, S, D), attention tensors (B, S, H, Dh), dense weights (d_in, d_out) used
as ``x @ W``; fp32 norms, softmax and router.

Where attention goes:

* :func:`sdpa` (no cache: the training-style forward, the Whisper encoder
  and cross-attention) calls the hand-written ``flash_attention`` kernel for
  every length. The reference switches between ``_sdpa_dense`` and
  ``_sdpa_chunked`` at ``CHUNK_THRESHOLD``; both compute the kernel's
  function, so there is no switch here.
* :func:`gqa_attention` with a cache at ``cache_pos == 0`` (prefill) runs
  the kernel on the fresh k, v of length S, then writes them into the
  cache. The reference's ``_sdpa_dense`` over the whole ``max_len`` cache
  gives the same function: every slot past S is masked to -1e30 there, and
  its weight ``exp(-1e30 - m)`` is exactly 0 in fp32.
* Decode (``cache_pos > 0``) is the plain :func:`_sdpa_dense` in torch ops:
  the kernel has no query offset, and the reference does not use it there
  either. So is MLA's absorbed cache path (prefill and decode alike),
  which attends in the compressed latent space (head dim kv_lora + rope,
  576 at full width, beyond the kernel's 256).

Dropped from the reference, because one device has nothing to shard or
account: the mesh hints (``hint``, ``hint_heads``, ``mesh_hints``) and
``accounting_unroll``/``scan_unroll``. The chunked attention path and the
remat (``jax.checkpoint``) wrappers go with the switch above.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ArchConfig

MOE_GROUP = 32_768   # max tokens dispatched per group (bounds E*C*D buffer)


def rms_norm(x, gamma, eps=1e-5):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * gamma.float()).to(x.dtype)


def rotary(x, positions, theta=10_000.0):
    """x: (..., S, H, Dh) with positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(name):
    return {"silu": F.silu, "gelu": _gelu_tanh, "geglu": _gelu_tanh}[name]


# ---------------------------------------------------------------------------
# initialization helpers (a torch.Generator in place of a JAX key; the two
# give different numbers from one seed, so tests load the reference's
# weights through ``api.params_from_numpy``)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """fp32 standard normals on the generator's device, scaled, cast."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
            * scale).to(dtype)


def ones(d, dtype, gen: torch.Generator) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=gen.device)


def dense_init(gen: torch.Generator, d_in, d_out, dtype=torch.bfloat16):
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_params(cfg: ArchConfig, gen: torch.Generator,
                     dtype=torch.bfloat16) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    if cfg.use_mla:
        return {
            "q_down": dense_init(gen, d, cfg.q_lora_rank, dtype),
            "q_up": dense_init(gen, cfg.q_lora_rank, cfg.n_heads * (hd + cfg.rope_head_dim), dtype),
            "kv_down": dense_init(gen, d, cfg.kv_lora_rank + cfg.rope_head_dim, dtype),
            "kv_up": dense_init(gen, cfg.kv_lora_rank, cfg.n_heads * 2 * hd, dtype),
            "o": dense_init(gen, cfg.n_heads * hd, d, dtype),
            "q_norm": ones(cfg.q_lora_rank, dtype, gen),
            "kv_norm": ones(cfg.kv_lora_rank, dtype, gen),
        }
    return {
        "q": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "k": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "v": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "o": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }


def _sdpa_dense(q, k, v, causal, q_offset=0):
    """q: (B,S,H,Dh), k/v: (B,Sk,Hkv,Dh). Materializes (S,Sk) scores."""
    S, H, Dh = q.shape[1:]
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(Dh)
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(~(qi >= ki), -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def sdpa(q, k, v, causal=True):
    """Attention through the flash_attention kernel, (B, S, H, Dh) layout.

    q/k share Dh; v may have a smaller head dim (MLA: qk 192, v 128): it is
    zero-padded to q's, and the zero output columns are sliced off (exact).
    """
    dv = v.shape[-1]
    if dv < q.shape[-1]:
        v = F.pad(v, (0, q.shape[-1] - dv))
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal).transpose(1, 2)
    return out[..., :dv]


def gqa_attention(cfg: ArchConfig, p, x, positions, causal=True, cache=None, cache_pos=None):
    """Returns (out, cache). cache: dict(k, v) of (B, S_max, Hkv, Dh),
    written in place."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = rotary((x @ p["q"]).reshape(B, S, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rotary((x @ p["k"]).reshape(B, S, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    v = (x @ p["v"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cache is not None:
        k, v = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        if cache_pos == 0:
            out = sdpa(q, k, v, causal=True)
        else:
            out = _sdpa_dense(q, cache["k"], cache["v"], causal=True, q_offset=cache_pos)
    else:
        out = sdpa(q, k, v, causal=causal)
    return out.reshape(B, S, cfg.n_heads * hd) @ p["o"], cache


def mla_attention(cfg: ArchConfig, p, x, positions, causal=True, cache=None, cache_pos=None):
    """DeepSeek MLA. The cache stores the *compressed* c_kv (+ rope key),
    written in place; with a cache, attention runs absorbed in the latent
    space (plain ops), without one through :func:`sdpa`."""
    B, S, _ = x.shape
    hd, rd = cfg.hd, cfg.rope_head_dim
    H = cfg.n_heads
    cq = rms_norm(x @ p["q_down"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["q_up"]).reshape(B, S, H, hd + rd)
    q_nope, q_rope = q[..., :hd], rotary(q[..., hd:], positions, cfg.rope_theta)

    ckv_full = x @ p["kv_down"]                          # (B,S,kv_lora+rd)
    c_kv = ckv_full[..., : cfg.kv_lora_rank]
    k_rope = rotary(ckv_full[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        cc[:, cache_pos:cache_pos + S] = c_kv.to(cc.dtype)
        cr[:, cache_pos:cache_pos + S] = k_rope.to(cr.dtype)
        kv_up = p["kv_up"].reshape(cfg.kv_lora_rank, H, 2, hd)
        w_uk = kv_up[:, :, 0].permute(1, 0, 2)            # (H, kv_lora, hd)
        w_uv = kv_up[:, :, 1].permute(1, 0, 2)            # (H, kv_lora, hd)
        c_n = rms_norm(cc, p["kv_norm"], cfg.norm_eps)    # (B, Sc, kv_lora)
        q_lat = torch.einsum("bshd,hkd->bshk", q_nope, w_uk.to(q_nope.dtype))
        scale = 1.0 / math.sqrt(hd + rd)
        s_lat = torch.einsum("bshk,btk->bhst", q_lat, c_n) * scale
        s_rope = torch.einsum("bshr,btr->bhst", q_rope, cr.to(q_rope.dtype)) * scale
        scores = (s_lat + s_rope).float()
        ti = torch.arange(cc.shape[1], device=x.device)[None, None, None, :]
        qi = torch.arange(S, device=x.device)[None, None, :, None] + cache_pos
        scores = scores.masked_fill(~(qi >= ti), -1e30)
        pr = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btk->bshk", pr.to(c_n.dtype), c_n)
        out = torch.einsum("bshk,hkd->bshd", ctx, w_uv.to(ctx.dtype))
        return out.reshape(B, S, H * hd) @ p["o"], cache
    c_n = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    kv = (c_n @ p["kv_up"]).reshape(B, -1, H, 2 * hd)
    k_nope, v = kv[..., :hd], kv[..., hd:]
    k_rope_b = k_rope[:, :, None, :].expand(k_nope.shape[:3] + (rd,))
    k_full = torch.cat([k_nope, k_rope_b.to(k_nope.dtype)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(q_full, k_full, v, causal=causal)
    return out.reshape(B, S, H * hd) @ p["o"], None


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_params(cfg: ArchConfig, gen: torch.Generator, d_ff=None, dtype=torch.bfloat16):
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, cfg.d_model, d_ff, dtype),
        "w_up": dense_init(gen, cfg.d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, cfg.d_model, dtype),
    }


def glu_mlp(cfg: ArchConfig, p, x):
    return (_act(cfg.act)(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (sort-based token-choice dispatch with capacity)
# ---------------------------------------------------------------------------


def moe_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert_ff
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": normal(gen, (d, E), scale, torch.float32),
        "w_gate": normal(gen, (E, d, f), scale, dtype),
        "w_up": normal(gen, (E, d, f), scale, dtype),
        "w_down": normal(gen, (E, f, d), 1.0 / math.sqrt(f), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(cfg, gen, d_ff=cfg.n_shared_experts * cfg.d_expert_ff,
                                 dtype=dtype)
    return p


def moe_ffn(cfg: ArchConfig, p, x):
    """x: (B,S,D) -> (B,S,D). Token-choice top-k with capacity dropping,
    dispatched in groups of MOE_GROUP tokens where the reference does."""
    B, S, D = x.shape
    T_all = B * S
    x2 = x.reshape(T_all, D)
    if T_all > MOE_GROUP and T_all % MOE_GROUP == 0:
        groups = [_moe_group(cfg, p, g) for g in x2.split(MOE_GROUP)]
        return torch.cat(groups).reshape(B, S, D)
    return _moe_group(cfg, p, x2).reshape(B, S, D)


def _moe_group(cfg: ArchConfig, p, x2):
    T, D = x2.shape
    E, K = cfg.n_experts, cfg.top_k
    scores = torch.softmax(x2.float() @ p["router"], dim=-1)
    gvals, gidx = torch.topk(scores, K, dim=-1)                 # (T,K)
    gvals = (gvals / gvals.sum(dim=-1, keepdim=True)).to(x2.dtype)

    SL = T * K
    C = max(8, int(cfg.capacity_factor * SL / E))
    flat_e = gidx.reshape(SL)
    perm = torch.argsort(flat_e, stable=True)                   # jnp.argsort is stable
    sorted_e = flat_e[perm]
    tok = perm // K
    pos = torch.arange(SL, device=x2.device) - torch.searchsorted(sorted_e, sorted_e,
                                                                  side="left")
    keep = pos < C
    dest = torch.where(keep, sorted_e * C + pos, torch.full_like(pos, E * C))  # drop slot
    buf = torch.zeros((E * C + 1, D), dtype=x2.dtype, device=x2.device)
    buf.index_add_(0, dest, x2[tok])
    xe = buf[: E * C].reshape(E, C, D)

    act = _act(cfg.act)
    h = act(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, p["w_up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * C, D)
    ye = torch.cat([ye, ye.new_zeros((1, D))])

    contrib = ye[dest] * gvals.reshape(SL)[perm][:, None] * keep[:, None].to(x2.dtype)
    out = torch.zeros((T, D), dtype=x2.dtype, device=x2.device).index_add_(0, tok, contrib)
    if cfg.n_shared_experts:
        out = out + glu_mlp(cfg, p["shared"], x2)
    return out
