"""State-space model blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

Port of ``repro/models/ssm.py``. The reference's ``lax.scan`` over time
(Mamba1) and over chunks (Mamba2's inter-chunk recurrence) are Python loops
here. The reference splits the Mamba1 scan into remat'd chunks of
``SSM_CHUNK`` steps to bound backward memory; the steps and their order are
the same either way, so this port scans step by step. Mamba2 keeps the SSD
chunked matmul form (Dao & Gu, 2024) with chunks of ``SSM_CHUNK``.

States are returned as new tensors; the model writes them into its cache
in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import dense_init, normal, ones

SSM_CHUNK = 256


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def mamba1_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Dict[str, Any]:
    d, di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype),
        "conv_w": normal(gen, (cfg.d_conv, di), 0.2, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, R + 2 * N, dtype),
        "dt_proj": dense_init(gen, R, di, dtype),
        "dt_bias": torch.full((di,), -2.0, dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)).repeat(di, 1),
        "D": ones(di, torch.float32, gen),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _causal_conv1d(x, w, b, state=None):
    """x: (B,S,di); w: (K,di). Returns (y, new_state) with state (B,K-1,di)."""
    B, S, di = x.shape
    K = w.shape[0]
    pad = x.new_zeros((B, K - 1, di)) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, S:, :] if S >= K - 1 else xp[:, -(K - 1):, :]
    return y + b[None, None, :], new_state


def mamba1_scan(p, x, h0=None):
    """Selective scan. x: (B,S,di) post-conv/act. Returns (y, h_final),
    h: (B, di, N) fp32."""
    B, S, di = x.shape
    N = p["A_log"].shape[1]
    R = p["dt_proj"].shape[0]
    A = -torch.exp(p["A_log"])                                  # (di,N)

    proj = x @ p["x_proj"]                                      # (B,S,R+2N)
    dt = F.softplus(proj[..., :R].float() @ p["dt_proj"].float() + p["dt_bias"])
    Bm = proj[..., R:R + N].float()                             # (B,S,N)
    Cm = proj[..., R + N:].float()                              # (B,S,N)
    xf = x.float()

    h = x.new_zeros((B, di, N), dtype=torch.float32) if h0 is None else h0
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A[None])             # (B,di,N)
        dBx = dt[:, t, :, None] * Bm[:, t, None, :] * xf[:, t, :, None]
        h = h * dA + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + xf * p["D"][None, None, :]
    return y.to(x.dtype), h


def mamba1_block(cfg: ArchConfig, p, x, state=None):
    """Full block: in_proj -> conv -> silu -> SSM -> gate -> out_proj.

    state: None (train/prefill) or dict(conv, h) for decode.
    """
    xz = x @ p["in_proj"]
    di = cfg.d_inner
    xs, z = xz[..., :di], xz[..., di:]
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    h0 = None if state is None else state["h"]
    y, h = mamba1_scan(p, xc, h0)
    y = y * F.silu(z)
    return y @ p["out_proj"], {"conv": new_conv, "h": h}


def mamba1_init_state(cfg: ArchConfig, batch, dtype=torch.bfloat16, device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


# ---------------------------------------------------------------------------
# Mamba2 (SSD chunked form)
# ---------------------------------------------------------------------------


def mamba2_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Dict[str, Any]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    dev = gen.device
    return {
        # projections for x, z, B, C, dt in one matmul (mamba2 style)
        "in_proj": dense_init(gen, d, 2 * di + 2 * N + H, dtype),
        "conv_w": normal(gen, (cfg.d_conv, di + 2 * N), 0.2, dtype),
        "conv_b": torch.zeros((di + 2 * N,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), -2.0, dtype=torch.float32, device=dev),
        "D": ones(H, torch.float32, gen),
        "norm_g": ones(di, dtype, gen),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _segsum(a):
    """a: (..., c) log-decays -> (..., c, c) lower-tri cumulative sums."""
    c = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def mamba2_ssd(x, a_log, Bm, Cm, h0=None, chunk=SSM_CHUNK):
    """SSD chunked scan.

    x:  (B, S, H, P)   values
    a_log: (B, S, H)   per-step log decay (<= 0)
    Bm, Cm: (B, S, N)  input/output projections (shared across heads)
    h0: (B, H, P, N) initial state
    Returns (y: (B,S,H,P), h_final).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    nc = S // c
    xr = x.reshape(Bsz, nc, c, H, P)
    ar = a_log.reshape(Bsz, nc, c, H)
    Br = Bm.reshape(Bsz, nc, c, N)
    Cr = Cm.reshape(Bsz, nc, c, N)

    # intra-chunk (diagonal block): y_intra[t] = sum_{s<=t} C_t.B_s prod decay
    L = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))               # (B,nc,H,c,c)
    scores = torch.einsum("bnck,bnsk->bncs", Cr, Br)             # (B,nc,c,c)
    y_intra = torch.einsum("bncs,bnhcs,bnshp->bnchp", scores, L.to(scores.dtype), xr)

    # chunk states: state_n = sum_s B_s x_s prod_{s..end} decay
    cum = torch.cumsum(ar, dim=2)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,c,H)
    states = torch.einsum("bnsk,bnsh,bnshp->bnhpk", Br, decay_to_end.to(Br.dtype), xr)

    # inter-chunk recurrence over nc: emit the state *before* each chunk
    chunk_decay = torch.exp(ar.sum(dim=2))                       # (B,nc,H)
    h = x.new_zeros((Bsz, H, P, N)) if h0 is None else h0
    prefix = []
    for n in range(nc):
        prefix.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prefix = torch.stack(prefix, dim=1)                        # (B,nc,H,P,N)

    # contribution of carried state into each chunk position
    decay_from_start = torch.exp(cum)                            # (B,nc,c,H)
    y_inter = torch.einsum("bnck,bnhpk,bnch->bnchp", Cr, h_prefix,
                           decay_from_start.to(Cr.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def mamba2_block(cfg: ArchConfig, p, x, state=None):
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    proj = x @ p["in_proj"]
    z = proj[..., :di]
    xBC = proj[..., di:2 * di + 2 * N]
    dt_raw = proj[..., 2 * di + 2 * N:]                          # (B,S,H)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + N].float()
    Cm = xBC[..., di + N:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,S,H)
    a_log = -torch.exp(p["A_log"])[None, None, :] * dt           # (B,S,H) <= 0
    h0 = None if state is None else state["h"]
    # ZOH discretization: h = exp(dt*A) h + dt * B x  (input absorbs dt)
    y, hT = mamba2_ssd(xs.float() * dt[..., None], a_log, Bm, Cm, h0)
    y = y + xs.float() * p["D"][None, None, :, None]             # skip path
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2)
    y = y * F.silu(z.float())
    rms = torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-5)
    y = (y * rms * p["norm_g"].float()).to(x.dtype)
    return y @ p["out_proj"], {"conv": new_conv, "h": hT.float()}


def mamba2_init_state(cfg: ArchConfig, batch, dtype=torch.bfloat16, device=None):
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * N), dtype=dtype, device=device),
        "h": torch.zeros((batch, H, cfg.ssm_head_dim, N), dtype=torch.float32, device=device),
    }
