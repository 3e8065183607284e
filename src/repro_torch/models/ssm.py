"""State-space model blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

Port of ``repro/models/ssm.py``. The reference's ``lax.scan`` over time
(Mamba1) and over chunks (Mamba2's inter-chunk recurrence) are Python loops
here; Mamba1's go through ``layers.scan``, which the dry-run may cut to a
few identical trips. Mamba1 scans in chunks of ``SSM_CHUNK`` steps where
that divides the length, else in one chunk, each chunk recomputed in
backward (``layers.recompute``), by the reference's rule (reference
ssm.py:92-110): autograd keeps the state at each chunk's start, and a
chunk's per-step states (``exp``'s output, ``dt * B``, the new state) are
rebuilt while that chunk's backward runs, not kept for every step. Mamba2
keeps the SSD chunked matmul form (Dao & Gu, 2024) with chunks of
``SSM_CHUNK``. On DTensors both scans run on each rank's own shard
(:func:`_selective_scan_local`, :func:`_ssd`).

States are returned as new tensors; the model writes them into its cache
in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .config import ArchConfig
from .layers import DP, dense_init, hint, local_work, normal, ones, recompute, scan, \
    shard_factor, split_heads

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
    h: (B, di, N) fp32. On DTensors the projections are DTensor ops and
    each rank scans its own shard (:func:`_selective_scan_local`)."""
    N = p["A_log"].shape[1]
    R = p["dt_proj"].shape[0]
    A = -torch.exp(p["A_log"])                                  # (di,N)

    proj = x @ p["x_proj"]                                      # (B,S,R+2N)
    if isinstance(proj, DTensor):
        # reduced over the channels once, before the slices: dt's product
        # then takes dt_proj's channel split, Bm and Cm stay whole there
        proj = hint(proj, DP, None, None)
    dt = F.softplus(proj[..., :R].float() @ p["dt_proj"].float() + p["dt_bias"])
    Bm = proj[..., R:R + N].float()                             # (B,S,N)
    Cm = proj[..., R + N:].float()                              # (B,S,N)
    scan_fn = _selective_scan_local if isinstance(x, DTensor) else _selective_scan
    y, h = scan_fn(x.float(), dt, Bm, Cm, A, p["D"], h0)
    return y.to(x.dtype), h


def _selective_scan(xf, dt, Bm, Cm, A, D, h0=None):
    """The scan over positions: xf, dt (B,S,di), Bm, Cm (B,S,N), A (di,N),
    D (di,), h0 (B,di,N) or None. Returns (y (B,S,di) fp32, h_final).

    The positions go in chunks of ``SSM_CHUNK`` steps when that divides S,
    else in one chunk of S (reference ssm.py:96-110); each chunk runs under
    ``layers.recompute``, so backward keeps the states at chunk boundaries
    and rebuilds a chunk's steps when it reaches them. Chunks and the steps
    within one go through ``layers.scan``."""
    B, S, di = xf.shape
    h = xf.new_zeros((B, di, A.shape[1])) if h0 is None else h0

    def step(h, inp):
        x_t, dt_t, B_t, C_t = inp
        dA = torch.exp(dt_t[..., None] * A[None])               # (B,di,N)
        dBx = dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
        h = h * dA + dBx
        return h, torch.einsum("bdn,bn->bd", h, C_t)

    def chunk(h, *seq):
        h, ys = scan(step, h, list(zip(*(t.unbind(1) for t in seq))))
        return h, torch.stack(ys, dim=1)

    steps = SSM_CHUNK if S % SSM_CHUNK == 0 else S
    chunks = zip(*(t.split(steps, dim=1) for t in (xf, dt, Bm, Cm)))
    h, ys = scan(lambda h, c: recompute(chunk, h, *c), h, list(chunks))
    return torch.cat(ys, dim=1) + xf * D[None, None, :], h


def _selective_scan_local(xf, dt, Bm, Cm, A, D, h0=None):
    """:func:`_selective_scan` on DTensors, each rank over its own batch
    rows and channels with no collective per position (the scan is
    independent per row and per channel, as Mamba2's :func:`_ssd`): xf and
    dt laid out by batch and channels where xf has them, Bm and Cm by
    batch, A, D and h0 by the channels (h0 by batch too), N whole. y and h
    come back as DTensors split as xf."""
    mesh = xf.device_mesh
    pl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in xf.placements]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    chans = [Shard(0) if p == Shard(2) else Replicate() for p in pl]
    state = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2) else Replicate()
             for p in pl]
    # a rank's gradients of what it shares: partial sums over the splits it
    # does not share (Bm, Cm over the channels; A, D over the batch)
    bc_grad = [Partial() if p == Shard(2) else q for p, q in zip(pl, rows)]
    param_grad = [Partial() if p == Shard(0) else q for p, q in zip(pl, chans)]
    local = lambda t, tp, grad=None: t.redistribute(mesh, tp).to_local(grad_placements=grad)
    y, h = local_work(shard_factor(mesh, pl), _selective_scan, local(xf, pl), local(dt, pl),
                      local(Bm, rows, bc_grad), local(Cm, rows, bc_grad),
                      local(A, chans, param_grad),
                      local(D, chans, param_grad), None if h0 is None else local(h0, state))
    B, S, di = xf.shape
    N = A.shape[1]
    return (DTensor.from_local(y, mesh, pl, run_check=False, shape=(B, S, di),
                               stride=(S * di, di, 1)),
            DTensor.from_local(h, mesh, state, run_check=False, shape=(B, di, N),
                               stride=(di * N, N, 1)))


def mamba1_block(cfg: ArchConfig, p, x, state=None):
    """Full block: in_proj -> conv -> silu -> SSM -> gate -> out_proj.

    state: None (train/prefill) or dict(conv, h) for decode.
    """
    di = cfg.d_inner
    if isinstance(x, DTensor):
        xs, z = _in_proj_halves(x, p["in_proj"])
    else:
        xz = hint(x @ p["in_proj"], DP, None, "model")          # reference ssm.py:124
        xs, z = xz[..., :di], xz[..., di:]
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    h0 = None if state is None else state["h"]
    y, h = mamba1_scan(p, xc, h0)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    if isinstance(out, DTensor):
        out = hint(out, DP, None, None)     # the channels' partial sums reduced in bf16
    return out, {"conv": new_conv, "h": h}


def _in_proj_halves(x, w):
    """The x and z halves of ``x @ w`` on DTensors (``w``: in_proj, (d,
    2 di)), each hinted as the reference hints the product (reference
    ssm.py:124). DTensor slices a split dim by gathering it whole: slicing
    the product gathers a rank's (rows, 2 di) activations, slicing the
    weight its (d / FSDP split, 2 di) shard, after which each half takes
    the weight's column split again (a local chunk). The smaller is
    gathered: the product at decode, the weight at train and prefill."""
    di = w.shape[1] // 2
    xl = x.to_local()
    if xl.shape[0] * xl.shape[1] < w.to_local().shape[0]:
        xz = hint(x @ w, DP, None, "model")
        return xz[..., :di], xz[..., di:]
    mesh = w.device_mesh
    whole = w.redistribute(mesh, [Replicate() if p == Shard(1) else p for p in w.placements])
    return tuple(hint(x @ whole[:, a:a + di].redistribute(mesh, w.placements), DP, None, "model")
                 for a in (0, di))


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


def _ssd(x, a_log, Bm, Cm, h0=None):
    """:func:`mamba2_ssd`; on DTensors each rank scans its own batch rows,
    every head (the chunked form's six-dim einsums flatten a sharded head
    dim, which sharding propagation refuses on some PyTorch releases): the
    operands are laid out by batch where x is, whole elsewhere."""
    if not isinstance(x, DTensor):
        return mamba2_ssd(x, a_log, Bm, Cm, h0)
    mesh = x.device_mesh
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]
    local = lambda t: t.redistribute(mesh, pl).to_local()
    y, h = local_work(shard_factor(mesh, pl), mamba2_ssd, local(x), local(a_log), local(Bm),
                      local(Cm), None if h0 is None else local(h0))

    def wrap(t, shape):
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=torch.Size(shape), stride=tuple(stride))

    B, S, H, P = x.shape
    return wrap(y, (B, S, H, P)), wrap(h, (B, H, P, Bm.shape[-1]))


def mamba2_block(cfg: ArchConfig, p, x, state=None):
    B, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    proj = hint(x @ p["in_proj"], DP, None, "model")            # reference ssm.py:237
    z = proj[..., :di]
    xBC = proj[..., di:2 * di + 2 * N]
    dt_raw = proj[..., 2 * di + 2 * N:]                          # (B,S,H)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs = split_heads(xBC[..., :di], H)
    Bm = xBC[..., di:di + N].float()
    Cm = xBC[..., di + N:].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,S,H)
    a_log = -torch.exp(p["A_log"])[None, None, :] * dt           # (B,S,H) <= 0
    h0 = None if state is None else state["h"]
    # ZOH discretization: h = exp(dt*A) h + dt * B x  (input absorbs dt)
    y, hT = _ssd(xs.float() * dt[..., None], a_log, Bm, Cm, h0)
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
