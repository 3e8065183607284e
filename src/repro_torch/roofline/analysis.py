"""Roofline analysis for the dry-run, on the H100's published peaks.

Port of ``repro/roofline/analysis.py``. Three terms per (arch x shape x
mesh) cell of ``launch/dryrun.py``, in seconds, per GPU:

  compute    = FLOPs per device / 989e12        dense bf16, H100 SXM
  memory     = HBM bytes per device / 3.35e12   HBM3
  collective = collective bytes per device / 450e9

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, no
sparsity, at the full 700 W). They replace the reference's TPU v5e
constants (197e12, 819e9, 50e9); a term here is arithmetic on published
peaks, not a measurement.

* **The collective term is aggregate per GPU, not per link.** NVLink 4
  gives one H100 900 GB/s over its 18 links, 450 GB/s in each direction;
  a collective's bytes leave each GPU over all its links at once. The
  reference's 50e9 is one ICI link. NVLink joins the 8 GPUs of one node
  only: a 16-wide mesh axis spans two nodes, where the bytes between them
  cross the slower network, so there the term is a lower bound.
* **FLOPs** are the dry-run's ``acct_flops`` (the global count over the
  devices, every trip of every loop counted; see ``launch/dryrun.py``).
* **HBM bytes** are its ``acct_bytes``: the arguments read once and the
  outputs written once per device, a lower bound of the traffic (the
  reference's counts every op's operands, which needs a compiler's fusion
  decisions).
* ``collective_bytes_from_hlo`` has no counterpart: there is no HLO. The
  dry-run's collective counter takes its place, counting each collective a
  rank issues with the bytes of its result, and it multiplies loop bodies
  by their trip counts as that function does for ``while`` loops
  (``layers.scan`` under ``dryrun.Counter``).
* MODEL_FLOPS = 6*N*D (dense train) / 6*N_active*D (MoE) / 2*N_active*B
  (decode): the "useful FLOPs" yardstick; its ratio against the counted
  FLOPs exposes remat, padding and dense-attention waste.
"""
from __future__ import annotations

from typing import Any, Dict, List

# NVIDIA H100 SXM (per GPU)
PEAK_FLOPS = 989e12       # dense bf16
HBM_BW = 3.35e12          # bytes/s, HBM3
NVLINK_BW = 450e9         # bytes/s, NVLink 4, one direction, all 18 links


# ---------------------------------------------------------------------------
# analytic model FLOPs
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> Dict[str, float]:
    """MODEL_FLOPS for the cell: the 6ND yardstick + attention term."""
    B, S = shape.global_batch, shape.seq_len
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        tokens = B * S
        base = 6.0 * n_act * tokens
        attn = 0.0
        if cfg.family in ("dense", "vlm", "moe"):
            attn = cfg.n_layers * 6.0 * B * S * S * cfg.n_heads * cfg.hd  # causal: x0.5, QK+PV: x2
        elif cfg.family == "hybrid":
            ng = cfg.n_layers // cfg.attn_every
            attn = ng * 6.0 * B * S * S * cfg.n_heads * cfg.hd
        elif cfg.family == "audio":
            enc_S = 1500
            attn = cfg.n_enc_layers * 12.0 * B * enc_S * enc_S * cfg.n_heads * cfg.hd \
                + cfg.n_dec_layers * (6.0 * B * S * S + 12.0 * B * S * enc_S) * cfg.n_heads * cfg.hd / (cfg.n_heads * cfg.hd) * (cfg.n_heads * cfg.hd)
        return {"matmul": base, "attention": attn, "total": base + attn}
    if shape.kind == "prefill":
        tokens = B * S
        base = 2.0 * n_act * tokens
        attn = 0.0
        if cfg.family in ("dense", "vlm", "moe"):
            attn = cfg.n_layers * 2.0 * B * S * S * cfg.n_heads * cfg.hd
        elif cfg.family == "hybrid":
            attn = (cfg.n_layers // cfg.attn_every) * 2.0 * B * S * S * cfg.n_heads * cfg.hd
        elif cfg.family == "audio":
            enc_S = 1500
            base = 2.0 * n_act * B * enc_S
            attn = cfg.n_enc_layers * 4.0 * B * enc_S * enc_S * cfg.n_heads * cfg.hd
        return {"matmul": base, "attention": attn, "total": base + attn}
    # decode: one token per sequence
    base = 2.0 * n_act * B
    attn = 0.0
    if cfg.family in ("dense", "vlm", "moe"):
        attn = cfg.n_layers * 4.0 * B * S * cfg.n_heads * cfg.hd
    elif cfg.family == "hybrid":
        attn = (cfg.n_layers // cfg.attn_every) * 4.0 * B * S * cfg.n_heads * cfg.hd
    elif cfg.family == "audio":
        attn = cfg.n_dec_layers * 4.0 * B * (S + 1500) * cfg.n_heads * cfg.hd
    return {"matmul": base, "attention": attn, "total": base + attn}


def roofline_terms(cell: Dict[str, Any], cfg, shape) -> Dict[str, Any]:
    """Combine dry-run counts into the three roofline terms."""
    n_dev = cell.get("n_devices", 256)
    flops = cell.get("acct_flops") or cell.get("hlo_flops") or 0.0
    hbm_bytes = cell.get("acct_bytes") or cell.get("hlo_bytes") or 0.0
    coll = (cell.get("collectives") or {}).get("bytes", {}).get("total", 0)
    mf = model_flops(cfg, shape)
    # the counts are per device
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm_bytes / HBM_BW
    t_coll = coll / NVLINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    useful_per_dev = mf["total"] / n_dev
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_total": mf["total"],
        "model_flops_per_dev": useful_per_dev,
        "useful_over_hlo": (useful_per_dev / flops) if flops else None,
        "roofline_bound_s": max(t_compute, t_memory, t_coll),
        "mfu_bound": (useful_per_dev / PEAK_FLOPS) / max(t_compute, t_memory, t_coll)
        if max(t_compute, t_memory, t_coll) > 0 else None,
    }


def roofline_report(cells: List[Dict[str, Any]]) -> str:
    """Markdown table of the cells' roofline terms."""
    from ..configs import get_config
    from ..models.config import SHAPES

    rows = []
    hdr = ("| arch | shape | mesh | step | t_compute | t_memory | t_collective "
           "| dominant | MODEL_FLOPs/HLO_FLOPs | bound MFU |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    for c in cells:
        if c.get("status") != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | {c.get('mesh','')} | "
                        f"{c.get('status')} | {c.get('reason') or c.get('error','')[:40]} | | | | | |")
            continue
        cfg = get_config(c["arch"])
        shape = SHAPES[c["shape"]]
        t = roofline_terms(c, cfg, shape)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['step']} "
            f"| {t['t_compute_s']*1e3:.2f} ms | {t['t_memory_s']*1e3:.2f} ms "
            f"| {t['t_collective_s']*1e3:.2f} ms | {t['dominant']} "
            f"| {t['useful_over_hlo'] and round(t['useful_over_hlo'],3)} "
            f"| {t['mfu_bound'] and round(t['mfu_bound'],3)} |"
        )
    return "\n".join(rows)
