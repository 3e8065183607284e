"""Shared model layers: norms, rotary, GQA/MLA attention, GLU MLPs, MoE.

Port of ``repro/models/layers.py``. Conventions as there: activations x are
(B, S, D), attention tensors (B, S, H, Dh), dense weights (d_in, d_out) used
as ``x @ W``; fp32 norms, softmax and router.

Where attention goes:

* :func:`sdpa` (no cache: the training-style forward, the Whisper encoder
  and cross-attention) calls the hand-written ``flash_attention`` kernel for
  every length. The reference switches between ``_sdpa_dense`` and
  ``_sdpa_chunked`` at ``CHUNK_THRESHOLD``; both compute the kernel's
  function, so the forward has no switch.
* :func:`sdpa` goes through :class:`FlashAttention`: its forward is the
  kernel (under no_grad it records no graph), its backward recomputes
  attention from the saved q, k, v in plain ops (:func:`_attend`:
  ``_sdpa_dense``, or ``_sdpa_chunked`` above ``CHUNK_THRESHOLD`` keys)
  and differentiates that. This is the
  reference's own training math: it differentiates its pure-JAX
  ``_sdpa_dense``/``_sdpa_chunked`` and has no Pallas backward.
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

Sharded runs (``launch/steps.py`` with a mesh) hold parameters and
activations as DTensors. :func:`hint` and :func:`hint_heads` are the
reference's activation-sharding hints, at its call sites: under
:func:`mesh_hints` they redistribute a DTensor to the hinted placements;
outside it, or on a plain tensor, they return it as it is. :func:`sdpa` on
DTensors runs the kernel on each rank's local head shard
(:func:`_sdpa_local`); :func:`o_proj` projects a sequence-split attention
output on local shards; :func:`moe_ffn` dispatches each rank's tokens to
its own experts (:func:`_moe_sharded`). Remat (``jax.checkpoint``) is
:func:`recompute`: ``lm.remat_call`` around each block, and inside a block
around each MoE token group (:func:`moe_ffn`) and each Mamba1 scan chunk
(``ssm._selective_scan``), where the reference checkpoints them.

Counting (the dry-run, ``launch/dryrun.py``): on ``meta`` tensors
:func:`sdpa` computes shapes only (:func:`attention_shape`, whose FLOPs a
``FlopCounterMode`` reads); under :func:`counting`, :func:`scan` may run a
few of its identical trips and scale the rest, and :func:`local_work`
counts what each rank computes on its own shard as the whole tensor's work.
Outside :func:`counting` neither changes anything.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import register_flop_formula

from ..kernels import ops
from .config import ArchConfig

MOE_GROUP = 32_768   # max tokens dispatched per group (bounds E*C*D buffer)
CHUNK_THRESHOLD = 2048   # KV lengths above this recompute attention in chunks
ATTN_CHUNK = 1024

# ---------------------------------------------------------------------------
# activation-sharding hints (reference layers.py:28-120)
#
# Sharding propagation follows the parameter and batch placements; a few
# places need explicit constraints, as in the reference (e.g. the LM head's
# output, whose contraction dim is FSDP-sharded on the weight side). The
# sharded steps enable hints with ``mesh_hints(mesh)``; without it hints
# are no-ops.
# ---------------------------------------------------------------------------

_MESH_HINTS: contextvars.ContextVar = contextvars.ContextVar("mesh_hints", default=None)

DP = ("pod", "data")   # data-parallel axes (filtered to those present)


@contextlib.contextmanager
def mesh_hints(mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    token = _MESH_HINTS.set((mesh, sizes))
    try:
        yield
    finally:
        _MESH_HINTS.reset(token)


# ---------------------------------------------------------------------------
# accounting (reference layers.py:58-76) and the dry-run's counting hooks
# ---------------------------------------------------------------------------

_UNROLL: contextvars.ContextVar = contextvars.ContextVar("acct_unroll", default=False)


@contextlib.contextmanager
def accounting_unroll():
    """The reference's switch that unrolls every model ``lax.scan``, since
    XLA's cost analysis counts a loop body once. The port's loops are Python:
    every trip runs, and is counted, without it. So there is nothing to
    unroll; the context sets the flag :func:`scan_unroll` reads, for API
    parity."""
    token = _UNROLL.set(True)
    try:
        yield
    finally:
        _UNROLL.reset(token)


def scan_unroll():
    """The reference's ``unroll=`` argument for model-level scans."""
    return True if _UNROLL.get() else 1


_COUNTER: contextvars.ContextVar = contextvars.ContextVar("counter", default=None)


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` (``launch.dryrun.Counter``) the active one: it takes
    over :func:`scan` and :func:`local_work`."""
    token = _COUNTER.set(counter)
    try:
        yield
    finally:
        _COUNTER.reset(token)


def scan(body, carry, xs, cut: bool = True):
    """``lax.scan``'s contract in a Python loop: for each x of ``xs`` (a
    sequence, or an int n for ``range(n)``), ``carry, y = body(carry, x)``;
    returns (carry, [y, ...]). The trips must be alike (the same ops on
    the same shapes; the first may differ): under :func:`counting`, the
    counter may run a few of them and count the rest as their like
    (``Counter.scan``), unless ``cut`` is False (trips whose skipping would
    leave something behind, such as their own parameters without a
    gradient)."""
    xs = range(xs) if isinstance(xs, int) else xs
    counter = _COUNTER.get()
    if counter is not None and cut:
        return counter.scan(body, carry, xs)
    ys = []
    for x in xs:
        carry, y = body(carry, x)
        ys.append(y)
    return carry, ys


def recompute(fn, *args):
    """``fn(*args)``, its activations recomputed in backward instead of
    kept (``torch.utils.checkpoint``, non-reentrant) whenever grad is
    enabled: the reference's ``jax.checkpoint``. Autograd keeps the tensor
    arguments only; under no_grad it is a plain call.

    The forward and the recomputation each run in a copy of the caller's
    context variables (the mesh hints above all): autograd runs a CUDA
    backward on a thread of its own, where they are unset, and a
    recomputation without the hints would lay its tensors out otherwise
    than the forward did."""
    if torch.is_grad_enabled():
        ctx = contextvars.copy_context()
        return checkpoint(lambda *a: ctx.copy().run(fn, *a), *args, use_reentrant=False)
    return fn(*args)


def shard_factor(mesh, *placements) -> int:
    """How many ranks' shards make up the whole: the product of the sizes of
    the mesh dims on which any of ``placements`` is a Shard."""
    return math.prod(mesh.size(i) for i in range(mesh.ndim)
                     if any(pl[i].is_shard() for pl in placements))


def local_work(factor: int, fn, *args):
    """``fn(*args)``, which a rank computes on its own shard (local tensors,
    outside DTensor's dispatch), ``factor`` shards making up the whole.
    Under :func:`counting` its FLOPs, forward and backward, count ``factor``
    times: the whole tensor's work, as DTensor ops are counted."""
    counter = _COUNTER.get()
    if counter is None or factor == 1:
        return fn(*args)
    return counter.local(factor, fn, *args)


@torch.library.custom_op("repro_torch::attention_shape", mutates_args=())
def attention_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention's output for (B, S, H, D) operands, shapes only: an empty
    (B, S, Hq, Dv) tensor. Only meta tensors reach it (:func:`_flash`)."""
    return q.new_empty(q.shape[:-1] + v.shape[-1:])


attention_shape.register_fake(lambda q, k, v: q.new_empty(q.shape[:-1] + v.shape[-1:]))


@register_flop_formula(torch.ops.repro_torch.attention_shape)
def _attention_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """The reference's plain attention: dense Q.K^T and P.V over all S x Sk
    pairs, causal or not, 4 B Hq S Sk D."""
    B, S, Hq, D = q_shape
    return 4 * B * Hq * S * k_shape[1] * D


def hint_spec(shape, spec, sizes) -> tuple:
    """``spec`` for a tensor of ``shape``, with the reference's drops: an
    axis absent from the mesh, or whose size does not divide the
    dimension, leaves that dimension unsharded."""
    parts = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            parts.append(None)
            continue
        axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,)) if a in sizes)
        total = math.prod(sizes[a] for a in axes)
        parts.append((axes if len(axes) > 1 else axes[0]) if axes and dim % total == 0
                     else None)
    return tuple(parts)


def hint(x, *spec):
    """Redistribute the DTensor ``x`` to ``spec`` (:func:`hint_spec`'s
    drops applied); ``x`` as it is outside :func:`mesh_hints` or when it
    is a plain tensor."""
    from ..launch.sharding import Spec, to_placements   # launch imports the models

    hints = _MESH_HINTS.get()
    if hints is None or not isinstance(x, DTensor):
        return x
    mesh, sizes = hints
    return x.redistribute(mesh, to_placements(Spec(*hint_spec(x.shape, spec, sizes)), mesh))


def heads_spec(shape, sizes) -> tuple:
    """:func:`hint_heads`' spec for a (B, S, H, hd) tensor."""
    if shape[2] % sizes["model"] == 0:
        return (DP, None, "model", None)     # reference layers.py:115
    if shape[1] % sizes["model"] == 0:
        return (DP, "model", None, None)     # reference layers.py:117
    return (DP, None, None, "model")         # reference layers.py:118


def hint_heads(x):
    """(B, S, H, hd): shard H over 'model' when divisible; otherwise fall
    back to sharding the *sequence* over 'model' (attention is per-query-row
    parallel, so SP is the clean fallback for e.g. smollm's 15 heads on a
    16-way mesh)."""
    hints = _MESH_HINTS.get()
    if hints is None or "model" not in hints[1]:
        return x
    return hint(x, *heads_spec(x.shape, hints[1]))


def whole_unless_divides(x, dim: int, n: int):
    """A DTensor ``x`` made whole on the mesh dims that split its dim
    ``dim`` when the product of their sizes does not divide ``n``, the size
    a reshape gives the dim's leading part; ``x`` as it is otherwise.
    DTensor cannot carry such a split through the reshape (GSPMD reshards
    there itself)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    if n % math.prod(mesh.size(i) for i in split):
        x = x.redistribute(mesh, [Replicate() if i in split else p
                                  for i, p in enumerate(x.placements)])
    return x


def split_heads(x, H: int):
    """(B, S, H * hd) -> (B, S, H, hd). A DTensor whose last dim is split
    over mesh dims whose sizes do not divide H is made whole on them first
    (:func:`whole_unless_divides`), e.g. TinyLlama's 2 KV heads when their
    columns split 4 ways."""
    B, S = x.shape[:2]
    return whole_unless_divides(x, x.dim() - 1, H).reshape(B, S, H, -1)


class _Reshape(torch.autograd.Function):
    """``x.reshape(shape)``, whose backward makes the gradient whole where
    its dim ``dim`` is split in a way ``n`` does not divide
    (:func:`whole_unless_divides`) before reshaping it back: a gradient
    comes back split as the backward's own ops lay it out, which need not be
    a split the reshape can carry."""

    @staticmethod
    def forward(ctx, x, shape, dim: int, n: int):
        ctx.in_shape, ctx.dim, ctx.n = x.shape, dim, n
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return whole_unless_divides(grad, ctx.dim, ctx.n).reshape(ctx.in_shape), None, None, None


def reshape_whole(x, shape, dim: int, n: int):
    """``x.reshape(shape)``; on a DTensor, through :class:`_Reshape`."""
    return _Reshape.apply(x, shape, dim, n) if isinstance(x, DTensor) else x.reshape(shape)


def merge_heads(x):
    """(B, S, H, hd) -> (B, S, H * hd). A split of hd (:func:`hint_heads`'
    last fallback) is made whole first: merged, it would be a strided split
    of H * hd, which DTensor plans at great cost on a 3-D mesh and some
    PyTorch releases refuse. A DTensor's gradient is split back into heads
    as :func:`split_heads` splits: the gradient of a merged tensor comes
    back split over its last dim when the projection after it has its
    weight split there, and H need not divide that split."""
    B, S, H = x.shape[:3]
    x = whole_unless_divides(x, 3, 1)        # 1: no split of hd divides it
    return reshape_whole(x, (B, S, -1), 2, H)


def o_proj(out, w):
    """The attention output (B, S, H, hd), its heads merged
    (:func:`merge_heads`) and projected by ``w`` (H * hd, D), laid out as
    the reference's ``hint(..., DP, None, None)`` after its GQA and MLA
    o-projections. Whisper's two cross-attention o-projections (reference
    whisper.py:84, :165) have no hint in the reference; the port lays them
    out the same way on purpose, so that every sequence-split projection
    lands in one layout (Whisper decode's collective bytes at 2x16x16 fall
    by 62% with it). A DTensor whose sequence
    is split (:func:`hint_heads`' fallback) is projected on each rank's
    (batch, sequence) shard against ``w`` made whole: DTensor's product
    flattens batch with sequence, which some PyTorch releases refuse for a
    split second dim. ``w``'s gradient is each rank's partial sum,
    reduce-scattered back to its placements."""
    x = merge_heads(out)
    if not (isinstance(x, DTensor) and Shard(1) in x.placements):
        return hint(x @ w, DP, None, None)
    mesh = x.device_mesh
    pl = [p if p in (Shard(0), Shard(1)) else Replicate() for p in x.placements]
    wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate() for p in pl])
    y = local_work(shard_factor(mesh, pl), torch.matmul, x.redistribute(mesh, pl).to_local(), wl)
    B, S, D = x.shape[0], x.shape[1], w.shape[1]
    y = DTensor.from_local(y, mesh, pl, run_check=False, shape=(B, S, D),
                           stride=(S * D, D, 1))
    return hint(y, DP, None, None)


class _GradPlaced(torch.autograd.Function):
    """The identity on a DTensor; its backward lays the gradient out as the
    input's placements."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements)


def grad_placed(t):
    """``t``; on a DTensor, one use of it whose gradient reaches ``t``
    already laid out as ``t``. Where a parameter has two uses (a tied
    embedding and head), each use's gradient comes back in a layout of its
    own, and their sum may convert a split into a pending sum, which some
    PyTorch releases refuse; laid out alike, they add as they are."""
    return _GradPlaced.apply(t) if isinstance(t, DTensor) else t


def embed(table, tokens):
    """``table[tokens]``, the reference's embedding lookup, as
    ``F.embedding``. A DTensor table is gathered whole for the lookup (as
    FSDP gathers a weight before use; its gradient is reduce-scattered back
    to the table's placements): DTensor's lookup into a vocab-sharded table
    leaves a masked partial sum that a later redistribution misapplies, and
    the backward of an indexing (``index_put``) fails sharding propagation
    on some PyTorch releases."""
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)
    return F.embedding(tokens, table)


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
    """fp32 standard normals on the generator's device, scaled in place,
    cast: beside the weights made before it, a bf16 leaf takes its fp32
    draw and its copy at once (DeepSeek-V3's (256, 7168, 2048) expert
    stacks: 15 + 7.5 GB), not a second fp32 copy as well."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(scale).to(dtype)


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


def _sdpa_dense(q, k, v, causal, q_offset=0, scale: Optional[float] = None):
    """q: (B,S,H,Dh), k/v: (B,Sk,Hkv,Dh). Materializes (S,Sk) scores, scaled
    by ``scale`` (default: divided by sqrt(Dh))."""
    S, H, Dh = q.shape[1:]
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / math.sqrt(Dh) if scale is None else s * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(~(qi >= ki), -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _sdpa_chunked(q, k, v, causal, scale: float):
    """Online softmax over ATTN_CHUNK-key chunks, each chunk's scores
    recomputed in backward (the reference's ``_sdpa_chunked``, whose scan
    body is a ``jax.checkpoint``): memory O(S * chunk), not O(S * Sk).
    q/k share Dh; v may have its own head dim."""
    B, S, H, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    qi = torch.arange(S, device=q.device)[:, None]

    def body(m, l, acc, kb, vb, c0):
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        if causal:
            ki = c0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = s.masked_fill(~(qi >= ki), -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha.permute(0, 2, 1, 3) + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(vb.dtype), vb).float()
        return m_new, l, acc

    m = torch.full((B, H, S, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, v.shape[-1]), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, ATTN_CHUNK):
        kb, vb = k[:, c0:c0 + ATTN_CHUNK], v[:, c0:c0 + ATTN_CHUNK]
        m, l, acc = checkpoint(body, m, l, acc, kb, vb, c0, use_reentrant=False)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l.permute(0, 2, 1, 3)).to(q.dtype)


def _attend(q, k, v, causal, scale: float):
    """Attention in plain differentiable ops, (B, S, H, Dh) layout: the
    reference's ``sdpa`` (chunked above CHUNK_THRESHOLD keys when they
    split into whole chunks, else dense)."""
    if k.shape[1] > CHUNK_THRESHOLD and k.shape[1] % ATTN_CHUNK == 0:
        return _sdpa_chunked(q, k, v, causal, scale)
    return _sdpa_dense(q, k, v, causal, scale=scale)


def _flash(q, k, v, causal, scale):
    """The flash_attention kernel on (B, S, H, Dh) operands; on meta tensors
    (the dry-run) their shapes only, counted as the plain attention."""
    if q.device.type == "meta":
        return torch.ops.repro_torch.attention_shape(q, k, v)
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=causal, scale=scale).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """The flash_attention kernel as a differentiable op, (B, S, H, Dh).

    Forward: the kernel (on the card the wgmma design for bf16, wgmma3 for
    fp32; on CPU tensors its plain version). Backward: attention recomputed
    from the saved q, k, v by :func:`_attend` and differentiated there."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _attend(*saved, ctx.causal, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, saved, grad)
        return dq, dk, dv, None, None


def sdpa(q, k, v, causal=True):
    """Attention through the flash_attention kernel, (B, S, H, Dh) layout,
    differentiable through :class:`FlashAttention` (under no_grad, or with
    inputs that need no gradient, its apply runs the kernel and records
    nothing). On DTensors, each rank attends its local shard
    (:func:`_sdpa_local`).

    q/k share Dh; v may have a smaller head dim (MLA: qk 192, v 128). All
    three are zero-padded to the multiple of 8 at or above Dh, so that a row
    of a bf16 operand fills whole 16-byte units, as the kernel's wgmma design
    needs (SmolLM's smoke config has Dh 20): the zero columns add exact
    zeros to every score, the scale stays 1/sqrt(Dh), and the zero output
    columns are sliced off (exact). The padding and the slice stay outside
    the autograd Function; both are differentiable.
    """
    if isinstance(q, DTensor):
        return _sdpa_local(q, k, v, causal)
    return _flash_padded(q, k, v, causal)


def _flash_padded(q, k, v, causal):
    d, dv = q.shape[-1], v.shape[-1]
    dp = -(-d // 8) * 8
    if dp != d:
        q, k = F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d))
    if dv != dp:
        v = F.pad(v, (0, dp - dv))
    return FlashAttention.apply(q, k, v, causal, 1.0 / d ** 0.5)[..., :dv]


def _local_qkv(q, k, v, kv_seq: bool = False):
    """q, k, v (DTensors, (B, S, H, Dh)) as local tensors that attend to
    each other rank by rank: (ql, kl, vl, q, k, the mesh dims k's sequence
    stays split over).

    Per mesh dim q may be replicated, or sharded over batch (dim 0) or
    heads (dim 2, after :func:`hint_heads`). A shard of q's sequence or head
    dim (``hint_heads``' fallbacks, e.g. SmolLM's 15 heads on a 16-way
    'model' axis) is gathered first: a local query chunk would need its
    causal offset (the kernel's mask is aligned top-left at S == Sk), and
    a head is attended whole. k and v take q's placements; where q's heads
    are sharded and the KV heads do not divide by that axis, k and v stay
    whole there and each rank takes the KV heads its query heads read
    (their gradients are partial sums over that axis). With ``kv_seq``, a
    sequence shard of k and v where q is replicated stays (a decode cache
    in the SP layout). A pending partial sum in q (a projection whose
    contraction dim is sharded, with no hint after it: Whisper's
    cross-attention) is reduced onto the heads where they divide, else
    whole."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    pl = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Partial):     # a pending sum (no hint before it): reduced
            p = Shard(2) if Hq % mesh.size(i) == 0 else Replicate()
        elif not (isinstance(p, Replicate) or p in (Shard(0), Shard(2))):
            p = Replicate()
        pl.append(p)
    if pl != list(q.placements):
        q = q.redistribute(mesh, pl)
    kv_pl, kv_grad, heads, seq_dims = [], [], None, []
    for i, p in enumerate(q.placements):
        if p == Shard(2) and Hkv % mesh.size(i):
            kv_pl.append(Replicate())
            kv_grad.append(Partial())
            heads = (mesh.get_local_rank(i), mesh.size(i))
        elif kv_seq and isinstance(p, Replicate) and k.placements[i] == Shard(1):
            kv_pl.append(Shard(1))
            kv_grad.append(Shard(1))
            seq_dims.append(i)
        else:
            kv_pl.append(p)
            kv_grad.append(p)
    k, v = (t if list(t.placements) == kv_pl else t.redistribute(mesh, kv_pl) for t in (k, v))
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    if heads is not None:
        # the KV heads this rank's query heads read (query head h reads
        # KV head h // (Hq // Hkv)), one copy per query head
        r, n = heads
        lo = r * (Hq // n)
        kl, vl = (t.repeat_interleave(Hq // Hkv, dim=2)[:, :, lo:lo + Hq // n]
                  for t in (kl, vl))
    return ql, kl, vl, q, k, seq_dims


def _wrap_like(out, q, D: int):
    """A rank's local attention output as a DTensor placed like q."""
    B, S, Hq = q.shape[:3]
    return DTensor.from_local(out.contiguous(), q.device_mesh, q.placements, run_check=False,
                              shape=(B, S, Hq, D), stride=(S * Hq * D, Hq * D, D, 1))


def _sdpa_local(q, k, v, causal: bool):
    """:func:`sdpa` on DTensors, each rank on its local shard
    (:func:`_local_qkv`). The kernel is a ``ctypes`` launch, which DTensor
    has no sharding rule for, so it runs on ``to_local()`` shards (padded
    there, not as DTensors) and the result is wrapped back with q's
    placements."""
    ql, kl, vl, q, _, _ = _local_qkv(q, k, v)
    out = local_work(shard_factor(q.device_mesh, q.placements), _flash_padded, ql, kl, vl,
                     causal)
    return _wrap_like(out, q, v.shape[-1])


def _sdpa_cache_local(q, k, v, q_offset: int):
    """Causal :func:`_sdpa_dense` of q against a cache (decode) on
    DTensors, each rank on its local shards (:func:`_local_qkv`). A cache
    whose sequence is split (the SP layout) is attended in parts, each rank
    over the keys it holds, and combined as one softmax: the scores' max
    and the exponentials' sum all-reduced over the sequence's mesh dims,
    then each part's P.V summed. Without that split it is ``_sdpa_dense``
    on the local tensors, the same ops as on one device."""
    ql, kl, vl, q, k, seq_dims = _local_qkv(q, k, v, kv_seq=True)
    mesh = q.device_mesh
    factor = shard_factor(mesh, q.placements, [Shard(1) if i in seq_dims else Replicate()
                                               for i in range(mesh.ndim)])
    if not seq_dims:
        out = local_work(factor, _sdpa_dense, ql, kl, vl, True, q_offset)
        return _wrap_like(out, q, v.shape[-1])
    groups = [mesh.get_group(i) for i in seq_dims]
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh, k.placements)
    return _wrap_like(local_work(factor, _attend_split, ql, kl, vl, q_offset, offset[1], groups),
                      q, v.shape[-1])


def _attend_split(ql, kl, vl, q_offset: int, k_offset: int, groups):
    """:func:`_sdpa_cache_local`'s attention over a sequence-split cache:
    this rank's keys start at ``k_offset``; the softmax's max and sum and
    the P.V parts are all-reduced over ``groups``."""
    S, H, Dh = ql.shape[1:]
    if kl.shape[2] != H:
        kl = kl.repeat_interleave(H // kl.shape[2], dim=2)
        vl = vl.repeat_interleave(H // vl.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", ql, kl).float() / math.sqrt(Dh)
    qi = torch.arange(S, device=ql.device)[:, None] + q_offset
    ki = torch.arange(kl.shape[1], device=ql.device)[None, :] + k_offset
    s = s.masked_fill(~(qi >= ki), -1e30)
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(total, group=g)
    out = torch.einsum("bhqk,bkhd->bqhd", (e / total).to(vl.dtype), vl)
    for g in groups:
        dist.all_reduce(out, group=g)
    return out


def write_seq(dst, src, start: int) -> None:
    """``dst[:, start:start + S] = src`` in place, S = ``src.shape[1]``: a
    cache write. On DTensors each rank writes the part of the span its own
    shard of ``dst`` holds, so a sequence-sharded cache (long_500k's SP
    layout) is written where it lives; slicing a sharded dim of a DTensor
    would write into a gathered copy instead."""
    if not isinstance(dst, DTensor):
        dst[:, start:start + src.shape[1]] = src
        return
    mesh = dst.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in dst.placements]
    src_local = src.redistribute(mesh, pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    lo, hi = offset[1], offset[1] + shape[1]
    a, b = max(start, lo), min(start + src.shape[1], hi)
    if a < b:
        dst.to_local()[:, a - lo:b - lo] = src_local[:, a - start:b - start]


def gqa_attention(cfg: ArchConfig, p, x, positions, causal=True, cache=None, cache_pos=None):
    """Returns (out, cache). cache: dict(k, v) of (B, S_max, Hkv, Dh),
    written in place."""
    q = hint_heads(split_heads(x @ p["q"], cfg.n_heads))                # reference :260
    k = hint_heads(split_heads(x @ p["k"], cfg.n_kv_heads))             # reference :261
    v = hint_heads(split_heads(x @ p["v"], cfg.n_kv_heads))             # reference :262
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    if cache is not None:
        k, v = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        write_seq(cache["k"], k, cache_pos)
        write_seq(cache["v"], v, cache_pos)
        if cache_pos == 0:
            out = sdpa(q, k, v, causal=True)
        else:
            ck, cv = cache["k"], cache["v"]
            out = _sdpa_cache_local(q, ck, cv, cache_pos) if isinstance(q, DTensor) \
                else _sdpa_dense(q, ck, cv, causal=True, q_offset=cache_pos)
    else:
        out = sdpa(q, k, v, causal=causal)
    return o_proj(hint_heads(out), p["o"]), cache                       # reference :275-276


def _mla_latent(q_nope, q_rope, c_n, cr, w_uk, w_uv, q_offset: int, scale: float):
    """MLA's attention absorbed in the latent space, plain ops: q (B, S, H,
    hd / rd) against the normed compressed cache ``c_n`` (B, Sc, kv_lora)
    and its rope keys ``cr`` (B, Sc, rd), causal at ``q_offset``; the
    weights (H, kv_lora, hd). Returns (B, S, H, hd)."""
    S = q_nope.shape[1]
    q_lat = torch.einsum("bshd,hkd->bshk", q_nope, w_uk.to(q_nope.dtype))
    s_lat = torch.einsum("bshk,btk->bhst", q_lat, c_n) * scale
    s_rope = torch.einsum("bshr,btr->bhst", q_rope, cr.to(q_rope.dtype)) * scale
    scores = (s_lat + s_rope).float()
    ti = torch.arange(c_n.shape[1], device=c_n.device)[None, None, None, :]
    qi = torch.arange(S, device=c_n.device)[None, None, :, None] + q_offset
    scores = scores.masked_fill(~(qi >= ti), -1e30)
    pr = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btk->bshk", pr.to(c_n.dtype), c_n)
    return torch.einsum("bshk,hkd->bshd", ctx, w_uv.to(ctx.dtype))


def _mla_latent_local(q_nope, q_rope, c_n, cr, w_uk, w_uv, q_offset: int, scale: float):
    """:func:`_mla_latent` on DTensors, each rank on its local shards (as
    :func:`_sdpa_cache_local` attends): q keeps its batch and head splits
    (any other split or pending sum is made whole), the cache takes q's
    batch split and is whole otherwise, the weights take q's head split;
    the result is wrapped with q's placements. DTensor's own layout of the
    latent products flattens heads with positions, which costs time linear
    in H x S to plan and which some PyTorch releases refuse."""
    mesh = q_nope.device_mesh
    q_pl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in q_nope.placements]
    cache_pl = [Shard(0) if p == Shard(0) else Replicate() for p in q_pl]
    w_pl = [Shard(0) if p == Shard(2) else Replicate() for p in q_pl]
    local = lambda t, pl: t.redistribute(mesh, pl).to_local()
    out = local_work(shard_factor(mesh, q_pl), _mla_latent, local(q_nope, q_pl),
                     local(q_rope, q_pl), local(c_n, cache_pl), local(cr, cache_pl),
                     local(w_uk, w_pl), local(w_uv, w_pl), q_offset, scale)
    B, S, H = q_nope.shape[:3]
    D = w_uv.shape[-1]
    return DTensor.from_local(out.contiguous(), mesh, q_pl, run_check=False,
                              shape=(B, S, H, D), stride=(S * H * D, H * D, D, 1))


def mla_attention(cfg: ArchConfig, p, x, positions, causal=True, cache=None, cache_pos=None):
    """DeepSeek MLA. The cache stores the *compressed* c_kv (+ rope key),
    written in place; with a cache, attention runs absorbed in the latent
    space (:func:`_mla_latent`), without one through :func:`sdpa`."""
    hd, rd = cfg.hd, cfg.rope_head_dim
    H = cfg.n_heads
    cq = rms_norm(x @ p["q_down"], p["q_norm"], cfg.norm_eps)
    q = hint_heads(split_heads(cq @ p["q_up"], H))                      # reference :287
    q_nope, q_rope = q[..., :hd], rotary(q[..., hd:], positions, cfg.rope_theta)

    ckv_full = x @ p["kv_down"]                          # (B,S,kv_lora+rd)
    c_kv = ckv_full[..., : cfg.kv_lora_rank]
    k_rope = rotary(ckv_full[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        write_seq(cc, c_kv.to(cc.dtype), cache_pos)
        write_seq(cr, k_rope.to(cr.dtype), cache_pos)
        kv_up = p["kv_up"].reshape(cfg.kv_lora_rank, H, 2, hd)
        w_uk = kv_up[:, :, 0].permute(1, 0, 2)            # (H, kv_lora, hd)
        w_uv = kv_up[:, :, 1].permute(1, 0, 2)            # (H, kv_lora, hd)
        c_n = rms_norm(cc, p["kv_norm"], cfg.norm_eps)    # (B, Sc, kv_lora)
        attend = _mla_latent_local if isinstance(q, DTensor) else _mla_latent
        out = attend(q_nope, q_rope, c_n, cr, w_uk, w_uv, cache_pos, 1.0 / math.sqrt(hd + rd))
        return o_proj(hint_heads(out), p["o"]), cache                   # reference :320-321
    c_n = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    kv = hint_heads(split_heads(c_n @ p["kv_up"], H))                   # reference :325
    k_nope, v = kv[..., :hd], kv[..., hd:]
    k_rope_b = k_rope[:, :, None, :].expand(k_nope.shape[:3] + (rd,))
    k_full = torch.cat([k_nope, k_rope_b.to(k_nope.dtype)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(q_full, k_full, v, causal=causal)
    return o_proj(hint_heads(out), p["o"]), None                       # reference :332-333


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
    act = _act(cfg.act)   # hints: reference :353-354
    h = act(hint(x @ p["w_gate"], DP, None, "model")) * hint(x @ p["w_up"], DP, None, "model")
    return hint(h @ p["w_down"], DP, None, None)


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
    dispatched in groups of MOE_GROUP tokens where the reference does (more
    tokens than MOE_GROUP, a multiple of it). Each such group is recomputed
    in backward (:func:`recompute`), as the reference checkpoints it
    (reference :394-405): its gathered slots, its (E * C + 1, D) buffer and
    its expert GLU's intermediates are rebuilt from the group's tokens and
    routing instead of being kept for every group. On DTensors each rank
    dispatches its own tokens (:func:`_moe_sharded`), each piece of a group
    recomputed the same way."""
    B, S, D = x.shape
    T_all = B * S
    # tokens flattened from a batch split unevenly (fewer rows than data-
    # parallel ranks: a microbatch of the 2x16x16 mesh) and back: that
    # split made whole on both sides (whole_unless_divides)
    x2 = reshape_whole(whole_unless_divides(x, 0, B), (T_all, D), 0, B)
    if isinstance(x2, DTensor):
        out = _moe_sharded(cfg, p, x2)
    elif T_all > MOE_GROUP and T_all % MOE_GROUP == 0:
        # routed once for all groups, as the sharded path routes a rank's
        # rows: each token's routing is its own, and the router's gradient
        # sums all tokens in one product either way
        routed = zip(*(t.split(MOE_GROUP) for t in (x2, *_route(cfg, x2, p["router"]))))
        group = lambda x, gvals, gidx: _moe_group(cfg, p, x, (gvals, gidx))
        _, groups = scan(lambda c, g: (c, recompute(group, *g)), None, list(routed))
        out = torch.cat(groups)
    else:
        out = _moe_group(cfg, p, x2)
    if cfg.n_shared_experts:
        out = out + glu_mlp(cfg, p["shared"], x2)
    return reshape_whole(whole_unless_divides(out, 0, B), (B, S, D), 0, B)


def _route(cfg: ArchConfig, x2, router):
    """(gate values, expert ids), each (T, K): the fp32 softmax over the
    experts, its top k, renormalised."""
    scores = torch.softmax(x2.float() @ router, dim=-1)
    gvals, gidx = torch.topk(scores, cfg.top_k, dim=-1)
    return (gvals / gvals.sum(dim=-1, keepdim=True)).to(x2.dtype), gidx


def _capacity(cfg: ArchConfig, T: int) -> int:
    """Slots an expert takes from a group of T tokens."""
    SL = T * cfg.top_k
    return max(8, int(cfg.capacity_factor * SL / cfg.n_experts))


def _queue(gidx):
    """The sort-based dispatch's bookkeeping for (T, K) expert ids: (perm,
    sorted_e, pos). ``perm`` sorts the T * K (token, choice) slots by
    expert, stably (as jnp.argsort), token-major within an expert; ``pos``
    is each sorted slot's place in its expert's queue."""
    flat_e = gidx.reshape(-1)
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    pos = torch.arange(flat_e.numel(), device=gidx.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    return perm, sorted_e, pos


def _expert_glu(cfg: ArchConfig, xe, w_gate, w_up, w_down):
    """(E, C, D) expert rows through each expert's GLU (reference :436-437)."""
    h = _act(cfg.act)(torch.einsum("ecd,edf->ecf", xe, w_gate)) * torch.einsum(
        "ecd,edf->ecf", xe, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _dispatch(cfg: ArchConfig, x, gvals, gidx, C: int, Cr: int, experts, glu, before=None):
    """Tokens x (T, D) with their gate values and expert ids (T, K) through
    the experts ``experts`` = (first, count), on plain tensors. A slot is
    kept where its place in its expert's queue is below the capacity C:
    its place among these tokens, plus ``before[e]`` (E,) slots of expert e
    taken by earlier tokens of the group when given. The kept slots fill a
    buffer of Cr rows an expert (Cr = C, or fewer where these tokens cannot
    give an expert more), ``glu`` maps it (count, Cr, D) to the experts'
    outputs, and each kept slot's output, times its gate value, is summed
    into its token (reference :427-441). Returns (T, D)."""
    T, D = x.shape
    e0, E_loc = experts
    perm, sorted_e, lpos = _queue(gidx)
    pos = lpos if before is None else lpos + before[sorted_e]
    keep = (pos < C) & (sorted_e >= e0) & (sorted_e < e0 + E_loc)
    dest = torch.where(keep, (sorted_e - e0) * Cr + lpos,
                       torch.full_like(lpos, E_loc * Cr))               # the drop slot
    tok = perm // cfg.top_k
    buf = torch.zeros((E_loc * Cr + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, dest, x[tok])
    ye = glu(buf[:E_loc * Cr].reshape(E_loc, Cr, D)).reshape(E_loc * Cr, D)
    ye = torch.cat([ye, ye.new_zeros((1, D))])
    contrib = ye[dest] * gvals.reshape(-1)[perm][:, None] * keep[:, None].to(x.dtype)
    return torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(0, tok, contrib)


def _moe_group(cfg: ArchConfig, p, x2, routed=None):
    """One group of plain tokens (T, D) through all the experts, routed
    here unless ``routed`` gives their (gate values, expert ids). The
    reference's hints here (:427, :430, :436-437, :441) lay out DTensors,
    which take :func:`_moe_sharded`."""
    gvals, gidx = _route(cfg, x2, p["router"]) if routed is None else routed
    C = _capacity(cfg, x2.shape[0])
    return _dispatch(cfg, x2, gvals, gidx, C, C, (0, cfg.n_experts),
                     lambda xe: _expert_glu(cfg, xe, p["w_gate"], p["w_up"], p["w_down"]))


def _moe_sharded(cfg: ArchConfig, p, x2):
    """:func:`moe_ffn`'s dispatch on DTensor tokens (T, D), each rank on
    its own tokens and its own experts.

    The tokens keep their split over the data-parallel mesh dims and are
    whole over the dims that split the experts (``w_gate``'s placements:
    'model'). Routing runs on the rank's rows. A slot's place in its
    expert's queue is the reference's, in the stable sort by expert over
    the whole group: its place among the rank's slots plus the group's
    slots on the ranks that hold earlier tokens (:func:`_slots_before`, an
    all-gather of E counts, only where a group spans ranks), so capacity
    and the dropped slots are the reference's. Each group piece (a group,
    or the rank's part of one) goes through :func:`_dispatch` with the
    rank's own experts, the expert GEMMs as DTensor einsums; the combine's
    sum over the expert dims is the hint's reduction after it.
    ``index_add``, ``argsort`` and ``searchsorted`` see local tensors only.
    Groups and token shards must nest (one divides the other). Where the
    tokens make more than one group, each piece is recomputed in backward
    (:func:`recompute`; the weights' gather stays outside it, the rows'
    gather is made again), as the reference checkpoints each group."""
    mesh = x2.device_mesh
    T, D = x2.shape
    G = MOE_GROUP if T > MOE_GROUP and T % MOE_GROUP == 0 else T
    ep = [i for i, q in enumerate(p["w_gate"].placements) if q == Shard(0)]
    pl = [Shard(0) if q == Shard(0) and i not in ep else Replicate()
          for i, q in enumerate(x2.placements)]
    n = shard_factor(mesh, pl)
    Tl = T // n
    if T % n or (Tl % G if Tl >= G else G % Tl):
        raise ValueError(f"MoE groups of {G} tokens and {n} token shards of {T} tokens "
                         f"do not nest")
    tokens = x2 if list(x2.placements) == pl else x2.redistribute(mesh, pl)
    tok_dims = [i for i, q in enumerate(pl) if q.is_shard()]
    # gradients of what a rank computes for its own experts only: partial
    # sums over the expert dims
    grad_pl = [Partial() if i in ep else q for i, q in enumerate(pl)]
    gvals, gidx = _route(cfg, tokens, p["router"])      # DTensor ops on the rows
    gvals = gvals.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
    gidx = gidx.redistribute(mesh, pl).to_local()
    xl = tokens.to_local(grad_placements=grad_pl)
    P = min(Tl, G)      # tokens a piece: a whole group, or this rank's part of one
    _, offset = compute_local_shape_and_global_offset(tokens.shape, mesh, pl)
    before = (_slots_before(gidx, cfg.n_experts, offset[0] // Tl, G // P, mesh, tok_dims)
              if P < G else None)
    e_shape, e_offset = compute_local_shape_and_global_offset(
        p["w_gate"].shape, mesh, p["w_gate"].placements)
    experts = (e_offset[0], e_shape[0])
    buf_pl = [Shard(0) if i in ep else Shard(1) if i in tok_dims else Replicate()
              for i in range(mesh.ndim)]

    C = _capacity(cfg, G)
    Cr = min(C, P)      # a piece gives one expert at most P slots
    ws = [p[k] for k in ("w_gate", "w_up", "w_down")]
    ep_only = [Shard(0) if i in ep else Replicate() for i in range(mesh.ndim)]
    # the expert GEMMs meet each rank's rows with the weights' FSDP split:
    # either the weights are gathered (once for all pieces), or every
    # rank's rows are, each rank then contracting its own slice of D (and
    # the products' partial sums reduced); whichever moves fewer elements
    F = p["w_gate"].shape[2]
    gather_weights = all(list(w.placements) == ep_only for w in ws) \
        or 3 * D * F <= n * Cr * 2 * (D + F) * (Tl // P)
    if gather_weights:
        ws = [w.redistribute(mesh, ep_only) for w in ws]

    def glu(xe):
        """The rank's (E_loc, Cr, D) buffer as a DTensor (E, n * Cr, D),
        rows split as the tokens and experts as the weights, through the
        expert GLU; the rank's (E_loc, Cr, D) outputs."""
        xe = DTensor.from_local(xe, mesh, buf_pl, run_check=False,
                                shape=(cfg.n_experts, n * Cr, D), stride=(n * Cr * D, D, 1))
        if not gather_weights:
            xe = xe.redistribute(mesh, ep_only)
        return _expert_glu(cfg, xe, *ws).redistribute(mesh, buf_pl).to_local()

    dispatch = lambda x, gv, gi: _dispatch(cfg, x, gv, gi, C, Cr, experts, glu, before)

    def piece(carry, args):
        return carry, recompute(dispatch, *args) if G < T else dispatch(*args)

    # the pieces' tokens as the trips' inputs, which the dry-run's counter
    # brackets to count a skipped piece's backward
    _, outs = scan(piece, None, list(zip(*(t.split(P) for t in (xl, gvals, gidx)))))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return hint(DTensor.from_local(out, mesh, grad_pl, run_check=False, shape=(T, D),
                                   stride=(D, 1)), DP, None)                  # reference :441


#: a functional all-gather along a dim (renamed ``all_gather_single`` in
#: newer PyTorch releases, the old name deprecated there)
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor


def _slots_before(gidx, E: int, shard: int, span: int, mesh, dims):
    """(E,) slots of each expert taken by the tokens of this rank's group
    on the ranks before it: each token shard's counts (1, E), all-gathered
    over the token dims ``dims`` in shard order; this rank is shard
    ``shard``, its group spans ``span`` consecutive shards."""
    flat = gidx.reshape(1, -1)
    counts = torch.zeros((1, E), dtype=flat.dtype, device=flat.device).scatter_add_(
        1, flat, torch.ones_like(flat))
    for i in reversed(dims):        # innermost dim first: shard order, outer dim major
        counts = _all_gather(counts, 0, (mesh, i))
    return counts[shard - shard % span:shard].sum(dim=0)
