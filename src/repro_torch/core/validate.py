"""Compilation-results validation (Section 2.3 / 4.4).

Three verification tasks (Figure 3), adapted as recorded in DESIGN.md §3:

* **VT1** — compiler-IR ILA vs the compiler implementation. The IR
  interpreter *is* the executable IR-ILA model; VT1 checks it per-intrinsic
  against independent NumPy implementations (modular, per-instruction).
* **VT2** — program-fragment equivalence between the compiler-IR fragment
  and the accelerator fragment **over abstract data types** (fp32 stands in
  for the symbolic datatype, mirroring the paper's proofs that abstract away
  numerics): both sides evaluated with ideal semantics must agree exactly.
  The finite-domain *exhaustive* variant (Table 3 analogue) enumerates the
  whole input lattice for small shapes — a decidable, complete check.
* **VT3** — accelerator ILA vs implementation. With no RTL available, the
  implementation is the numerics-matched CUDA kernel the target ships
  (``af_gemm`` for FlexASR, ``int8_gemm`` for VTA); both are bit-accurate in
  the custom numeric and must agree.

Plus **simulation-based mapping validation** (Table 2): relative Frobenius
error of the ILA simulation (custom numerics) against the fp32 IR
interpreter over N random inputs.

All three tasks (and Table 2) run generically over the target registry:
each ``AcceleratorTarget`` declares its VT2 fragment pairs, VT3 checks and
mapping cases, and the runners here enumerate them. Every runner that
interprets or simulates takes ``device`` (``None`` -> CUDA); inputs are
drawn from numpy generators seeded exactly as the JAX reference seeds them,
and the VT1 oracles stay numpy, independent of the interpreter under test.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..accel.target import VT2Case  # noqa: F401  (re-export; registers targets)
from ..device import DeviceLike, resolve
from . import ir
from .codegen import to_numpy
from .ila import TARGETS


def frob_rel_err(ref: np.ndarray, out: np.ndarray) -> float:
    """Error = ||ref - out||_F / ||ref||_F (Section 4.4.1)."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    d = np.linalg.norm(ref)
    return float(np.linalg.norm(ref - out) / d) if d > 0 else 0.0


# ---------------------------------------------------------------------------
# VT1: compiler-IR ILA (interpreter) vs independent implementations
# ---------------------------------------------------------------------------


def _np_dense(x, w):
    return x @ w.T


def _np_bias_add(x, b):
    return x + b


def _np_layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    va = x.var(-1, keepdims=True)
    return (x - mu) / np.sqrt(va + eps) * g + b


def _np_conv2d(x, w, strides, padding):
    n, h, wd, c = x.shape
    kh, kw, ci, co = w.shape
    sh, sw = strides
    ph, pw = padding
    xp = np.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (wd + 2 * pw - kw) // sw + 1
    out = np.zeros((n, oh, ow, co), np.float64)
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, i * sh : i * sh + kh, j * sw : j * sw + kw, :]
            out[:, i, j, :] = np.tensordot(patch, w, axes=([1, 2, 3], [0, 1, 2]))
    return out


VT1_CASES = {
    "dense": (
        lambda r: (r.standard_normal((5, 7)).astype(np.float32),
                   r.standard_normal((3, 7)).astype(np.float32)),
        _np_dense,
    ),
    "bias_add": (
        lambda r: (r.standard_normal((5, 3)).astype(np.float32),
                   r.standard_normal((3,)).astype(np.float32)),
        _np_bias_add,
    ),
    "layer_norm": (
        lambda r: (r.standard_normal((5, 8)).astype(np.float32),
                   r.standard_normal((8,)).astype(np.float32),
                   r.standard_normal((8,)).astype(np.float32)),
        _np_layer_norm,
    ),
    "conv2d": (
        lambda r: (r.standard_normal((2, 6, 6, 3)).astype(np.float32),
                   r.standard_normal((3, 3, 3, 4)).astype(np.float32)),
        lambda x, w: _np_conv2d(x, w, (1, 1), (0, 0)),
    ),
}


def vt1_outputs(op: str, n: int = 20, seed: int = 0, device: DeviceLike = None):
    """The VT1 draws of ``op``: ``[(interpreter output, numpy oracle)]``
    for ``n`` random inputs, interpreted on ``device``."""
    dev = resolve(device)
    gen, np_impl = VT1_CASES[op]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        args = gen(rng)
        vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
        attrs = {"strides": (1, 1), "padding": (0, 0)} if op == "conv2d" else {}
        expr = ir.call(op, *vs, **attrs)
        got = to_numpy(ir.interpret(expr, {f"_{i}": a for i, a in enumerate(args)},
                                    device=dev))
        out.append((got, np_impl(*args)))
    return out


def vt1_check(op: str, n: int = 20, seed: int = 0, tol: float = 1e-4,
              device: DeviceLike = None) -> bool:
    """Modular per-instruction check: IR-ILA (interpreter) vs independent
    NumPy implementation, over random inputs."""
    return all(frob_rel_err(want, got) <= tol
               for got, want in vt1_outputs(op, n, seed, device))


# ---------------------------------------------------------------------------
# VT2: fragment-vs-fragment equivalence over abstract data types
# ---------------------------------------------------------------------------


def vt2_cases(dim_t: int = 16, dim_d: int = 64, targets=None) -> List[VT2Case]:
    """Every VT2 fragment-equivalence case the selected targets declare
    (None = all registered). Case shapes are parameterized by (dim_t, dim_d)
    where the target's operand geometry allows it."""
    out: List[VT2Case] = []
    for t in TARGETS.all(targets):
        out.extend(t.vt2_cases(dim_t, dim_d))
    return out


def _both_sides(case: VT2Case, env, dev):
    r1 = to_numpy(ir.interpret(case.ir_fragment, env, device=dev))
    r2 = to_numpy(ir.interpret(case.accel_fragment, env, device=dev))
    return r1, r2


def vt2_check(case: VT2Case, n: int = 20, seed: int = 0, tol: Optional[float] = None,
              device: DeviceLike = None) -> bool:
    """Random simulation over the abstract (fp32) semantics: both fragments
    must agree to float tolerance (the SMT proof's sound-but-incomplete
    testing analogue; the exhaustive variant below is complete).

    ``tol=None`` (the default) resolves the bound from the case itself:
    each target stamps its declared :attr:`AcceleratorTarget.vt2_tol` onto
    the cases it enumerates."""
    if tol is None:
        tol = case.tol if case.tol is not None else 1e-5
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        env = {k: rng.standard_normal(s).astype(np.float32) for k, s in case.var_shapes.items()}
        r1, r2 = _both_sides(case, env, dev)
        if r1.shape != r2.shape or frob_rel_err(r1, r2) > tol:
            return False
    return True


def vt2_exhaustive(case: VT2Case, lattice: Sequence[float], max_vars: int = 64,
                   device: DeviceLike = None) -> Tuple[bool, int]:
    """Finite-domain complete check (Table 3 analogue): enumerate *every*
    assignment of lattice values to the fragment inputs. Feasible for small
    shapes; returns (equivalent, n_assignments)."""
    names = sorted(case.var_shapes)
    sizes = [int(np.prod(case.var_shapes[n])) for n in names]
    total_elems = sum(sizes)
    if total_elems > max_vars:
        raise ValueError(f"{total_elems} scalar inputs > max_vars={max_vars}")
    dev = resolve(device)
    count = 0
    for assign in itertools.product(lattice, repeat=total_elems):
        env = {}
        off = 0
        for n, sz in zip(names, sizes):
            env[n] = np.asarray(assign[off : off + sz], np.float32).reshape(case.var_shapes[n])
            off += sz
        r1, r2 = _both_sides(case, env, dev)
        count += 1
        if r1.shape != r2.shape or not np.allclose(r1, r2, atol=1e-5):
            return False, count
    return True, count


# ---------------------------------------------------------------------------
# VT3: accelerator ILA vs implementation
# ---------------------------------------------------------------------------
#
# Each target declares its own implementation checks (ILA vs the
# numerics-matched CUDA kernel it ships); this runner enumerates whatever
# the registry declares. On a CUDA device each check launches its kernel.


def vt3_results(targets=None, device: DeviceLike = None
                ) -> Dict[str, Dict[str, Tuple[bool, float]]]:
    """Run every declared VT3 check on ``device``:
    {target: {check: (ok, worst_abs_dev)}}. Targets with no separate
    implementation declare no checks (empty dict)."""
    dev = resolve(device)
    out: Dict[str, Dict[str, Tuple[bool, float]]] = {}
    for t in TARGETS.all(targets):
        out[t.name] = {name: fn(device=dev) for name, fn in t.vt3_checks.items()}
    return out


# ---------------------------------------------------------------------------
# Simulation-based mapping validation (Table 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MappingValidation:
    accelerator: str
    operation: str
    avg_err: float
    std_err: float
    n_inputs: int


def mapping_outputs(n_inputs: int = 100, seed: int = 0, targets=None,
                    device: DeviceLike = None):
    """Table 2's raw draws: ``[(target, display name, operation,
    [(reference, simulated), ...])]`` in the registry's order, each case
    run ``n_inputs`` times on ``device``."""
    dev = resolve(device)
    out = []
    for t in TARGETS.all(targets):
        rng = np.random.default_rng(seed)
        for opname, case in t.mapping_cases(rng):
            pairs = [tuple(np.asarray(a) for a in case(device=dev)) for _ in range(n_inputs)]
            out.append((t.name, t.display_name, opname, pairs))
    return out


def validate_mappings(n_inputs: int = 100, seed: int = 0, targets=None,
                      device: DeviceLike = None) -> List[MappingValidation]:
    """Table 2: per-mapping relative error statistics over random inputs,
    for every (accelerator, operation) case the selected targets declare."""
    out = []
    for _, display, opname, pairs in mapping_outputs(n_inputs, seed, targets, device):
        errs = [frob_rel_err(ref, got) for ref, got in pairs]
        out.append(MappingValidation(display, opname, float(np.mean(errs)),
                                     float(np.std(errs)), n_inputs))
    return out
