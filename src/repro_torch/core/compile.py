"""The D2A compilation flow driver (Figure 2 / Figure 4).

DSL program (an IR expression from ``repro_torch.core.apps`` or a model importer)
-> e-graph -> equality saturation over compiler-IR + IR-accelerator rewrites
-> cost-based extraction -> an executable program with accelerator
intrinsics, runnable through ``codegen.Executor``.

Extraction is **cost-driven and registry-driven**: every accelerator op is
priced by the :class:`~repro_torch.accel.target.CostModel` its owning
:class:`~repro_torch.accel.target.AcceleratorTarget` declares, so two targets
claiming the same computation are ranked by estimated cycles instead of the
proof-of-concept uniform accel-op cost. A :class:`SelectionPolicy` resolves
the ranking knobs: ``cheapest`` (default) takes the CostModel's word,
``prefer`` routes claimable ops to the named targets, ``forbid`` vetoes
targets outright (their rewrites are not even saturated).

Accel-op costs live in a bounded band ``1 + cycles/(cycles + K) in [1, 2)``
— strictly monotone in estimated cycles, so competing targets order
correctly, yet always below the cheapest host op (2.0), so *whether* to
offload is still decided exactly as the paper's maximize-accelerator-ops
objective does; the CostModel only decides *where*.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from . import ir, rules as R
from .egraph import EGraph, extract_best, host_op_cost, run_rewrites
from .ila import TARGETS

#: cycle-normalization knee: r = cycles / (cycles + K) keeps accel-op costs
#: in [1, 2) while staying strictly monotone in estimated cycles
_CYCLE_KNEE = 1e6
#: accel ops of non-preferred targets move to this band under ``prefer``:
#: still far below heavy/medium host compute (100/1000) — so dense, conv,
#: reductions etc. stay offloaded where no preferred target can claim them
#: — but above a preferred target plus several cheap-glue ops
#: (pattern-introduction overhead like the dense -> dense+0 bias rewrite
#: must not mask the preference). Deliberate consequence: cheap-glue-band
#: host ops (cost 2.0: elementwise mul/sigmoid/relu/add) return to the
#: host rather than run on a non-preferred target.
_DEMOTED_BASE = 8.0


@dataclasses.dataclass(frozen=True)
class SelectionPolicy:
    """How extraction resolves ops claimed by multiple targets.

    ``cheapest`` (the default, empty policy): the target whose CostModel
    predicts the fewest cycles wins. ``prefer`` demotes every *other*
    target's intrinsics to a costlier band: heavy and medium host compute
    (dense/conv/lstm/attention/reductions/normalization) still offloads to
    a non-preferred target when no preferred one claims it, but cheap-glue
    elementwise ops (host cost 2.0 — mul, sigmoid, relu, add) return to
    the host instead of running on a non-preferred accelerator. ``forbid``
    removes the named targets entirely: their rewrites are not saturated
    and any of their intrinsics already in the e-graph price to infinity.
    """

    prefer: Tuple[str, ...] = ()
    forbid: Tuple[str, ...] = ()

    def describe(self) -> str:
        if not self.prefer and not self.forbid:
            return "cheapest"
        parts = []
        if self.prefer:
            parts.append(f"prefer={list(self.prefer)}")
        if self.forbid:
            parts.append(f"forbid={list(self.forbid)}")
        return " ".join(parts)


def make_cost_fn(
    policy: Optional[SelectionPolicy] = None,
    targets: Optional[Sequence[Any]] = None,
) -> Callable:
    """Build the extraction cost function for ``targets`` (AcceleratorTarget
    objects; default = every registered target) under ``policy``.

    Accelerator intrinsics are priced from the owning target's CostModel
    (cycle estimate from the e-class shape analysis of the operands);
    targets without a declared model fall back to the flat accel-op cost.
    Host ops keep :func:`~repro_torch.core.egraph.host_op_cost`'s bands.
    """
    policy = policy or SelectionPolicy()
    targets = TARGETS.all() if targets is None else list(targets)
    prefer, forbid = set(policy.prefer), set(policy.forbid)
    by_op: Dict[str, Tuple[str, Any]] = {}
    for t in targets:
        for op in t.intrinsics:
            by_op[op] = (t.name, t.cost_model)

    def cost_fn(head, child_costs, child_shapes=()) -> float:
        base = sum(child_costs)
        if head[0] != "op":
            return base + 0.01
        op = head[1]
        ent = by_op.get(op)
        if ent is None:
            if op in ir.ACCEL_OPS:
                # an accelerator op no selected target claims: inextricable
                return math.inf
            return base + host_op_cost(op)
        tname, model = ent
        if tname in forbid:
            return math.inf
        band = _DEMOTED_BASE if (prefer and tname not in prefer) else 1.0
        if model is None or not model.covers(op) or any(
            s is None for s in child_shapes
        ):
            return base + band      # shape-blind fallback: flat accel cost
        cycles = model.estimate(op, dict(head[2]), child_shapes).cycles
        return base + band + cycles / (cycles + _CYCLE_KNEE)

    return cost_fn


@dataclasses.dataclass
class CompileResult:
    program: ir.Expr
    stats: Dict[str, Any]
    accelerator_calls: Dict[str, int]
    n_relay_ops: int


def compile_program(
    e: ir.Expr,
    targets: Optional[Sequence[str]] = None,
    flexible: bool = True,
    iters: int = 12,
    node_limit: int = 40_000,
    cost_fn=None,
    policy: Optional[SelectionPolicy] = None,
) -> CompileResult:
    """Run flexible (or exact) matching and extract the best program.

    ``targets`` selects registered accelerator targets by name; the default
    (None) compiles against *every* registered target — a newly registered
    backend starts receiving offloads with no compiler change. ``policy``
    steers which target wins an op claimed by several (see
    :class:`SelectionPolicy`); ``cost_fn`` overrides the registry cost
    function entirely (e.g. :func:`~repro_torch.core.egraph.default_cost` for the
    paper's uniform proof-of-concept costs).

    ``stats["extraction"]`` reports the selection outcome: total extracted
    cost, the policy applied, and per-target op wins (how many intrinsic
    invocations each target received in the extracted program).
    """
    policy = policy or SelectionPolicy()
    selected = [t for t in TARGETS.all(targets) if t.name not in set(policy.forbid)]
    eg = EGraph()
    root = eg.add_expr(e)
    rewrites = R.all_rewrites(targets, flexible, exclude=policy.forbid)
    stats = run_rewrites(eg, rewrites, iters, node_limit)
    if cost_fn is None:
        cost_fn = make_cost_fn(policy, selected)
    best, cost = extract_best(eg, root, cost_fn)
    stats["n_nodes"] = eg.n_nodes
    calls = ir.accelerator_calls(best)
    stats["extraction"] = {
        "cost": cost,
        "policy": policy.describe(),
        "op_wins": {t: n for t, n in calls.items() if n > 0},
    }
    return CompileResult(
        program=best,
        stats=stats,
        accelerator_calls=calls,
        n_relay_ops=ir.count_ops(e),
    )
