"""dtype-overflow: int32 tensors derived from the clock scaled or
accumulated past wraparound.

The port of ``sentinel_tpu/analysis/jaxpr/passes/dtype_overflow.py``,
over the recorded stream.  The engine keeps time as int32 engine-epoch
milliseconds (2^31 ms ≈ 24.8 days).  That survives division, remainder,
comparison and small offsets — what the window and breaker math needs —
but not multiplication or unbounded accumulation: one ``ms * 1000``
wraps in 35 minutes and the verdicts silently corrupt.

Seeds: the port's tick takes the clock as a host integer and hands the
device scalars derived from it, so the shadow run (``framework``) says
which scalar an op was given derives from the clock, with its net scale
against raw ms.  Forward taint over tensor ids then carries a net scale
factor per integer tensor:

* division by a literal d divides the factor, a multiplication by a
  literal m multiplies it (so ``(t // w) * w`` nets out at 1); a left
  shift by k multiplies it by 2^k, a right shift divides;
* remainder by a literal at most 2^24, or a bitwise and with such a mask,
  bounds the value and clears the taint (bucket indices, phases);
* add / sub / min / max / where / clamp / copies / views / scatters keep
  the largest data operand's factor (an index operand carries none: a
  clock-derived bucket index addressing a count table does not taint
  the counts; index results — argsort, nonzero, … — carry none);
* a float or bool result ends the taint;
* flagged at once: a cast or copy of a tainted int into a narrower int;
  a multiplication of a tainted int by a tensor that is not a known
  literal, or of two tainted values; a sum, product or matrix product
  with an int result over a tainted value; a pow with exponent >= 2.

A finding fires where an op first pushes the factor above ``MAX_SCALE``
(4x ms: wrap within 6.2 days), on the port's source line that dispatched
it, so a deliberate wrap (``engine.fold_i32``) is suppressed in place
with ``# stlint: disable=dtype-overflow`` and a rationale.  A clock scale
that the host already pushed past the limit before the scalar reached an
op is flagged at that op.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

from sentinel_tpu_torch.analysis.framework import ERROR, Finding
from sentinel_tpu_torch.analysis.jaxpr.framework import JaxprPass, OpRecord, TensorInfo, TracedEntry

#: max tolerated net scale-up of a raw-ms value (4x ms wraps in ~6 days)
MAX_SCALE = 4.0

#: remainder / mask literals at or below this bound clear taint
_BOUND = float(1 << 24)

#: positional arguments whose taint an op's result carries (the rest
#: are indices, masks or shapes)
_DATA_ARGS = {
    "aten::index": (0,),
    "aten::index_select": (0,),
    "aten::gather": (0,),
    "aten::take": (0,),
    "aten::take_along_dim": (0,),
    "aten::embedding": (0,),
    "aten::index_put": (0, 2),
    "aten::index_put_": (0, 2),
    "aten::_index_put_impl_": (0, 2),
    "aten::scatter": (0, 3),
    "aten::scatter_": (0, 3),
    "aten::scatter_add": (0, 3),
    "aten::scatter_add_": (0, 3),
    "aten::scatter_reduce": (0, 3),
    "aten::scatter_reduce_": (0, 3),
    "aten::index_add": (0, 3),
    "aten::index_add_": (0, 3),
    "aten::index_copy": (0, 3),
    "aten::index_copy_": (0, 3),
    "aten::index_fill": (0, 3),
    "aten::index_fill_": (0, 3),
    "aten::masked_fill": (0, 2),
    "aten::masked_fill_": (0, 2),
    "aten::where": (1, 2),
    "aten::masked_scatter": (0, 2),
    "aten::masked_scatter_": (0, 2),
}

#: results that are indices or counts, never a timestamp
_INDEX_RESULTS = frozenset(
    {"aten::argsort", "aten::argmax", "aten::argmin", "aten::nonzero", "aten::searchsorted", "aten::bucketize",
     "aten::argwhere", "aten::bincount", "aten::count_nonzero", "aten::numel", "aten::sym_size"}
)
#: (values, indices) results: only the values carry taint
_VALUES_FIRST = frozenset(
    {"aten::sort", "aten::topk", "aten::cummax", "aten::cummin", "aten::max", "aten::min", "aten::kthvalue",
     "aten::mode", "aten::median"}
)
_ACCUMULATE = frozenset(
    {"aten::sum", "aten::cumsum", "aten::cumsum_", "aten::prod", "aten::cumprod", "aten::mm", "aten::matmul",
     "aten::dot", "aten::mv", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::_int_mm", "aten::einsum",
     "aten::nansum", "aten::trace"}
)
_MUL = frozenset({"aten::mul", "aten::mul_", "aten::multiply"})
_DIV = frozenset({"aten::div", "aten::div_", "aten::floor_divide", "aten::floor_divide_", "aten::true_divide"})
_REM = frozenset({"aten::remainder", "aten::remainder_", "aten::fmod", "aten::fmod_"})
_AND = frozenset({"aten::bitwise_and", "aten::bitwise_and_", "aten::__and__", "aten::__iand__"})
_LSHIFT = frozenset({"aten::__lshift__", "aten::__ilshift__", "aten::bitwise_left_shift"})
_RSHIFT = frozenset({"aten::__rshift__", "aten::__irshift__", "aten::bitwise_right_shift"})
_POW = frozenset({"aten::pow", "aten::pow_", "aten::float_power"})
_CASTS = frozenset({"aten::_to_copy", "aten::copy_"})
_LITERAL_MAKERS = frozenset({"aten::scalar_tensor", "aten::lift_fresh", "aten::full"})


def _literal(x: Any) -> Optional[float]:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return None
    return abs(float(x))


class _Taint:
    """One traversal: factors by tensor id, known literal tensors, findings
    deduplicated by source line."""

    def __init__(self, outer: "DtypeOverflowPass", entry: TracedEntry):
        self.outer = outer
        self.entry = entry
        self.env: Dict[int, float] = {}
        self.lit: Dict[int, float] = {}  # tid -> |value| of a 0-d literal tensor
        self.findings: List[Finding] = []
        self._sites = set()

    def flag(self, op: OpRecord, message: str) -> None:
        key = (op.source, message[:60])
        if key in self._sites:
            return
        self._sites.add(key)
        self.findings.append(self.outer.finding(self.entry, message, source=op.source))

    def factor(self, op: OpRecord, j: int) -> Optional[float]:
        x = op.inputs[j]
        if isinstance(x, TensorInfo):
            return self.env.get(x.tid)
        return op.time_scale.get(j) or None

    def literal_of(self, op: OpRecord, j: int) -> Optional[float]:
        x = op.inputs[j]
        if isinstance(x, TensorInfo):
            return self.lit.get(x.tid)
        return _literal(x)

    def step(self, op: OpRecord) -> None:
        name = op.base
        outs = op.outputs
        if name in _LITERAL_MAKERS and outs and outs[0].shape == ():
            val = op.host_value if name == "aten::lift_fresh" else next(
                (x for x in op.inputs if _literal(x) is not None), None
            )
            if _literal(val) is not None and not op.time_scale:
                self.lit[outs[0].tid] = _literal(val)
        data = _DATA_ARGS.get(name)
        idx = [j for j in range(len(op.inputs)) if data is None or op.arg_of[j] in data]
        fins = {j: self.factor(op, j) for j in idx}
        if op.time_scale.get(-1):
            fins[-1] = op.time_scale[-1]
        tainted = {j: f for j, f in fins.items() if f is not None}
        if not tainted or not outs:
            return
        f_in = max(tainted.values())
        out = outs[0]
        out_f: Optional[float] = f_in
        flagged = False
        host = [f for j, f in tainted.items() if j == -1 or not isinstance(op.inputs[j], TensorInfo)]
        if host and max(host) > MAX_SCALE and out.is_int:
            self.flag(
                op,
                f"{op.name} is given a clock-derived scalar at net scale "
                f"{max(host):.0f}x ms — the host scaled the timestamp before "
                "it reached the device; int32 wraps within "
                f"{2**31 / max(host) / 86_400_000:.1f} days of engine uptime",
            )
            flagged = True
        if name in _INDEX_RESULTS:
            return
        if name in _CASTS:
            src_arg = 1 if name == "aten::copy_" else 0
            src = next(
                (op.inputs[j] for j in tainted if j >= 0 and op.arg_of[j] == src_arg and isinstance(op.inputs[j], TensorInfo)),
                None,
            )
            if src is not None and out.is_int and src.is_int and out.bits < src.bits:
                self.flag(
                    op,
                    f"clock-derived {src.dtype} narrowed to {out.dtype} — a "
                    "cast that wraps past 2^31 silently; widen the consumer "
                    "or bound the value (remainder / mask) before the cast",
                )
                flagged = True
        elif name in _MUL:
            operands = [j for j in idx if op.arg_of[j] in (0, 1)]
            if len([j for j in operands if j in tainted]) >= 2:
                self.flag(
                    op,
                    "product of two clock-derived values — wraps for any "
                    "epoch past ~46 s; compute durations (sub) before "
                    "multiplying",
                )
                flagged, out_f = True, math.inf
            else:
                other = next((j for j in operands if j not in tainted), None)
                lit = self.literal_of(op, other) if other is not None else None
                if lit is None:
                    self.flag(
                        op,
                        "clock-derived int multiplied by a tensor that is not "
                        "a known literal — unbounded scale-up of a time-scale "
                        "quantity; rescale in float or bound the factor",
                    )
                    flagged, out_f = True, math.inf
                else:
                    out_f = f_in * max(lit, 1.0)
        elif name in _DIV:
            lit = self.literal_of(op, 1) if len(op.inputs) > 1 and 0 in tainted else None
            out_f = f_in / max(lit, 1.0) if lit else f_in
        elif name in _REM or name in _AND:
            lit = self.literal_of(op, 1) if len(op.inputs) > 1 else None
            out_f = None if lit is not None and 0 < lit <= _BOUND else f_in
        elif name in _LSHIFT or name in _RSHIFT:
            lit = self.literal_of(op, 1) if len(op.inputs) > 1 else None
            if lit is None:
                out_f = math.inf if name in _LSHIFT else f_in
            else:
                out_f = f_in * 2.0 ** lit if name in _LSHIFT else f_in / 2.0 ** lit
        elif name in _ACCUMULATE:
            if out.is_int:
                self.flag(
                    op,
                    f"{op.name} accumulates clock-derived int values — "
                    "length-scaled accumulation wraps; sum durations, not "
                    "epochs, or widen / bound first",
                )
                flagged, out_f = True, math.inf
        elif name in _POW:
            exp = self.literal_of(op, 1) if len(op.inputs) > 1 else None
            if exp is None or exp >= 2:
                self.flag(
                    op,
                    f"clock-derived int raised to a power ({op.name}) — wraps "
                    "for any epoch past ~46 s (the class of t*t); compute "
                    "durations before raising",
                )
                flagged, out_f = True, math.inf
        targets = outs[:1] if name in _VALUES_FIRST else outs
        if out_f is not None and not flagged and out_f > MAX_SCALE and f_in <= MAX_SCALE:
            self.flag(
                op,
                f"{op.name} scales a clock-derived int by net factor "
                f"{out_f:.0f}x ms — int32 wraps within "
                f"{2**31 / out_f / 86_400_000:.1f} days of engine uptime; "
                "keep ms scale (divide, don't multiply) or widen deliberately "
                "with a suppression rationale",
            )
        for t in targets:
            if out_f is not None and t.is_int:
                self.env[t.tid] = out_f
            else:
                self.env.pop(t.tid, None)


class DtypeOverflowPass(JaxprPass):
    name = "dtype-overflow"
    description = "int32 clock lineage must not be scaled or accumulated past wrap"
    severity = ERROR

    def run(self, entry: TracedEntry) -> Iterable[Finding]:
        if entry.time_arg is None:
            return []
        if entry.shadow_error is not None:
            return [
                self.finding(
                    entry,
                    f"the shadow run did not line up ({entry.shadow_error}) "
                    "— the clock taint could not be seeded, so this entry's "
                    "time arithmetic went unchecked; make the dispatched "
                    "ops independent of the clock's value",
                )
            ]
        t = _Taint(self, entry)
        for op in entry.ops:
            t.step(op)
        return t.findings
