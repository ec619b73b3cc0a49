"""Recorded-op-stream framework of the port's ``jaxpr`` tier.

The port of ``sentinel_tpu/analysis/jaxpr/framework.py``, by intent.
The reference traces each entry point to a ClosedJaxpr and walks its
equations.  The port has no tracer: its entries run eagerly.  So this
tier reads the dispatched ATen stream, not a jaxpr: each entry runs
under a :class:`OpRecorder` (a ``TorchDispatchMode``), which records
every ATen overload it dispatches with its inputs' and outputs' dtypes,
shapes, devices and byte counts, the Python scalars it was given, and
the source line of the port that dispatched it.  The tier keeps the
reference's path, tier name and five rule ids.

What the dispatcher cannot see, the entry records beside the stream:

* the kernels.  B1–B4 and ``seg_build`` are reached through ``ctypes``
  (``ops/_build.py``), so each entry reads the port's launch counters
  (``fused.LAUNCHES``, ``segscan.LAUNCHES``) around its call;
* the host reads.  ``Tensor.cpu()``, ``.numpy()``, ``.tolist()`` and
  ``np.asarray(t)`` of a tensor on the CPU dispatch no ATen op (only
  ``.item()`` does: ``_local_scalar_dense``), so a
  :class:`HostReadRecorder` (a ``TorchFunctionMode``) records those calls
  at the Python surface, on every device;
* where the time went.  The tick's clock argument is a host integer:
  the tick does its window arithmetic on the host and hands the device
  scalars.  So each entry runs a second time with its time argument
  moved by ``SHADOW_DELTA_MS`` (the shadow run), and a scalar that
  differs between the two streams at the same op derives from the clock,
  with net scale ``|Δscalar| / Δt`` (``t // 500`` scales by 1/500,
  ``t * 1000`` by 1000, a bucket index ``(t // w) % n`` not at all).
  The same comparison says which host data an op uploads came in through
  the arguments (it moves with them) and which is a host constant.

Each entry runs once unrecorded first, so caches a first call fills
(plans, the salsa shift table) are warm and both recorded streams are
the steady state.

Findings reuse the tier-1 :class:`Finding` / baseline machinery.  An op's
finding lands on the port's source line that dispatched it, so tier-1
``# stlint: disable=`` comments there apply; whole-entry findings
(fingerprints, budgets) anchor on the pseudo-path ``jaxpr://<entry>``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from sentinel_tpu_torch.analysis.framework import ERROR, Finding, parse_suppressions

#: directory of the golden files (fingerprints.json, budgets.json)
JAXPR_DIR = os.path.dirname(os.path.abspath(__file__))
FINGERPRINTS_PATH = os.path.join(JAXPR_DIR, "fingerprints.json")
BUDGETS_PATH = os.path.join(JAXPR_DIR, "budgets.json")

#: the device the goldens' "card" block is recorded on and read for
CARD_DEVICE = "cuda"

#: the shadow run's move of the time argument: one hour, a whole number of
#: every window and bucket period the engine uses, so bucket indices and
#: phases come out equal in both runs and only clock-scaled values move
SHADOW_DELTA_MS = 3_600_000

#: kernel launch counters each entry reads around its call:
#: (module, counter key) -> the kernel's name in the port's B-numbering
KERNEL_COUNTERS = (
    ("sentinel_tpu_torch.ops.fused", "scatter_many", "B1"),
    ("sentinel_tpu_torch.ops.fused", "gather_many", "B2"),
    ("sentinel_tpu_torch.ops.segscan", "seg_excl_cumsum", "B3"),
    ("sentinel_tpu_torch.ops.segscan", "seg_incl_min", "B4"),
    ("sentinel_tpu_torch.ops.segscan", "seg_build", "B4 seg_build"),
)

#: ops that queue no work: allocation without initialization, the host's
#: view of a scalar it already holds, a readback (transfer-guard reports
#: those); views are recognized from the schema.  Names without overload,
#: as ``OpRecord.base``
NO_WORK = frozenset(
    {
        "aten::empty",
        "aten::empty_like",
        "aten::empty_strided",
        "aten::new_empty",
        "aten::new_empty_strided",
        "aten::lift_fresh",
        "aten::_local_scalar_dense",
        "aten::set_",
        "aten::resize_",
        "aten::record_stream",
    }
)

#: ops that make a tensor from host data (an upload, on the card)
HOST_MADE = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy"})

#: Tensor methods that hand a tensor's contents to the host: on the card a
#: device->host read, on the CPU no ATen op at all (``np.asarray(t)``
#: reaches ``__array__``)
HOST_READS = frozenset({"cpu", "numpy", "tolist", "__array__"})


@dataclass(frozen=True)
class TensorInfo:
    """One tensor as an op saw it."""

    tid: int  # serial id of the tensor object within the recording
    dtype: str  # "int32"
    shape: Tuple[int, ...]
    device: str  # "cpu" / "cuda"
    nbytes: int
    #: where the tensor came from: "arg" (the entry's arguments), "made"
    #: (an op of this call produced it) or "external" (neither: read from
    #: a module, a closure or a cache)
    origin: str

    @property
    def is_int(self) -> bool:
        return self.dtype.startswith(("int", "uint"))

    @property
    def bits(self) -> int:
        digits = "".join(c for c in self.dtype if c.isdigit())
        return int(digits) if digits else 0


@dataclass
class OpRecord:
    """One dispatched ATen overload."""

    name: str  # "aten::add.Tensor"
    inputs: Tuple[Any, ...]  # TensorInfo or a normalized scalar, flattened
    #: for each flattened input, the positional argument it came from
    #: (keyword arguments count on from their schema position)
    arg_of: Tuple[int, ...]
    outputs: Tuple[TensorInfo, ...]
    source: Optional[Tuple[str, int]]  # (repo-relative path, line)
    #: True when the overload queues device work (not a view, not NO_WORK)
    launches: bool = True
    #: host data made into a tensor by this op (HOST_MADE): its Python
    #: value when 0-d, else a digest of its bytes; None elsewhere
    host_value: Any = None
    #: filled from the shadow run: input position -> net clock scale of the
    #: int scalar there; -1 -> the scale of the host data this op made
    time_scale: Dict[int, float] = field(default_factory=dict)
    #: filled from the shadow run: the host data this op made moved with
    #: the arguments (so it came in through them)
    host_varies: bool = False

    @property
    def base(self) -> str:
        return self.name.split(".", 1)[0]

    def tensor_inputs(self) -> List[TensorInfo]:
        return [x for x in self.inputs if isinstance(x, TensorInfo)]


@dataclass(frozen=True)
class HostRead:
    """One call of a :data:`HOST_READS` method."""

    method: str  # "numpy"
    dtype: str
    shape: Tuple[int, ...]
    device: str
    source: Optional[Tuple[str, int]]


@dataclass
class TracedEntry:
    """One recorded entry point: the unit every pass of this tier runs over."""

    name: str  # e.g. "tick/plain"
    path: str  # repo-relative path of the DEFINING module (for findings)
    device: str  # the device the entry ran on
    ops: List[OpRecord] = field(default_factory=list)
    #: the primary run's host reads (HostReadRecorder)
    host_reads: List[HostRead] = field(default_factory=list)
    #: positional index of the time argument (None: the entry has none)
    time_arg: Optional[int] = None
    #: True for the tick entries (transfer-guard's scope)
    tick: bool = False
    n_args: int = 0  # flattened argument leaves
    n_outputs: int = 0  # flattened output leaves
    #: the primary run's return value (kept for the equality checks)
    outputs: Any = None
    #: kernel launches of the primary run, by counter key
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    #: None when the shadow run dispatched the same overloads in the same
    #: order; else why not (the clock taint could not be seeded)
    shadow_error: Optional[str] = None
    #: True when the entry's config runs the packed-wire transport
    #: (cfg.packed_wire): transfer-guard pins its readback surface
    packed_wire: bool = False
    #: TickOutput fields the recorded tick returned as tensors (observed
    #: from the output, not re-derived from the config); packed-wire tick
    #: entries only, None elsewhere
    readback_fields: Optional[Tuple[str, ...]] = None

    @property
    def pseudo_path(self) -> str:
        return f"jaxpr://{self.name}"

    @property
    def aten_launches(self) -> int:
        return sum(1 for op in self.ops if op.launches)

    @property
    def launches(self) -> int:
        """ATen ops that launch work plus the port's kernel launches."""
        return self.aten_launches + sum(self.kernel_launches.values())

    @property
    def bytes(self) -> int:
        """Bytes the launching ATen ops read and write: each op's tensor
        inputs and outputs, once each (the kernels' own traffic is not
        visible to the dispatcher and not counted)."""
        total = 0
        for op in self.ops:
            if not op.launches:
                continue
            seen = set()
            for t in list(op.tensor_inputs()) + list(op.outputs):
                if t.tid not in seen:
                    seen.add(t.tid)
                    total += t.nbytes
        return total

    @property
    def cost(self) -> Dict[str, int]:
        return {"launches": self.launches, "bytes": self.bytes}


class JaxprPass:
    """One pass over a recorded entry point."""

    name: str = ""
    description: str = ""
    severity: str = ERROR

    def run(self, entry: TracedEntry) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(
        self,
        entry: TracedEntry,
        message: str,
        severity: Optional[str] = None,
        source: Optional[Tuple[str, int]] = None,
    ) -> Finding:
        path, line = source if source else (entry.pseudo_path, 1)
        return Finding(
            rule=self.name,
            path=path,
            line=line,
            col=0,
            message=f"[{entry.name}] {message}",
            severity=severity or self.severity,
        )


# -- recording -----------------------------------------------------------------


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(JAXPR_DIR)))


_PKG = os.sep + "sentinel_tpu_torch" + os.sep
_ANALYSIS = os.sep + "analysis" + os.sep


def _caller_source(root: str) -> Optional[Tuple[str, int]]:
    """(repo-relative path, line) of the innermost frame of the port,
    outside this analysis package, on the current stack."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and _ANALYSIS not in fn:
            return os.path.relpath(fn, root).replace(os.sep, "/"), f.f_lineno
        f = f.f_back
    return None


def _norm_scalar(x: Any) -> Any:
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return tuple(_norm_scalar(v) for v in x)
    return str(x)


def _is_view(func) -> bool:
    """True when the overload returns an alias of an input it does not
    write (a view): it queues no work."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write for r in rets)


class OpRecorder(TorchDispatchMode):
    """Record every ATen overload dispatched inside the mode;
    ``device``: the device the entry runs on."""

    def __init__(self, arg_tensors: Sequence[Any] = (), device: str = "cpu"):
        super().__init__()
        self.root = _repo_root()
        self.device = device
        self._ids: Dict[int, int] = {}  # id(tensor) -> tid
        self._origin: Dict[int, str] = {}
        self._keep: List[Any] = []  # every tensor seen stays alive: ids stay unique
        self.ops: List[OpRecord] = []
        for t in arg_tensors:
            self._info(t, "arg")

    def _info(self, t, origin: str) -> TensorInfo:
        tid = self._ids.get(id(t))
        if tid is None:
            tid = len(self._origin)
            self._ids[id(t)] = tid
            self._origin[tid] = origin
            self._keep.append(t)
        return TensorInfo(
            tid=tid,
            dtype=str(t.dtype).replace("torch.", ""),
            shape=tuple(int(d) for d in t.shape),
            device=t.device.type,
            nbytes=t.numel() * t.element_size(),
            origin=self._origin[tid],
        )

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        names = [a.name for a in func._schema.arguments]
        parts = list(enumerate(args)) + [
            (names.index(k) if k in names else len(names), v) for k, v in kwargs.items()
        ]
        base = func._schema.name
        # the tensor torch.tensor() lifts was made from host data in
        # this call, outside the dispatcher
        first_seen = "made" if base in HOST_MADE else "external"
        inputs, arg_of = [], []
        for pos, v in parts:
            for a in tree_flatten(v)[0]:
                inputs.append(self._info(a, first_seen) if isinstance(a, torch.Tensor) else _norm_scalar(a))
                arg_of.append(pos)
        out = func(*args, **kwargs)
        name = f"{base}.{func._overloadname}"
        outs = tuple(self._info(o, "made") for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor))
        host_value = None
        if base in HOST_MADE:
            o = tree_flatten(out)[0][0]
            if o.device.type == "cpu":
                host_value = o.item() if o.dim() == 0 else hashlib.sha256(o.numpy().tobytes()).hexdigest()[:16]
        launches = base not in NO_WORK and not _is_view(func)
        if launches and self.device != "cpu":
            # on the card, an op whose tensors all lie on the host
            # (a wrapped Python scalar) launches nothing
            launches = any(t.device != "cpu" for t in inputs + list(outs) if isinstance(t, TensorInfo))
        self.ops.append(
            OpRecord(
                name=name,
                inputs=tuple(inputs),
                arg_of=tuple(arg_of),
                outputs=outs,
                source=_caller_source(self.root),
                launches=launches,
                host_value=host_value,
            )
        )
        return out


class HostReadRecorder(TorchFunctionMode):
    """Record every call of a :data:`HOST_READS` method of a tensor made
    inside the mode."""

    def __init__(self):
        super().__init__()
        self.root = _repo_root()
        self.reads: List[HostRead] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_READS and args and isinstance(args[0], torch.Tensor):
            t = args[0]
            self.reads.append(
                HostRead(
                    method=name,
                    dtype=str(t.dtype).replace("torch.", ""),
                    shape=tuple(int(d) for d in t.shape),
                    device=t.device.type,
                    source=_caller_source(self.root),
                )
            )
        return func(*args, **(kwargs or {}))


def _flat_tensors(tree) -> Tuple[List[Any], int]:
    leaves = tree_flatten(tree)[0]
    return [x for x in leaves if isinstance(x, torch.Tensor)], len(leaves)


def _kernel_counts() -> Dict[str, int]:
    return {key: importlib.import_module(mod).LAUNCHES[key] for mod, key, _b in KERNEL_COUNTERS}


def record_call(
    fn: Callable, args: Sequence[Any], device: str, call_context: Callable = contextlib.nullcontext
) -> Tuple[List[OpRecord], List[HostRead], Any, Dict[str, int], int, int]:
    """Run ``fn(*args)`` under the recorders, inside ``call_context()``:
    (ops, host reads, return value, kernel launches by counter key,
    flattened argument leaves, flattened output leaves)."""
    arg_tensors, n_args = _flat_tensors(tuple(args))
    rec, reads = OpRecorder(arg_tensors, device), HostReadRecorder()
    before = _kernel_counts()
    with rec, reads, call_context():
        out = fn(*args)
    after = _kernel_counts()
    launches = {k: after[k] - before[k] for k in after}
    return rec.ops, reads.reads, out, launches, n_args, len(tree_flatten(out)[0])


def _shift_time(args: Sequence[Any], time_arg: int, delta: int) -> tuple:
    args = list(args)
    args[time_arg] = args[time_arg] + delta
    return tuple(args)


def seed_from_shadow(ops: List[OpRecord], shadow: List[OpRecord], delta: int) -> Optional[str]:
    """Fill ``time_scale`` / ``host_varies`` of ``ops`` from the shadow
    run's stream; returns why the streams do not line up, or None."""
    if len(ops) != len(shadow):
        return f"the shadow run dispatched {len(shadow)} ops, the primary {len(ops)}"
    for i, (a, b) in enumerate(zip(ops, shadow)):
        if a.name != b.name or len(a.inputs) != len(b.inputs):
            return f"op {i}: the shadow run dispatched {b.name} where the primary dispatched {a.name}"
        for j, (x, y) in enumerate(zip(a.inputs, b.inputs)):
            if type(x) is int and type(y) is int and x != y:
                a.time_scale[j] = abs(y - x) / delta
        if a.host_value is not None and a.host_value != b.host_value:
            a.host_varies = True
            if type(a.host_value) is int and type(b.host_value) is int:
                a.time_scale[-1] = abs(b.host_value - a.host_value) / delta
    return None


def trace_entry(
    name: str,
    path: str,
    fn: Callable,
    make_args: Callable[[], Sequence[Any]],
    device: str,
    time_arg: Optional[int] = None,
    tick: bool = False,
    call_context: Callable = contextlib.nullcontext,
) -> TracedEntry:
    """Record one entry: a warm-up call, the primary call, and (with a
    time argument) the shadow call on fresh arguments each.  Every call
    runs inside ``call_context()`` (its arguments are made outside it): on the
    card, ``torch.cuda.set_sync_debug_mode("error")`` proves a call waits
    for nothing."""
    args = make_args()
    with call_context():
        fn(*args)  # warm: first-call caches filled before recording
    ops, reads, out, launches, n_args, n_out = record_call(fn, make_args(), device, call_context)
    entry = TracedEntry(
        name=name,
        path=path,
        device=device,
        ops=ops,
        host_reads=reads,
        time_arg=time_arg,
        tick=tick,
        n_args=n_args,
        n_outputs=n_out,
        outputs=out,
        kernel_launches=launches,
    )
    if time_arg is not None:
        shadow, *_ = record_call(fn, _shift_time(make_args(), time_arg, SHADOW_DELTA_MS), device, call_context)
        entry.shadow_error = seed_from_shadow(ops, shadow, SHADOW_DELTA_MS)
    return entry


# -- fingerprints ----------------------------------------------------------------


def _sig_item(x: Any) -> str:
    if isinstance(x, TensorInfo):
        return f"{x.dtype}/{len(x.shape)}"
    return type(x).__name__


def entry_signature(entry: TracedEntry) -> Dict[str, Any]:
    """Stable structural signature of a recorded entry: a hash of the
    ordered overload names with their operands' and results' dtypes and
    ranks (scalars by type), the op count, and the argument and output
    leaf counts.  A new op, a dropped op, a dtype or rank change, or a
    reordered stream all change the hash; values and sizes do not."""
    norm = [
        [op.name, [_sig_item(x) for x in op.inputs], [_sig_item(x) for x in op.outputs]]
        for op in entry.ops
    ]
    blob = json.dumps(norm, separators=(",", ":"))
    return {
        "hash": hashlib.sha256(blob.encode()).hexdigest()[:16],
        "ops": len(entry.ops),
        "args": entry.n_args,
        "outputs": entry.n_outputs,
    }


def load_golden(path: str) -> Dict[str, Any]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def golden_block(golden: Dict[str, Any], device: str) -> Dict[str, Any]:
    """The block of a golden file that holds ``device``'s recording: the
    top level for the CPU, ``"card"`` for any other device."""
    return golden if device == "cpu" else golden.get("card", {})


def save_golden(path: str, data: Dict[str, Any]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


# -- runner ------------------------------------------------------------------------


def _source_suppressed(repo_root: str, cache: Dict[str, Any], f: Finding) -> bool:
    """Honor tier-1 ``# stlint: disable=`` comments for findings that
    landed on a real source line."""
    if f.path.startswith("jaxpr://"):
        return False
    table = cache.get(f.path)
    if table is None:
        try:
            with open(os.path.join(repo_root, f.path), "r", encoding="utf-8") as fh:
                table = parse_suppressions(fh.read())
        except OSError:
            table = ({}, set())
        cache[f.path] = table
    line_disables, file_disables = table
    if "*" in file_disables or f.rule in file_disables:
        return True
    at = line_disables.get(f.line, ())
    return "*" in at or f.rule in at


def run_jaxpr_passes(
    entries: Iterable[TracedEntry],
    passes: Iterable[JaxprPass],
    repo_root: str,
) -> List[Finding]:
    findings: List[Finding] = []
    sup_cache: Dict[str, Any] = {}
    passes = list(passes)
    for entry in entries:
        for p in passes:
            for f in p.run(entry):
                if not _source_suppressed(repo_root, sup_cache, f):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings
