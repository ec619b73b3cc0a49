"""sentinel_tpu_torch.analysis.jaxpr — the port's tier-2 analyzer, which
reads the dispatched ATen stream where the reference reads a jaxpr.

Counterparts of tests/test_jaxpr_analysis.py:

1. every pass on tiny recorded fixtures, one flagged and one clean per
   rule — including the demonstration the tier exists for: a
   module-level tensor read inside an entry is caught here and invisible
   to the AST tier;
2. golden mechanics: fingerprint missing / drift (with the torch version
   named), budget breach / missing / pass;
3. THE CI GATE: the 13 real entries recorded on the CPU are clean against
   the committed goldens, the goldens cover every entry, the plain config
   calls no kernel wrapper, the tick entries' inputs equal the
   reference's ``_mk_tick_inputs`` and the plain and cluster-token ticks'
   outputs equal the reference's tick on those inputs (the other four
   tick entries: tests/test_torch_jaxpr_ticks.py).

Entries are recorded once per process (``trace_entries`` caches them).
"""

from __future__ import annotations

import ast
import textwrap

import numpy as np
import pytest
import torch

from sentinel_tpu_torch.analysis import ALL_PASSES, REPO_ROOT
from sentinel_tpu_torch.analysis.framework import ParsedModule, parse_suppressions
from sentinel_tpu_torch.analysis.jaxpr import (
    entry_signature,
    load_golden,
    run_jaxpr_analysis,
    save_golden,
)
from sentinel_tpu_torch.analysis.jaxpr.framework import run_jaxpr_passes, trace_entry
from sentinel_tpu_torch.analysis.jaxpr.passes import (
    ConstHoistPass,
    CostBudgetPass,
    DtypeOverflowPass,
    FingerprintPass,
    TransferGuardPass,
)
from tests import torch_entries as TE

DEVICE = "cpu"

#: a module-level tensor — read inside an entry, it is an input the call
#: does not take (the port's counterpart of the reference's hoisted jnp const)
_BAD_MODULE_TENSOR = torch.tensor([-3.0e38], dtype=torch.float32)
#: a Python float: a scalar argument of the op, nothing read from outside
_GOOD_SCALAR = -3.0e38


def _entry(fn, make_args, name="fixture", time_arg=None, tick=False, **kw):
    e = trace_entry(name, "sentinel_tpu_torch/ops/engine.py", fn, make_args, DEVICE, time_arg=time_arg, tick=tick)
    for k, v in kw.items():
        setattr(e, k, v)
    return e


def _clock(fn, *extra):
    """An entry whose argument 0 is the clock (a host int, as the tick's)."""
    return _entry(fn, lambda: (1_000, *extra), time_arg=0)


def _i32(t):
    return torch.full((4,), t, dtype=torch.int32)


# ---------------------------------------------------------------------------
# const-hoist
# ---------------------------------------------------------------------------


def test_const_hoist_catches_a_module_tensor():
    e = _entry(lambda x: torch.maximum(x, _BAD_MODULE_TENSOR), lambda: (torch.zeros(4),))
    got = list(ConstHoistPass().run(e))
    assert len(got) == 1 and got[0].rule == "const-hoist"
    assert "neither an argument" in got[0].message


def test_const_hoist_scalar_and_tensors_made_in_the_call_are_clean():
    e = _entry(lambda x: torch.clamp_min(x, _GOOD_SCALAR) + torch.ones(4), lambda: (torch.zeros(4),))
    assert list(ConstHoistPass().run(e)) == []


def test_const_hoist_invisible_to_ast_tier():
    """Both spellings are module-level assignments feeding torch.maximum;
    only the recorded stream tells the read tensor from the scalar."""
    source = textwrap.dedent(
        """
        import torch

        _NEG = torch.tensor([-3.0e38])

        def fill(x):
            return torch.maximum(x, _NEG)
        """
    )
    line_disables, file_disables = parse_suppressions(source)
    mod = ParsedModule(
        path="sentinel_tpu_torch/ops/rank.py", abspath="/sentinel_tpu_torch/ops/rank.py", source=source,
        tree=ast.parse(source), line_disables=line_disables, file_disables=file_disables,
    )
    assert [f for p in ALL_PASSES for f in p.run(mod)] == []


def test_const_hoist_warns_on_large_host_constant():
    big = np.ones((1 << 16,), np.float32)  # 256 KiB, made into a tensor every call
    e = _entry(lambda x: x + torch.tensor(big), lambda: (torch.zeros(1 << 16),))
    got = list(ConstHoistPass().run(e))
    assert len(got) == 1 and got[0].severity == "warning" and "262144 bytes" in got[0].message
    small = np.ones((16,), np.float32)
    assert list(ConstHoistPass().run(_entry(lambda x: x + torch.tensor(small), lambda: (torch.zeros(16),)))) == []


# ---------------------------------------------------------------------------
# transfer-guard
# ---------------------------------------------------------------------------


def test_transfer_guard_catches_a_readback_and_a_host_constant_upload():
    def leaky(x):
        n = int(x.sum().item())  # the host waits for the card
        return x + torch.tensor(np.arange(4, dtype=np.float32)) + n

    e = _entry(leaky, lambda: (torch.zeros(4),), tick=True)
    msgs = [f.message for f in TransferGuardPass().run(e)]
    assert len(msgs) == 2
    assert any("aten::_local_scalar_dense" in m for m in msgs)
    assert any("does not come in through the tick's arguments" in m for m in msgs)


@pytest.mark.parametrize(
    "read",
    [
        lambda t: t.cpu(),
        lambda t: t.numpy(),
        lambda t: t.tolist(),
        lambda t: np.asarray(t),
    ],
    ids=["cpu", "numpy", "tolist", "asarray"],
)
def test_transfer_guard_catches_a_host_read_on_the_cpu(read):
    """A host read dispatches no ATen op on the CPU (only .item() does);
    the host-read recorder sees it all the same."""

    def leaky(x):
        read(x * 2)  # the tick hands a tensor to the host
        return x + 1

    e = _entry(leaky, lambda: (torch.zeros(4, dtype=torch.int32),), tick=True)
    assert not any(op.base == "aten::_local_scalar_dense" for op in e.ops)
    got = list(TransferGuardPass().run(e))
    assert len(got) == 1 and "int32[4] inside the tick" in got[0].message


def test_transfer_guard_clean_tensor_program():
    def clean(x, now):
        # host data that moves with the clock argument is the argument's
        return torch.cumsum(x, 0) * 2 + torch.tensor([now, now + 1], dtype=torch.float32)

    e = _entry(clean, lambda: (torch.zeros(2), 1_000), time_arg=1, tick=True)
    assert list(TransferGuardPass().run(e)) == []
    # outside a tick entry the readback is not this pass's business
    e2 = _entry(lambda x: x.sum().item(), lambda: (torch.zeros(4),))
    assert list(TransferGuardPass().run(e2)) == []


def test_transfer_guard_flags_readbacks_outside_fused_wire():
    e = _entry(lambda x: x + 1, lambda: (torch.zeros(4),), packed_wire=True,
               readback_fields=("wait_ms", "seg_dropped", "stats", "wire"))
    got = list(TransferGuardPass().run(e))
    assert len(got) == 1 and "'stats'" in got[0].message
    e = _entry(lambda x: x + 1, lambda: (torch.zeros(4),), packed_wire=True, readback_fields=("verdict", "wait_ms"))
    msgs = [f.message for f in TransferGuardPass().run(e)]
    assert any("no 'wire' buffer" in m for m in msgs)
    assert any("'verdict'" in m for m in msgs)


def test_transfer_guard_packed_allowance_is_clean():
    e = _entry(lambda x: x + 1, lambda: (torch.zeros(4),), packed_wire=True,
               readback_fields=("wait_ms", "seg_dropped", "wire"))
    assert list(TransferGuardPass().run(e)) == []


def test_packed_wire_entry_readback_surface_is_fused():
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    ents = {e.name: e for e in trace_entries(DEVICE)}
    e = ents["tick/packed-wire"]
    assert e.packed_wire and e.readback_fields is not None
    assert "wire" in e.readback_fields
    assert set(e.readback_fields) <= {"wire", "wait_ms", "seg_dropped"}
    assert ents["tick/plain"].packed_wire is False


# ---------------------------------------------------------------------------
# dtype-overflow
# ---------------------------------------------------------------------------


def test_dtype_overflow_flags_ms_scale_up():
    got = list(DtypeOverflowPass().run(_clock(lambda t: _i32(t) * 1000)))
    assert len(got) == 1 and "1000x" in got[0].message


def test_dtype_overflow_flags_narrowing_and_traced_mul():
    e1 = _clock(lambda t: torch.full((4,), t, dtype=torch.int64).to(torch.int16))
    assert any("narrowed" in f.message for f in DtypeOverflowPass().run(e1))
    e2 = _clock(lambda t, v: _i32(t) * v, torch.full((4,), 7, dtype=torch.int32))
    got = list(DtypeOverflowPass().run(e2))
    assert len(got) == 1 and "not a known literal" in got[0].message


def test_dtype_overflow_flags_pow_and_int_dot():
    got = list(DtypeOverflowPass().run(_clock(lambda t: _i32(t) ** 2)))
    assert len(got) == 1 and "power" in got[0].message
    got2 = list(DtypeOverflowPass().run(_clock(lambda t: torch.sum(_i32(t)))))
    assert len(got2) == 1 and "accumulates" in got2[0].message


def test_dtype_overflow_flags_a_clock_the_host_scaled():
    """The port's tick does its time arithmetic on the host: a scale-up
    there shows as a clock-derived scalar past the limit at the op that
    takes it (the shadow run measures the net scale)."""
    got = list(DtypeOverflowPass().run(_clock(lambda t: torch.full((4,), t * 1000, dtype=torch.int64))))
    assert len(got) == 1 and "host scaled the timestamp" in got[0].message and "1000x" in got[0].message


def test_dtype_overflow_window_math_is_legal():
    """What the engine does with now_ms: bucket id, phase, round-trip to
    the epoch start, deadline offsets, comparisons — on the device and on
    the host (``W.i32``) — plus ``W.f32_to_i32`` and ``engine.fold_i32``'s
    deliberate wrap: none is flagged."""
    from sentinel_tpu_torch.ops import engine as E
    from sentinel_tpu_torch.ops import window as W

    def window_math(t):
        tt = _i32(W.i32(t))
        wid = tt // 500
        idx = tt % 500
        start = wid * 500
        deadline = tt + 3_000
        fresh = (tt - start) < 250
        wrapped = E.fold_i32(tt.to(torch.int64) + (1 << 31))
        sat = W.f32_to_i32(tt.to(torch.float32) * 4.0e6)
        return wid, idx, start, deadline, fresh, wrapped, sat, _i32(t // 500 % 2)

    e = _clock(window_math)
    assert e.shadow_error is None
    # through the runner, which honors fold_i32's in-place rationale
    assert run_jaxpr_passes([e], [DtypeOverflowPass()], REPO_ROOT) == []
    raw = list(DtypeOverflowPass().run(e))
    assert [(f.path, "narrowed" in f.message) for f in raw] == [("sentinel_tpu_torch/ops/engine.py", True)]


def test_dtype_overflow_untainted_counters_are_ignored():
    e = _entry(lambda c: torch.cumsum(c, 0), lambda: (torch.ones(64, dtype=torch.int32),))
    assert list(DtypeOverflowPass().run(e)) == []


def test_dtype_overflow_reports_a_shadow_run_that_diverges():
    e = _clock(lambda t: _i32(t) * 1 if t > 5_000 else _i32(t))
    got = list(DtypeOverflowPass().run(e))
    assert len(got) == 1 and "did not line up" in got[0].message


# ---------------------------------------------------------------------------
# recompile-fingerprint
# ---------------------------------------------------------------------------


def test_fingerprint_roundtrip_and_drift(tmp_path):
    golden_path = str(tmp_path / "fingerprints.json")
    e = _entry(lambda x: x * 2 + 1, lambda: (torch.zeros(4),), name="fp/probe")
    got = list(FingerprintPass(golden_path=golden_path).run(e))
    assert len(got) == 1 and "no golden fingerprint" in got[0].message

    save_golden(golden_path, {"device": "cpu", "torch_version": torch.__version__,
                              "entries": {"fp/probe": entry_signature(e)}})
    assert list(FingerprintPass(golden_path=golden_path).run(e)) == []

    e2 = _entry(lambda x: x * 2.0 + torch.sum(x), lambda: (torch.zeros(4),), name="fp/probe")
    got = list(FingerprintPass(golden_path=golden_path).run(e2))
    assert len(got) == 1 and "dispatched program changed" in got[0].message and "NOTE" not in got[0].message
    # a golden made under another torch names both versions
    save_golden(golden_path, {"device": "cpu", "torch_version": "0.0.1",
                              "entries": {"fp/probe": entry_signature(e)}})
    got = list(FingerprintPass(golden_path=golden_path).run(e2))
    assert "torch 0.0.1" in got[0].message and f"torch {torch.__version__}" in got[0].message


def test_fingerprint_reads_the_card_block_on_the_card(tmp_path):
    """A run on another device than the CPU is compared against the
    goldens' "card" block, never skipped."""
    golden_path = str(tmp_path / "fingerprints.json")
    e = _entry(lambda x: x * 2 + 1, lambda: (torch.zeros(4),), name="fp/probe", device="cuda")
    cpu_block = {"device": "cpu", "torch_version": torch.__version__, "entries": {"fp/probe": entry_signature(e)}}
    save_golden(golden_path, cpu_block)
    got = list(FingerprintPass(golden_path=golden_path).run(e))
    assert len(got) == 1 and "no golden fingerprint" in got[0].message and "on the card" in got[0].message
    other = _entry(lambda x: x - 1, lambda: (torch.zeros(4),), name="fp/probe")
    card = {"device": "cuda", "torch_version": "0.0.2", "entries": {"fp/probe": entry_signature(other)}}
    save_golden(golden_path, dict(cpu_block, card=card))
    got = list(FingerprintPass(golden_path=golden_path).run(e))
    assert len(got) == 1 and "changed on cuda" in got[0].message and "torch 0.0.2" in got[0].message
    card["entries"]["fp/probe"] = entry_signature(e)
    save_golden(golden_path, dict(cpu_block, card=card))
    assert list(FingerprintPass(golden_path=golden_path).run(e)) == []


def test_fingerprint_is_dtype_sensitive():
    """A dtype drift on an entry input (int32 -> int64 state, say) changes
    every op it reaches: the signature encodes dtypes and ranks."""
    a = _entry(lambda x, s: x * s, lambda: (torch.zeros(4, dtype=torch.int32), 2))
    b = _entry(lambda x, s: x * s, lambda: (torch.zeros(4, dtype=torch.int64), 2))
    c = _entry(lambda x, s: x * s, lambda: (torch.zeros(8, dtype=torch.int32), 3))
    assert entry_signature(a)["hash"] != entry_signature(b)["hash"]
    assert entry_signature(a)["hash"] == entry_signature(c)["hash"]  # sizes and values are not the program


# ---------------------------------------------------------------------------
# flops-bytes-budget
# ---------------------------------------------------------------------------


def test_budget_breach_missing_and_pass(tmp_path):
    path = str(tmp_path / "budgets.json")
    e = _entry(lambda x: x * 2 + 1, lambda: (torch.zeros(4),), name="bud/probe")
    assert e.cost == {"launches": 2, "bytes": 64}
    got = list(CostBudgetPass(budget_path=path).run(e))
    assert len(got) == 1 and "no cost budget" in got[0].message
    save_golden(path, {"entries": {"bud/probe": {"launches": 3, "bytes": 80}}})
    assert list(CostBudgetPass(budget_path=path).run(e)) == []
    hot = _entry(lambda x: x * 2 + 1 - x.view(2, 2).t().reshape(4), lambda: (torch.zeros(4),), name="bud/probe")
    got = list(CostBudgetPass(budget_path=path).run(hot))
    assert len(got) == 2 and all("exceed the checked-in ceiling" in f.message for f in got)


def test_budget_on_the_card_holds_both_blocks(tmp_path):
    path = str(tmp_path / "budgets.json")
    e = _entry(lambda x: x * 2 + 1, lambda: (torch.zeros(4),), name="bud/probe", device="cuda")
    save_golden(path, {"entries": {"bud/probe": {"launches": 3, "bytes": 80}}})
    got = list(CostBudgetPass(budget_path=path).run(e))
    assert len(got) == 1 and "no cost budget recorded on the card" in got[0].message
    save_golden(path, {"entries": {"bud/probe": {"launches": 3, "bytes": 80}},
                       "card": {"entries": {"bud/probe": {"launches": 1, "bytes": 80}}}})
    got = list(CostBudgetPass(budget_path=path).run(e))
    assert len(got) == 1 and "launches 2 on cuda" in got[0].message and "recorded on the card" in got[0].message
    save_golden(path, {"entries": {"bud/probe": {"launches": 1, "bytes": 80}},
                       "card": {"entries": {"bud/probe": {"launches": 3, "bytes": 80}}}})
    got = list(CostBudgetPass(budget_path=path).run(e))
    assert len(got) == 1 and "recorded on the CPU" in got[0].message


@pytest.mark.parametrize("update", ["update_fingerprints", "update_budgets"])
def test_golden_update_on_the_cpu_keeps_the_card_block(tmp_path, update):
    from sentinel_tpu_torch.analysis import jaxpr as J

    path = str(tmp_path / "golden.json")
    card = {"device": "cuda", "torch_version": "0.0.2", "entries": {"tick/plain": {"launches": 1}}}
    save_golden(path, {"device": "cpu", "entries": {}, "card": card})
    assert getattr(J, update)(path=path) == 13
    data = load_golden(path)
    assert data["card"] == card
    assert data["device"] == "cpu" and data["torch_version"] == torch.__version__
    assert set(data["entries"]) == set(load_golden(J.FINGERPRINTS_PATH)["entries"])


# ---------------------------------------------------------------------------
# THE CI GATE: the real entries against the committed goldens
# ---------------------------------------------------------------------------


def test_jaxpr_tier_clean_on_real_entry_points():
    """The 13 entries recorded on the CPU, all five passes: no finding."""
    findings = run_jaxpr_analysis(device=DEVICE)
    assert findings == [], "jaxpr-tier findings:\n" + "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in findings
    )


def test_goldens_cover_every_entry_point():
    from sentinel_tpu.analysis.jaxpr.entrypoints import _ENTRY_MODULES as REF_ENTRIES
    from sentinel_tpu_torch.analysis.jaxpr import BUDGETS_PATH, FINGERPRINTS_PATH
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    live = [e.name for e in trace_entries(DEVICE)]
    assert set(live) == set(REF_ENTRIES) and len(live) == 13  # the reference's names
    fp, bud = load_golden(FINGERPRINTS_PATH), load_golden(BUDGETS_PATH)
    assert set(fp["entries"]) == set(live) == set(bud["entries"])
    assert fp["device"] == bud["device"] == "cpu" and fp["torch_version"]
    # the card's blocks, which a run on the card checks, cover them too
    assert set(fp["card"]["entries"]) == set(live) == set(bud["card"]["entries"])
    assert fp["card"]["device"] == bud["card"]["device"] == "cuda" and fp["card"]["torch_version"]


def test_the_plain_config_calls_no_kernel_wrapper():
    """The plain and MXU ticks reach no kernel wrapper (its config gating
    would be broken): none of their ops comes from the wrappers' modules,
    where the plain versions run on the CPU, while fused-seg's do — B1 and
    B2's in ops/fused.py, seg_build's (B4's route) in ops/segscan.py — and
    no launch counter moved on the CPU."""
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import KERNEL_ENTRIES, trace_entries

    kernel_modules = ("sentinel_tpu_torch/ops/fused.py", "sentinel_tpu_torch/ops/segscan.py")
    by_name = {e.name: e for e in trace_entries(DEVICE)}

    def modules(name):
        return {op.source[0] for op in by_name[name].ops if op.source and op.source[0] in kernel_modules}

    for name in by_name:
        if name not in KERNEL_ENTRIES:
            assert modules(name) == set(), name
    assert modules("tick/fused-seg") == set(kernel_modules)
    assert set(KERNEL_ENTRIES["tick/fused-seg"]) == {"scatter_many", "gather_many", "seg_build"}
    assert all(v == 0 for e in by_name.values() for v in e.kernel_launches.values())


def test_tick_inputs_equal_the_references():
    from sentinel_tpu.analysis.jaxpr.entrypoints import _mk_tick_inputs as ref_inputs
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import _mk_tick_inputs, tick_configs

    for name, (cfg, _features) in tick_configs().items():
        TE.assert_inputs_match(name, ref_inputs(TE.reference_ticks()[name][0]), _mk_tick_inputs(cfg, DEVICE))


@pytest.mark.parametrize("name", ["tick/plain", "tick/cluster-token"])
def test_tick_outputs_equal_the_references(name):
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    entry = {e.name: e for e in trace_entries(DEVICE)}[name]
    _args, out = TE.reference_tick(name)
    TE.assert_outputs_match(name, entry, out)


def test_every_clock_entry_lines_up_with_its_shadow_run():
    """The clock taint is seeded on every entry with a time argument: the
    shadow run dispatched the same ops, and some scalar moved with it."""
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    timed = [e for e in trace_entries(DEVICE) if e.time_arg is not None]
    assert {e.name for e in timed} == {
        "tick/plain", "tick/mxu", "tick/sketch-salsa", "tick/fused-seg", "tick/packed-wire",
        "tick/cluster-token", "window/add-batch", "cluster/token-col",
    }
    for e in timed:
        assert e.shadow_error is None, (e.name, e.shadow_error)
        assert any(op.time_scale for op in e.ops), e.name


def test_cli_jaxpr_tier_on_the_cpu_is_clean():
    from sentinel_tpu_torch.analysis.__main__ import main

    assert main(["--tier", "jaxpr", "--device", DEVICE]) == 0
    assert main(["--tier", "jaxpr", "--device", DEVICE, "--rules", "const-hoist,transfer-guard"]) == 0


def test_findings_land_on_the_ports_source_lines(tmp_path):
    """An op's finding anchors on the port's line that dispatched it (so a
    ``# stlint:`` there applies): the salsa shift table's read carries its
    const-hoist rationale, and without suppressions it would be found."""
    from sentinel_tpu_torch.analysis.jaxpr.entrypoints import trace_entries

    salsa = [e for e in trace_entries(DEVICE) if e.name == "tick/sketch-salsa"]
    raw = list(ConstHoistPass().run(salsa[0]))
    assert raw and {f.path for f in raw} == {"sentinel_tpu_torch/sketch/salsa.py"}
    assert run_jaxpr_passes(salsa, [ConstHoistPass()], REPO_ROOT) == []
    src = open(f"{REPO_ROOT}/sentinel_tpu_torch/sketch/salsa.py").read().splitlines()
    assert all("stlint: disable=const-hoist" in src[f.line - 1] for f in raw)
