"""The port's program pass (``repro_torch.analysis.progcheck``): every serving
program of the audit grid ({contiguous, paged} x {fp, int8, int4}) run once
on the CPU at the signature serving dispatches.

* one memoized audit for the module: no finding, every grid point's cost
  rows inside their bands, ``python -m repro_torch.analysis --all`` exits 0;
* ``ModelRunner.program_signatures()`` registers the JAX runner's keys, and
  each program's dispatched shapes are the JAX signature's;
* injected faults, each caught: f64, a whole-cache dequant, a dropped pin, a
  copied cache, cost drift, a bucket leak, a grid-closure leak, a
  non-covering bucket, missing or malformed ``CACHE_OPERANDS``, a cache
  passthrough.
"""
from __future__ import annotations

import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import types
from pathlib import Path

import jax
import pytest
import torch

from repro.analysis import progcheck as jax_progcheck

from repro_torch.analysis import default_root, progcheck
from repro_torch.core.phase_engine import TensorSpec
from repro_torch.quant.kv_quant import dequantize_kv


@pytest.fixture(scope="module")
def audit():
    return progcheck.audit()


def _collect():
    got = []
    return got, lambda rule, msg: got.append(rule)


# ------------------------------------------------------------- the real grid --

def test_the_audit_grid_is_clean(audit):
    findings, rows = audit
    assert [f.render() for f in findings] == []
    points = {(r["layout"], r["kv_dtype"]) for r in rows}
    assert points == {(l_, k) for l_ in progcheck.LAYOUTS for k in progcheck.KV_DTYPES}
    kv = [r for r in rows if r["kind"] == "kv_stream_bytes"]
    assert len(kv) == 12  # decode and verify at each point
    assert all(abs(r["ratio"] - 1.0) < 1e-9 for r in kv)
    flops = [r for r in rows if r["kind"] == "flops_per_token"]
    assert len(flops) == 60  # 5 split prefills and 5 chunk shapes at each point
    assert all(0.9 < r["ratio"] < 1.1 for r in flops)


def test_cli_all_exits_zero(audit, capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--all"]) == 0
    out = capsys.readouterr().out
    assert "[program] 0 finding(s)" in out and "OK: no non-baselined findings" in out


def test_report_lists_the_cost_table(audit, capsys):
    from repro_torch.analysis import report

    data = report.report_data(default_root(), Path(report.default_baseline()))
    assert data["total_active"] == 0 and len(data["cost_table"]) == 72


def test_program_pass_foreign_root_reports_clean(tmp_path):
    (tmp_path / "mod.py").write_text("x = 1\n")
    assert progcheck.run(tmp_path) == []


# ------------------------------------------------- signatures against JAX --

def _shapes(tree):
    """The shapes of a signature's leaves in order: tensors and specs, and a
    Python int as a 0-d scalar (the JAX signature's traced scalar)."""
    if isinstance(tree, (torch.Tensor, TensorSpec)):
        return [tuple(tree.shape)]
    if isinstance(tree, int):
        return [()]
    if isinstance(tree, dict):
        return [s_ for v in tree.values() for s_ in _shapes(v)]
    if isinstance(tree, (tuple, list)):
        return [s_ for v in tree for s_ in _shapes(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [s_ for f in tree.__dataclass_fields__ for s_ in _shapes(getattr(tree, f))]
    return []


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", "int8"), ("paged", "int4"),
                                             ("paged", "fp")])
def test_program_signatures_match_the_jax_runner(layout, kv_dtype):
    port = progcheck.grid_runner(layout, kv_dtype)
    port.build_serving_grid()
    ref = jax_progcheck._grid_runner(layout, kv_dtype)
    ref.build_serving_grid()
    mine, theirs = port.program_signatures(), ref.program_signatures()
    assert sorted(mine) == sorted(theirs)
    for key, sig in mine.items():
        assert sig.args is not None, key
        assert set(sig.own) >= set(sig.program.pinned)
        want = theirs[key].abstract_inputs
        with_params = want[0] is ref._pa
        want = [tuple(x.shape) for x in jax.tree.leaves(want[1:] if with_params else want)]
        assert with_params == (sig.args[0] is port.params), key
        got = _shapes(sig.args[1:] if with_params else sig.args)
        if key.startswith("relayout:"):  # the port installs in place: (kv, cache, slot)
            got = got[:len(want)]
        assert got == want, key
        # the runner's own tensors stay its own; the rest are fresh zeros
        inputs = sig.inputs("cpu")
        for i in sig.own:
            assert inputs[i] is sig.args[i]


# ------------------------------------------------------- injected faults --

def test_progcheck_catches_f64():
    x = torch.zeros(8)
    rec = progcheck.OpRecorder(x)
    with rec:
        (x.double() * 2.0).sum()
    got, emit = _collect()
    progcheck.check_dtype_flow(rec, x, quantized=False, fp_threshold_elems=10**9, emit=emit)
    assert got == ["prog:f64"]
    got, emit = _collect()
    progcheck.check_dtype_flow(progcheck.OpRecorder(), x.double(), quantized=False,
                               fp_threshold_elems=10**9, emit=emit)
    assert got == ["prog:f64"]


def test_progcheck_catches_a_whole_cache_dequant():
    k_q = torch.zeros((4, 2, 128, 16), dtype=torch.int8)
    scale = torch.ones((4, 2, 128))
    rec = progcheck.OpRecorder((k_q, scale))
    with rec:
        dequantize_kv(k_q, scale, "int8").sum()
    elems = k_q.numel()
    got, emit = _collect()
    progcheck.check_dtype_flow(rec, (k_q, scale), quantized=True, fp_threshold_elems=elems,
                               emit=emit)
    assert got == ["prog:fp-cache-alloc"]
    for quantized, threshold in ((False, elems), (True, 2 * elems)):
        got, emit = _collect()
        progcheck.check_dtype_flow(rec, (k_q, scale), quantized=quantized,
                                   fp_threshold_elems=threshold, emit=emit)
        assert got == []


def _step_in_place(t, c):
    c[0, 0] = t.float()
    return c[0, 0].clone(), c


def _step_copy(t, c):
    c = c.clone()
    c[0, 0] = t.float()
    return c[0, 0].clone(), c


def test_progcheck_catches_a_dropped_pin_and_a_copied_cache():
    tok, cache = torch.tensor(3), torch.zeros((256, 256))
    threshold = cache.numel() * 4
    for fn, pinned, want in ((_step_in_place, (), ["prog:cache-not-pinned"]),
                             (_step_in_place, (1,), []),
                             (_step_copy, (1,), ["prog:cache-not-pinned"]),
                             (_step_copy, (), ["prog:cache-not-pinned"])):
        args = (tok, cache.clone())
        got, emit = _collect()
        progcheck.check_pinning(args, fn(*args), pinned, threshold, emit)
        assert got == want, (fn.__name__, pinned)
    got, emit = _collect()  # small threaded values never trigger
    args = (tok, cache.clone())
    progcheck.check_pinning(args, _step_in_place(*args), (), 10**9, emit)
    assert got == []


def test_progcheck_catches_cost_drift():
    def row(ratio):
        return dict(layout="contiguous", kv_dtype="int8", program="decode:x",
                    kind="kv_stream_bytes", counted=ratio * 100.0, bound=100.0, ratio=ratio,
                    tol_lo=0.87, tol_hi=1.15)

    got, emit = _collect()
    progcheck.cost_findings([row(1.0), row(1.14)], lambda r: emit)
    assert got == []
    got, emit = _collect()
    progcheck.cost_findings([row(2.0), row(0.4)], lambda r: emit)
    assert got == ["prog:cost-drift", "prog:cost-drift"]


class _Engine:
    def __init__(self):
        self.programs = {}


class _BucketStub:
    """The ModelRunner bucket surface: quantum-aligned, covering, and
    closed over the built grid."""
    paged = None
    prompt_len = 8
    block_size = 8
    max_len = 32
    prefill_chunk = None

    def __init__(self):
        self.engine = _Engine()

    def bucket(self, n):
        return min(-(-n // 8) * 8, self.max_len)

    def reachable_buckets(self):
        return sorted({self.bucket(n) for n in range(1, self.max_len + 1)})

    def progs(self, b):
        self.engine.programs.setdefault(f"prefill:{b}", object())
        return {}

    def program_signatures(self):
        return {k: types.SimpleNamespace(args=()) for k in self.engine.programs}


def test_progcheck_bucket_coverage_clean_stub():
    runner = _BucketStub()
    for b in runner.reachable_buckets():
        runner.progs(b)
    got, emit = _collect()
    progcheck.check_bucket_coverage(runner, emit)
    assert got == []


@pytest.mark.parametrize("fault", ["leaky", "closure", "truncating", "no-signature"])
def test_progcheck_catches_shape_leaks(fault):
    class Leaky(_BucketStub):
        def bucket(self, n):
            return n  # a shape a prompt length

    class Truncating(_BucketStub):
        def bucket(self, n):
            return 8  # every prompt padded down to 8

    class NoSignature(_BucketStub):
        def program_signatures(self):
            return {k: types.SimpleNamespace(args=None) for k in self.engine.programs}

    runner = {"leaky": Leaky, "closure": _BucketStub, "truncating": Truncating,
              "no-signature": NoSignature}[fault]()
    if fault == "no-signature":
        for b in runner.reachable_buckets():
            runner.progs(b)
    # "closure": the grid is NOT built, so dispatch registers programs
    got, emit = _collect()
    progcheck.check_bucket_coverage(runner, emit)
    assert "prog:shape-leak" in got


def _ops_module(tmp_path, name, ns):
    mod = types.ModuleType(name)
    src = tmp_path / f"{name}.py"
    src.write_text("# fixture ops module\n")
    mod.__file__ = str(src)
    for k, v in ns.items():
        setattr(mod, k, v)
    return mod


def test_progcheck_flags_missing_and_malformed_op_annotations(tmp_path):
    got, emit = _collect()
    progcheck.check_op_contracts(lambda path, line, scope="": emit,
                                 modules=[_ops_module(tmp_path, "bare_ops", {})])
    assert got == ["prog:op-annotation"]

    def my_op(q, k, v):
        return q

    bad = _ops_module(tmp_path, "bad_ops", {
        "my_op": my_op, "my_op2": my_op,
        "CACHE_OPERANDS": {
            "my_op": {"args": ("k", "nope"), "writes": False},  # unknown arg
            "ghost": {"args": ("k",), "writes": False},  # missing callable
            "my_op2": {"args": ("k",), "writes": True},
        }})
    got, emit = _collect()
    progcheck.check_op_contracts(lambda path, line, scope="": emit, modules=[bad])
    assert sorted(got) == ["prog:op-annotation"] * 3


def test_progcheck_catches_a_cache_passthrough(tmp_path):
    def passthrough(q, k):
        return q + 1.0, k  # hands the cache back out

    def computes(q, k):
        return (q[:, None, :] * k).sum(1)

    probe = ((torch.zeros((4, 8)), torch.zeros((4, 8))), {})
    mod = _ops_module(tmp_path, "alias_ops", {
        "passthrough": passthrough, "computes": computes,
        "CACHE_OPERANDS": {"passthrough": {"args": ("k",), "writes": False},
                           "computes": {"args": ("k",), "writes": False}},
        "_ANALYSIS_PROBES": {"passthrough": probe, "computes": probe}})
    got, emit = _collect()
    progcheck.check_op_contracts(lambda path, line, scope="": emit, modules=[mod])
    assert got == ["prog:op-alias"]


def test_the_ports_ops_modules_declare_their_cache_operands():
    import importlib

    for name in progcheck.OPS_MODULES:
        decl = importlib.import_module(name).CACHE_OPERANDS
        assert decl and all(spec["writes"] is False for spec in decl.values())
    got, emit = _collect()
    progcheck.check_op_contracts(lambda path, line, scope="": emit)
    assert got == []


@pytest.mark.parametrize("paged", [False, True])
def test_plain_verify_walk_dequantizes_each_slot_once(paged):
    """The program pass found the CPU verify programs dequantizing a slot's
    cache once a block row (W copies: a whole-cache f32 allocation at the
    audit grid); the plain walk now takes row i of every slot at a time
    over the cache as it is, to the same bits."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.quant.kv_quant import quantize_kv

    gen = torch.Generator().manual_seed(0)
    slots, w, hkv, s, d, g = 2, 5, 2, 48, 32, 2
    q = torch.randn((slots * w, hkv * g, d), generator=gen)
    lengths = torch.tensor([3 + i for i in range(w)] + [40 + i for i in range(w)],
                           dtype=torch.int32)
    if paged:
        pages = torch.randn((12, hkv, 8, d), generator=gen), torch.randn((12, hkv, 8, d),
                                                                       generator=gen)
        (kq, ks), (vq, vs) = (quantize_kv(p, "int8") for p in pages)
        tables = torch.randperm(12, generator=gen)[:12].reshape(slots, 6).to(torch.int32)
        rows = tables.repeat_interleave(w, 0)
        run = lambda: paged_decode_attention(q, kq, vq, rows, lengths, k_scales=ks,  # noqa: E731
                                             v_scales=vs, kv_dtype="int8", rows_per_slot=w)
        one_view = slots * hkv * 6 * 8 * d
        want = torch.cat([paged_decode_attention(q[b:b + 1], kq, vq, rows[b:b + 1],
                                                 lengths[b:b + 1], k_scales=ks, v_scales=vs,
                                                 kv_dtype="int8") for b in range(slots * w)])
    else:
        cache = torch.randn((slots, hkv, s, d), generator=gen), torch.randn((slots, hkv, s, d),
                                                                           generator=gen)
        (kq, ks), (vq, vs) = (quantize_kv(c, "int8") for c in cache)
        run = lambda: decode_attention(q, kq, vq, lengths, k_scales=ks, v_scales=vs,  # noqa: E731
                                       kv_dtype="int8", rows_per_slot=w)
        one_view = slots * hkv * s * d
        rep = [t.repeat_interleave(w, 0) for t in (kq, vq, ks, vs)]
        want = decode_attention(q, rep[0], rep[1], lengths, k_scales=rep[2], v_scales=rep[3],
                                kv_dtype="int8")
    rec = progcheck.OpRecorder((q, kq, vq, ks, vs))
    with rec:
        got = run()
    assert torch.equal(got, want)
    assert rec.f32_at_least(one_view + 1) == []
    assert rec.f32_at_least(one_view // slots)  # the per-slot views it does make
