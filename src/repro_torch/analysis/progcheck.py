"""Program-level auditor: run every serving phase program once and check the
contracts the file-level lints cannot see.

The port of the JAX package's ``repro.analysis.progcheck``.  Where JAX
traces a jaxpr, the port runs each registered program once on the CPU at
the exact signature serving dispatches (``ModelRunner.program_signatures``:
the runner's own params, cache, pages and prefix mirror at the pinned
arguments, zeros of the dispatched shapes elsewhere), under a dispatch
recorder (every operation's outputs) and ``FlopCounterMode``.  It builds the
serving grid ({contiguous, paged} x {fp, int8, int4}) on a tiny reduced
model and checks four invariant families:

* **dtype flow** — ``prog:f64`` (no float64 anywhere: a Python-float or
  numpy promotion doubles every buffer); ``prog:fp-cache-alloc`` (in a
  quantized-KV program no f32 allocation the size of one dequantized cache
  direction: per-layer dequantized views are fine, a whole-cache
  materialization defeats the quantization);
* **pinning** — ``prog:cache-not-pinned`` (the port's counterpart of
  ``prog:cache-not-donated``: a cache-sized tensor that a program takes and
  returns must sit at one of the program's ``pinned`` arguments and come
  back as the same storage, updated in place — else the step doubles the
  cache, or a captured graph writes a copy the next round never reads);
* **static cost vs roofline** — ``prog:cost-drift`` (the KV bytes a decode
  or verify program streams, and the prefill FLOPs a token that
  ``FlopCounterMode`` counts, within tolerance of
  ``core.roofline.predict_phase`` — the predictions ``obs.drift`` reports
  at runtime);
* **bucket / capture coverage** — ``prog:shape-leak`` (the shape sets
  ``bucket()`` / ``chunk_bucket()`` promise are finite, aligned and CLOSED:
  re-requesting programs for every reachable prompt length after
  ``build_serving_grid()`` must register nothing new — on the card each
  new program is a capture inside a served request).

It also checks the kernel ops' aliasing contract: each ``kernels/*/ops.py``
declares ``CACHE_OPERANDS`` (which operands alias the persistent KV cache,
page pool or packed weights, and that the op never writes them).
``prog:op-annotation`` flags a malformed or missing declaration;
``prog:op-alias`` flags a declared read-only entry that hands a cache
operand back among its outputs.

Waivers: the ``# analysis: allow(prog:<rule>) — reason`` pragma on the
program builder's ``def`` line (findings anchor to the function the program
runs, or to the op entry point), and the shared baseline.  The pass audits
the IMPORTED package: run against another ``--root`` it has nothing to run
and reports clean.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.common import AnalyzedFile, Finding

PASS = "program"

LAYOUTS = ("contiguous", "paged")
KV_DTYPES = ("fp", "int8", "int4")

# --- audit grid model: the JAX package's, tiny but structurally faithful
# (real bucketing, speculation on, chunked prefill on).  Dims chosen so the
# fp-cache-alloc threshold (one full dequantized cache direction:
# n_slots*L*Hkv*max_len*D = 18432 elements) dominates every legitimate f32
# buffer: the chunk prefix mirror (L*Hkv*max_len*D = 9216), the per-layer
# dequantized views (<= n_slots*Hkv*max_len*D = 6144), the logits.
GRID_ARCH = "smollm-135m"
GRID_MODEL = dict(num_layers=3, d_model=64, vocab_size=128,
                  num_heads=2, num_kv_heads=2, head_dim=32)
GRID_RUNNER = dict(n_slots=2, max_len=48, prompt_len=8, block_size=8,
                   prefill_chunk=8, spec_decode=2)

# --- tolerances (the JAX package's) -------------------------------------
# Decode/verify stream the KV cache once per step: its bytes must match
# kv_bytes_per_ctx_token() * capacity almost exactly.
KV_BYTES_TOL = 1.15
# Prefill: counted matmul FLOPs per token vs the 2N bound.  Embedding
# gathers add params but no FLOPs (ratio < 1), attention scores add FLOPs
# but no params (ratio > 1); the band catches a duplicated layer (2x) or a
# program that stopped doing the matmuls the bound charges for.
PREFILL_FLOPS_BAND = (0.7, 1.35)

_MEMO: Dict[Tuple, Tuple[List[Finding], List[Dict[str, Any]]]] = {}


# --------------------------------------------------------- the recorder --

def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class OpRecorder(TorchDispatchMode):
    """Records, for every operation run inside the block, its name and the
    shape and dtype of each output that is a new allocation (a storage no
    input and no earlier output held): the torch counterpart of reading a
    jaxpr's equations."""

    def __init__(self, inputs=()):
        super().__init__()
        self._seen = {_storage(t) for t in _leaves(inputs)}
        self.ops: List[Tuple[str, Tuple[int, ...], torch.dtype]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            if t.device.type == "meta":
                continue
            st = _storage(t)
            if st and st not in self._seen:
                self._seen.add(st)
                self.ops.append((str(func.overloadpacket.__name__), tuple(t.shape), t.dtype))
        return out

    def f32_at_least(self, elems: int) -> List[Tuple[str, Tuple[int, ...]]]:
        """The f32 allocations of at least ``elems`` elements."""
        return [(op, shape) for op, shape, dt in self.ops
                if dt == torch.float32 and math.prod(shape) >= elems]


# ------------------------------------------------------- invariant checks --

def check_dtype_flow(rec: OpRecorder, inputs, *, quantized: bool, fp_threshold_elems: int,
                     emit) -> None:
    """Family 1: no f64 anywhere; in quantized programs no f32 allocation
    of ``fp_threshold_elems`` or more (a dequantized-cache-sized one)."""
    bad_in = [t for t in _leaves(inputs) if t.dtype == torch.float64]
    if bad_in:
        emit("prog:f64", f"float64 program input {tuple(bad_in[0].shape)}")
    else:
        for op, shape, dt in rec.ops:
            if dt == torch.float64:
                emit("prog:f64", f"float64 intermediate {shape} out of {op} — a Python-float "
                                 f"or numpy promotion doubles every downstream buffer")
                break
    if quantized:
        big = rec.f32_at_least(fp_threshold_elems)
        if big:
            op, shape = big[0]
            emit("prog:fp-cache-alloc",
                 f"f32 allocation {shape} out of {op} is >= the dequantized cache "
                 f"({fp_threshold_elems} elements) — this materializes the fp cache "
                 f"quantization exists to avoid")


def check_pinning(args: Sequence[Any], outputs: Any, pinned: Sequence[int],
                  threshold_bytes: int, emit) -> None:
    """Family 2: each argument leaf of ``threshold_bytes`` or more that the
    program hands back (the same storage, or a new tensor of its shape and
    dtype) must belong to a pinned argument and come back as the same
    storage, updated in place."""
    outs = list(_leaves(outputs))
    out_storages = {_storage(t) for t in outs}
    out_avals = {(tuple(t.shape), t.dtype) for t in outs}
    for i, arg in enumerate(args):
        for leaf in _leaves(arg):
            nbytes = leaf.numel() * leaf.element_size()
            if nbytes < threshold_bytes:
                continue
            in_place = _storage(leaf) in out_storages
            copied = not in_place and (tuple(leaf.shape), leaf.dtype) in out_avals
            if not (in_place or copied):
                continue
            if i not in pinned:
                emit("prog:cache-not-pinned",
                     f"arg {i} threads a {nbytes}-byte {tuple(leaf.shape)} {leaf.dtype} leaf "
                     f"through to the outputs but is not pinned — declare it in pinned= (the "
                     f"runner's own tensor, updated in place)")
                return
            if copied:
                emit("prog:cache-not-pinned",
                     f"pinned arg {i} comes back as a new {tuple(leaf.shape)} tensor, not "
                     f"updated in place — the step doubles the cache, and a captured graph "
                     f"would write a copy the next round never reads")
                return


def cost_findings(rows: Sequence[Dict[str, Any]], emit_for) -> None:
    """Family 3: each cost row's counted/bound ratio must sit inside its
    tolerance band."""
    for row in rows:
        if row["tol_lo"] <= row["ratio"] <= row["tol_hi"]:
            continue
        emit = emit_for(row)
        emit("prog:cost-drift",
             f"{row['kind']} counted from the run is {row['counted']:.3g} "
             f"vs roofline bound {row['bound']:.3g} "
             f"(ratio {row['ratio']:.3f} outside "
             f"[{row['tol_lo']}, {row['tol_hi']}]) — the program and "
             f"core.roofline.predict_phase disagree about what this phase does")


def check_bucket_coverage(runner, emit) -> None:
    """Family 4: the bucket functions' promised shape sets are covering,
    aligned, logarithmically bounded, and CLOSED over the built grid."""
    paged = getattr(runner, "paged", None) is not None \
        or getattr(runner, "cache_layout", "contiguous") == "paged"
    q = runner.block_size if paged else runner.prompt_len
    max_len = runner.max_len
    buckets = runner.reachable_buckets()
    bound = 4 + max(0, math.ceil(math.log2(max(1, max_len / q)))) + 2
    if len(buckets) > bound:
        emit("prog:shape-leak",
             f"{len(buckets)} reachable prefill buckets exceeds the "
             f"O(log(max_len/quantum)) promise (<= {bound}) — bucket() is "
             f"leaking per-prompt shapes into the program registry")
    for n in range(1, max_len + 1):
        b = runner.bucket(n)
        if b < min(n, max_len) or b > max_len:
            emit("prog:shape-leak",
                 f"bucket({n}) = {b} does not cover the prompt within "
                 f"max_len={max_len} — padded prefill would truncate")
            return
        if b % q and b != max_len:
            emit("prog:shape-leak",
                 f"bucket({n}) = {b} is not quantum-aligned (q={q}) and is "
                 f"not the max_len fallback — an unplanned program shape")
            return
    # closure: after build_serving_grid(), re-requesting the programs for
    # every reachable prompt must register nothing
    before = set(runner.engine.programs)
    for n in range(1, max_len + 1):
        runner.progs(runner.bucket(n))
    if runner.prefill_chunk is not None:
        for n in range(1, max_len + 1):
            start = 0
            for size in runner.chunk_sizes(n):
                runner.chunk_prog(runner.chunk_bucket(size, start),
                                  runner.prefix_width(start))
                start += size
    leaked = set(runner.engine.programs) - before
    if leaked:
        emit("prog:shape-leak",
             f"serving reached program(s) the built grid did not contain: "
             f"{sorted(leaked)} — build_serving_grid()/bucket() and "
             f"dispatch diverged (a capture inside a served request on the card)")
    missing = [k for k, sig in runner.program_signatures().items() if sig.args is None]
    if missing:
        emit("prog:shape-leak",
             f"registered program(s) with no signature: {sorted(missing)} — the "
             f"registry and ModelRunner.abstract_signature() diverged; the auditor "
             f"cannot see what serving dispatches")


# ------------------------------------------------------------- op contract --

OPS_MODULES = (
    "repro_torch.kernels.decode_attention.ops",
    "repro_torch.kernels.paged_attention.ops",
    "repro_torch.kernels.prefill_attention.ops",
    "repro_torch.kernels.tlmm.ops",
)


def _op_probe(name: str):
    """Small representative arguments for a kernel entry point (its plain
    version runs on the CPU)."""
    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16
    z = torch.zeros
    if name == "decode_attention":
        return (z((2, 2, 32), dtype=f32), z((2, 2, 16, 32), dtype=bf16),
                z((2, 2, 16, 32), dtype=bf16), torch.full((2,), 3, dtype=i32)), {}
    if name == "paged_decode_attention":
        return (z((2, 2, 32), dtype=f32), z((4, 2, 8, 32), dtype=bf16),
                z((4, 2, 8, 32), dtype=bf16), z((2, 2), dtype=i32),
                torch.full((2,), 3, dtype=i32)), {}
    if name == "prefill_attention":
        return (z((1, 2, 16, 32), dtype=f32), z((1, 2, 16, 32), dtype=f32),
                z((1, 2, 16, 32), dtype=f32)), {}
    if name == "tlmm_matmul":
        from repro_torch.quant.ternary import TernaryWeight

        w = TernaryWeight(packed=z((16, 32), dtype=torch.uint8), scale=torch.ones((), dtype=f32))
        return (z((4, 64), dtype=f32), w), {}
    return None


def check_op_contracts(emit_at, modules: Sequence[Any] = OPS_MODULES) -> None:
    """Validate each ops module's ``CACHE_OPERANDS`` declaration and run the
    declared read-only entries on probe arguments: a cache operand must
    never come back among the outputs.  ``modules`` takes import names or
    module objects; a module may carry ``_ANALYSIS_PROBES = {entry: (args,
    kwargs)}`` to override the built-in probes."""
    import importlib
    import inspect

    for modname in modules:
        mod = importlib.import_module(modname) \
            if isinstance(modname, str) else modname
        emit = emit_at(Path(mod.__file__), 1)
        decl = getattr(mod, "CACHE_OPERANDS", None)
        if not isinstance(decl, dict) or not decl:
            emit("prog:op-annotation",
                 f"{modname} declares no CACHE_OPERANDS — every kernel ops "
                 f"module must state which operands alias persistent "
                 f"buffers (and that it never writes them)")
            continue
        for entry, spec in decl.items():
            fn = getattr(mod, entry, None)
            if fn is None or not callable(fn):
                emit("prog:op-annotation",
                     f"CACHE_OPERANDS names {entry!r} but {modname} has no "
                     f"such callable")
                continue
            emit = emit_at(Path(mod.__file__), fn.__code__.co_firstlineno)
            params = list(inspect.signature(fn).parameters)
            args = (spec or {}).get("args", ())
            bad = [a for a in args if a not in params]
            if bad or not args or "writes" not in (spec or {}):
                emit("prog:op-annotation",
                     f"CACHE_OPERANDS[{entry!r}] is malformed: args={args} "
                     f"(unknown: {bad}) writes={(spec or {}).get('writes')!r} — "
                     f"declare the cache-aliasing parameter names and "
                     f"writes: False")
                continue
            if spec["writes"]:
                emit("prog:op-annotation",
                     f"CACHE_OPERANDS[{entry!r}] declares writes=True — "
                     f"kernel ops are read-only over caches in this repo; "
                     f"cache mutation belongs to the programs' pinned buffers")
                continue
            probe = getattr(mod, "_ANALYSIS_PROBES", {}).get(entry) \
                or _op_probe(entry)
            if probe is None:
                continue
            pargs, pkw = probe
            try:
                bound = inspect.signature(fn).bind(*pargs, **pkw)
                with torch.no_grad():
                    out = fn(*pargs, **pkw)
            except Exception as e:  # noqa: BLE001 — probe drift is a finding
                emit("prog:op-annotation",
                     f"could not run {entry} on its probe arguments: "
                     f"{type(e).__name__}: {e}")
                continue
            cache = {_storage(t) for a in args if a in bound.arguments
                     for t in _leaves(bound.arguments[a])}
            if any(_storage(t) in cache for t in _leaves(out)):
                emit("prog:op-alias",
                     f"{entry} returns a declared cache operand — a read-only "
                     f"kernel op must not hand the cache back among its outputs "
                     f"(the programs own cache buffers, pinned and updated in place)")


# ---------------------------------------------------------------- the pass --

class _Emitter:
    """Findings anchored to real source locations, honoring def-line
    ``allow()`` pragmas in the anchor file."""

    def __init__(self, root: Path):
        self.root = root
        self.findings: List[Finding] = []
        self._afs: Dict[Path, Optional[AnalyzedFile]] = {}

    def _af(self, path: Path) -> Optional[AnalyzedFile]:
        if path not in self._afs:
            try:
                path.relative_to(self.root)
                self._afs[path] = AnalyzedFile(path, self.root)
            except (ValueError, OSError):
                self._afs[path] = None
        return self._afs[path]

    def at(self, path: Path, line: int, scope: str = ""):
        af = self._af(path)
        rel = str(path.relative_to(self.root)) if af else path.name

        def emit(rule: str, msg: str) -> None:
            if af is not None and af.waived(rule, line, (line,)):
                return
            self.findings.append(
                Finding(PASS, rule, rel, line, msg, scope=scope))

        return emit

    def for_program(self, prog, scope: str):
        code = getattr(prog.fn, "__code__", None)
        if code is None:  # pragma: no cover - non-Python callable
            return self.at(self.root / "core" / "phase_engine.py", 1, scope)
        return self.at(Path(code.co_filename), code.co_firstlineno, scope)


def grid_runner(layout: str, kv_dtype: str):
    """The audit grid's runner on the CPU."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.core import ModelRunner

    cfg = reduced_config(GRID_ARCH, **GRID_MODEL)
    params = T.init(cfg, 0, device="cpu")
    return ModelRunner(cfg, params, cache_layout=layout, kv_dtype=kv_dtype, device="cpu",
                       **GRID_RUNNER)


def run_program(sig):
    """Run one program at its signature on the CPU: (inputs, outputs,
    recorder, counted FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    inputs = sig.inputs("cpu")
    rec = OpRecorder(inputs)
    flops = FlopCounterMode(display=False)
    with torch.no_grad(), flops, rec:
        out = sig.program.fn(*inputs)
    return inputs, out, rec, float(flops.get_total_flops())


def _audit_point(layout: str, kv_dtype: str, em: _Emitter,
                 rows: List[Dict[str, Any]]) -> None:
    from repro_torch.core.roofline import predict_phase

    runner = grid_runner(layout, kv_dtype)
    cfg = runner.cfg
    scope = f"{layout}/{kv_dtype}"
    runner.build_serving_grid()
    check_bucket_coverage(runner, em.at(
        Path(type(runner).bucket.__code__.co_filename),
        type(runner).bucket.__code__.co_firstlineno, scope))

    cache_tree = runner.paged.kv if layout == "paged" else runner.cache
    cache_leaves = list(_leaves(cache_tree))
    pin_threshold = max(t.numel() * t.element_size() for t in cache_leaves)
    # one full direction (K or V) of the dequantized fp cache, in elements
    n_slots = len(runner.slots.slots)
    fp_threshold = (n_slots * cfg.num_layers * cfg.num_kv_heads
                    * runner.max_len * cfg.head_dim)
    capacity = (runner.paged.max_pages * runner.block_size
                if layout == "paged" else runner.max_len)
    kv_bound = predict_phase("decode", cfg, context=capacity,
                             kv_dtype=kv_dtype, batch=n_slots).hbm_bytes

    sigs = runner.program_signatures()
    split_flops: Dict[str, Dict[str, Any]] = {}
    for key in sorted(sigs):
        sig = sigs[key]
        if sig.args is None:
            continue  # reported by check_bucket_coverage
        prog = sig.program
        emit = em.for_program(prog, f"{scope}:{key}")
        try:
            inputs, out, rec, flops = run_program(sig)
        except Exception as e:  # noqa: BLE001 — a finding, not a crash
            emit("prog:shape-leak",
                 f"program {key} does not run at its registered signature "
                 f"({type(e).__name__}: {e}) — the signature and the program diverged")
            continue
        check_dtype_flow(rec, inputs, quantized=kv_dtype != "fp",
                         fp_threshold_elems=fp_threshold, emit=emit)
        check_pinning(inputs, out, prog.pinned, pin_threshold, emit)

        if sig.phase == "decode":
            counted = sum(t.numel() * t.element_size() for i in prog.pinned if i != 0
                          for t in _leaves(inputs[i]))
            rows.append(dict(
                layout=layout, kv_dtype=kv_dtype, program=key,
                kind="kv_stream_bytes", counted=float(counted),
                bound=float(kv_bound),
                ratio=counted / kv_bound if kv_bound else float("inf"),
                tol_lo=round(1.0 / KV_BYTES_TOL, 4), tol_hi=KV_BYTES_TOL,
                prog=prog))
        elif sig.phase == "prefill":
            m = key.split(":")
            if key.startswith("prefill_split_varlen:"):
                base = f"{m[0]}:{m[1]}"
                d = split_flops.setdefault(base, dict(flops=0.0, prog=prog))
                d["flops"] += flops
                if len(m) == 2:  # the body carries the token count
                    b, s = map(int, m[1].split("x"))
                    d.update(tokens=b * s, prog=prog, key=base)
            else:  # chunk programs: tokens = padded chunk length
                c = int(key.split(":")[1].split("+")[0])
                split_flops[key] = dict(flops=flops, tokens=c, prog=prog, key=key)

    n_params = sum(t.numel() for t in _leaves(runner.params))
    flops_bound = predict_phase("prefill", n_params=n_params).flops
    for d in split_flops.values():
        per_tok = d["flops"] / d["tokens"]
        rows.append(dict(
            layout=layout, kv_dtype=kv_dtype, program=d["key"],
            kind="flops_per_token", counted=per_tok,
            bound=float(flops_bound), ratio=per_tok / flops_bound,
            tol_lo=PREFILL_FLOPS_BAND[0], tol_hi=PREFILL_FLOPS_BAND[1],
            prog=d["prog"]))


def audit(root: Optional[Path] = None,
          layouts: Sequence[str] = LAYOUTS,
          kv_dtypes: Sequence[str] = KV_DTYPES,
          ) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Run the full audit over the serving grid.  Returns ``(findings,
    cost_rows)``; memoized per (root, grid) — the gate, the report and the
    tests share one run of the grid per process."""
    from repro_torch.analysis import default_root

    root = (root or default_root()).resolve()
    memo_key = (root, tuple(layouts), tuple(kv_dtypes))
    if memo_key in _MEMO:
        return _MEMO[memo_key]
    em = _Emitter(root)
    rows: List[Dict[str, Any]] = []
    for layout in layouts:
        for kv_dtype in kv_dtypes:
            _audit_point(layout, kv_dtype, em, rows)
    check_op_contracts(em.at)

    def emit_for(row):
        return em.for_program(row["prog"],
                              f"{row['layout']}/{row['kv_dtype']}"
                              f":{row['program']}")

    cost_findings(rows, emit_for)
    for row in rows:
        row.pop("prog", None)
    _MEMO[memo_key] = (em.findings, rows)
    return _MEMO[memo_key]


def cost_table(root: Optional[Path] = None) -> List[Dict[str, Any]]:
    """The static-cost-vs-roofline residual table (one row per audited
    (grid point, program, metric)) — what ``analysis.report`` prints."""
    return audit(root)[1]


def run(root: Path, subset: Optional[Sequence[str]] = None) -> List[Finding]:
    """Pass protocol entry point.  The program pass audits the IMPORTED
    package; a foreign ``root`` (fixture trees, ``--root``) has no programs
    to run and reports clean."""
    from repro_torch.analysis import default_root

    if Path(root).resolve() != default_root().resolve():
        return []
    return audit(root)[0]
