"""The CUDA kernels' invariants: launch limits, the plain versions'
contracts, and every launch inside guard bands on the card.

The port's counterpart of the JAX package's ``repro.analysis.kernel_check``,
which reads the Pallas kernels' BlockSpecs: a CUDA kernel has no BlockSpec
to read, so the pass checks what its launch must respect and what it
computes.  Two halves:

* **On the CPU** (always):

  - ``kernel:smem`` — for every architecture of the registry and every
    shape its serving grid reaches, each launch's shared memory
    (``kernels.costs``, from the tile constants of ``csrc/``) is at most
    227 KiB and each cluster at most 8 blocks;
  - ``kernel:contract`` — the shapes every launch needs (head_dim, the
    query group, K % 4 for the 16-byte rows of ``act_quant``), and the
    plain versions' contracts at the grid's extremes, which the card half
    holds the kernels to: block-table ids clipped to [0, N-1], rows
    outside [start, length) and past a slot's S masked, the causal mask,
    B1's plain version equal to the paper's table-lookup algorithm
    (``tlmm_lut_reference``) at M on both sides of the split-K/MMA switch.

* **On the card** (``device="cuda"``): each of the seven launches
  (``act_quant``, ``tlmm``, ``prefill_attention`` and the four walks) runs
  over a grid of cases (B1 at M in {1, 4, 8, 9, 20, 130} with N off a
  multiple of 128; B2 at S in {1, 63, 64, 65, 257, 520}; the walks at
  lengths 0, 1, partial, full and past S, 1 or 5 rows a slot, a window's
  start; tables holding 0, N-1, repeats and ids past N-1, a partial last
  page) with every operand inside a flat buffer with 4 KiB guard bands
  (16-byte alignment kept, ``.contiguous()`` a no-op).  Input pads and
  the operands' dead rows hold NaN (floats) or bytes that decode to large
  values (payloads, indices); output pads hold a sentinel.  Each case
  runs twice, with two different fillings:

  - ``kernel:oob-read`` — NaN in a result, or a result that changes with
    the filling (it read a pad or a dead row);
  - ``kernel:oob-write`` — a sentinel or an input byte changed;
  - ``kernel:mismatch`` — the result is off its plain version (on the CPU)
    beyond the tolerance ``PERF.md`` states: B1 and ``act_quant`` bit for
    bit, the walks 3.9e-6; B2 is held to an f64 evaluation of its plain
    version, within 1.5e-6 or twice the f32 plain version's own distance
    from it, whichever is larger;
  - ``kernel:fp-cache-alloc`` — a quantized entry point that, under a
    dispatch recorder, allocates an f32 tensor as large as one
    dequantized KV operand (the dequant belongs to the tile);
  - ``kernel:eval-error`` — a launch or a plain version raised.

Findings anchor to the wrapper (its file and ``def`` line): a (case,
launch) has no source line of its own.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.common import Finding
from repro_torch.kernels import costs

PASS = "kernel"
LAUNCHES = ("act_quant", "tlmm", "prefill_attention", "decode_attention",
            "decode_attention_quant", "paged_decode_attention", "paged_decode_attention_quant")
WALKS = LAUNCHES[3:]
# the plain versions' tolerances (PERF.md §6): B1 and act-quant bit for bit
TOL = {"act_quant": 0.0, "tlmm": 0.0, "prefill_attention": 1.5e-6}
TOL.update({w: 3.9e-6 for w in WALKS})
# B2 against f64: 3xTF32 and the CPU's f32 sums each round a 128-term dot
# product by about as much as the other, so the f32 plain version is no
# exact yardstick at D = 128; B2 may lie this many times as far from an f64
# evaluation as the f32 plain version does (and TOL in any case)
WITNESS = 2.0
GUARD = 4096  # bytes of each guard band: keeps 16-byte (and 512-byte) alignment
OUT_SENTINEL = 0xFF  # an output's pad byte (f32 NaN if read back as data)
EXTRA_ROWS = 8  # rows of junk past S (or past a page's bs) along dim 2 of a strided operand

# the serving grids the smem check walks: decode rows, verify rows (4 slots
# x 5 block rows), chunk and prefill rows
TLMM_ROWS = (1, 2, 4, 8, 9, 10, 20, 130, 256, 2048)
CONTEXTS = (2048, 4096, 65536, 524288)  # the caches the smoke and the examples serve
PAGE = 16


# ---------------------------------------------------------------- the anchor --

def _where(fn, root: Optional[Path]) -> Tuple[str, int]:
    code = fn.__code__
    path = Path(code.co_filename)
    rel = path.as_posix()
    if root is not None:
        try:
            rel = path.relative_to(root).as_posix()
        except ValueError:
            pass
    return rel, code.co_firstlineno


def _wrappers() -> Dict[str, Callable]:
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_kernel, decode_attention_quant_kernel)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention_kernel, paged_decode_attention_quant_kernel)
    from repro_torch.kernels.prefill_attention.ops import prefill_attention_kernel
    from repro_torch.kernels.tlmm.ops import act_quant_kernel, tlmm_kernel

    return {"act_quant": act_quant_kernel, "tlmm": tlmm_kernel,
            "prefill_attention": prefill_attention_kernel,
            "decode_attention": decode_attention_kernel,
            "decode_attention_quant": decode_attention_quant_kernel,
            "paged_decode_attention": paged_decode_attention_kernel,
            "paged_decode_attention_quant": paged_decode_attention_quant_kernel}


def _plains() -> Dict[str, Callable]:
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_quant_reference, decode_attention_reference)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_quant_reference, paged_decode_attention_reference)
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_reference
    from repro_torch.kernels.tlmm.ref import tlmm_reference
    from repro_torch.quant.act_quant import quantize_and_fold

    return {"act_quant": quantize_and_fold, "tlmm": tlmm_reference,
            "prefill_attention": prefill_attention_reference,
            "decode_attention": decode_attention_reference,
            "decode_attention_quant": decode_attention_quant_reference,
            "paged_decode_attention": paged_decode_attention_reference,
            "paged_decode_attention_quant": paged_decode_attention_quant_reference}


# ------------------------------------------------------- CPU: launch limits --

@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch shape: the kernel, a label, and its cost model."""
    kernel: str
    label: str
    cost: costs.KernelCost


def served_launches(cfg, contexts: Sequence[int] = CONTEXTS,
                    tlmm_rows: Sequence[int] = TLMM_ROWS) -> Tuple[List[Launch], List[str]]:
    """Every launch shape the serving grid of ``cfg`` reaches, with the
    shape problems no launch would accept (a head_dim or query group the
    kernels do not take, a K off a multiple of 4)."""
    out: List[Launch] = []
    problems: List[str] = []
    if cfg.attention_free:
        return out, problems
    hd, g, hkv, h = cfg.head_dim, cfg.q_group, cfg.num_kv_heads, cfg.num_heads
    if hd not in costs.WALK_HEAD_DIMS or hd not in costs.PREFILL_HEAD_DIMS:
        problems.append(f"head_dim {hd} is not one the kernels take {costs.WALK_HEAD_DIMS}")
    if g > costs.WALK_MAX_GROUP:
        problems.append(f"{g} query heads a KV head: the walks take at most "
                        f"{costs.WALK_MAX_GROUP}")
    if cfg.quant.ternary:
        d, f = cfg.d_model, cfg.ffn_hidden
        for name, (k, n) in {"wq": (d, h * hd), "wk": (d, hkv * hd), "wo": (h * hd, d),
                             "w_gate": (d, f), "w_down": (f, d)}.items():
            if k % 4:
                problems.append(f"{name}: K={k} is not a multiple of 4 (act_quant's rows)")
                continue
            for m in tlmm_rows:
                out.append(Launch("tlmm", f"{name} M={m} K={k} N={n}", costs.tlmm_cost(m, k, n)))
                out.append(Launch("act_quant", f"{name} M={m} K={k}",
                                  costs.act_quant_cost(m, k)))
    for s in sorted({64, 512, 513, 2048} | set(contexts)):
        if s <= 8192:  # a monolithic prefill bucket; longer prompts go in chunks
            out.append(Launch("prefill_attention", f"H={h} Hkv={hkv} S={s} D={hd}",
                              costs.prefill_attention_cost(1, h, hkv, s, hd)))
    for cap in contexts:
        for kv, elt in (("fp", 2), ("fp", 4), ("int8", 2), ("int4", 2)):
            slot = "decode_attention" if kv == "fp" else "decode_attention_quant"
            paged = "paged_" + slot
            fmt = {("fp", 2): "bf16", ("fp", 4): "f32"}.get((kv, elt), kv)
            out.append(Launch(slot, f"{fmt} Hkv={hkv} G={g} D={hd} S={cap}",
                              costs.decode_attention_cost([cap], hkv, g, hd, kv_dtype=kv,
                                                          elt=elt, cap=cap)))
            out.append(Launch(paged, f"{fmt} Hkv={hkv} G={g} D={hd} P={cap // PAGE} bs={PAGE}",
                              costs.decode_attention_cost([cap], hkv, g, hd, kv_dtype=kv,
                                                          elt=elt, cap=cap, paged=True,
                                                          bs=PAGE)))
    return out, problems


def check_launches(launches: Sequence[Launch], where: Dict[str, Tuple[str, int]],
                   scope: str = "") -> List[Finding]:
    """``kernel:smem`` for each launch over the card's limits."""
    found = []
    for ln in launches:
        rel, line = where.get(ln.kernel, ("kernels/costs.py", 1))
        c = ln.cost
        if c.smem_bytes > costs.SMEM_PER_BLOCK or c.cluster > costs.MAX_CLUSTER:
            found.append(Finding(
                PASS, "kernel:smem", rel, line,
                f"{scope}{ln.kernel} {ln.label}: {c.smem_bytes} bytes of shared memory a block "
                f"(at most {costs.SMEM_PER_BLOCK}) and clusters of {c.cluster} blocks (at most "
                f"{costs.MAX_CLUSTER}) — the launch would be refused", scope=scope.strip(": ")))
    return found


def check_registry(where: Dict[str, Tuple[str, int]]) -> Tuple[List[Finding], int]:
    """Every arch of the registry: (findings, launches checked)."""
    from repro_torch.configs import ALL_ARCHS, get_config

    found: List[Finding] = []
    n = 0
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        launches, problems = served_launches(cfg)
        n += len(launches)
        found += check_launches(launches, where, scope=f"{arch}: ")
        for p in problems:
            rel, line = where["decode_attention"]
            found.append(Finding(PASS, "kernel:contract", rel, line, f"{arch}: {p}", scope=arch))
    return found, n


# ------------------------------------------------------------ the case grid --

@dataclasses.dataclass
class Operand:
    """One argument of a launch: its live contents (numpy; dead positions
    hold 0), the dead positions (a bool mask of ``data``'s shape, or None),
    the junk rows to keep past it along dim 2 (the operand is then a view
    of a taller buffer), its torch dtype and how its junk is made."""
    data: np.ndarray
    dtype: torch.dtype
    kind: str  # "float" | "int8" | "int4" | "index" | "packed"
    dead: Optional[np.ndarray] = None
    extra_rows: int = 0


@dataclasses.dataclass
class KernelCase:
    """One launch: ``args`` name the operands of ``operands`` (or hold plain
    values), ``plain_args`` those of the plain version's call."""
    kernel: str
    label: str
    operands: Dict[str, Operand]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    plain_args: Tuple[Any, ...]
    plain_kwargs: Dict[str, Any]
    # the elements of one dequantized KV operand (the f32 allocation the
    # quantized walks must never make), for the fp-cache-alloc check
    fp_elems: Optional[int] = None
    repeat: int = 1  # query rows a slot: the plain version reads each slot repeated


def _junk(kind: str, fill: str):
    """The value a pad or a dead position holds: filling "a" is NaN or a
    byte that decodes large, "b" another value."""
    return {
        ("float", "a"): float("nan"), ("float", "b"): 0.5,
        ("int8", "a"): 127, ("int8", "b"): -127,
        ("int4", "a"): 0x77, ("int4", "b"): 0x99,
        ("index", "a"): 0x7F7F7F7F, ("index", "b"): 0,
        ("packed", "a"): 0x55, ("packed", "b"): 0xAA,
    }[(kind, fill)]


def _host(op: Operand, fill: Optional[str]) -> torch.Tensor:
    """The operand's full contents on the CPU: live data, and junk of
    ``fill`` in its dead positions and extra rows (zeros in the dead
    positions when ``fill`` is None)."""
    data = op.data.copy()
    if fill is not None and op.dead is not None:
        data[op.dead] = _junk(op.kind, fill) if op.kind != "float" else 0
    t = torch.from_numpy(data).to(op.dtype)
    if fill is not None and op.dead is not None and op.kind == "float":
        t[torch.from_numpy(op.dead)] = _junk("float", fill)
    if not op.extra_rows:
        return t
    shape = list(op.data.shape)
    shape[2] += op.extra_rows
    full = torch.empty(shape, dtype=op.dtype)
    full.fill_(_junk(op.kind, fill or "b"))
    full[:, :, :op.data.shape[2]] = t
    return full


def _as_signed(kind: str, v):
    """A junk value as the operand's element type holds it."""
    return v & 0xFF if kind in ("int4", "packed") else v


class Guarded:
    """A tensor placed in the middle of a flat device buffer whose 4 KiB
    bands on each side hold junk (inputs) or a sentinel (outputs)."""

    def __init__(self, shape, dtype: torch.dtype, device, pad_value, kind: str = "float"):
        elt = torch.empty((), dtype=dtype).element_size()
        n = int(math.prod(shape)) * elt
        self.nbytes = n
        self.buf = torch.empty(2 * GUARD + (n + 15) // 16 * 16, dtype=torch.uint8, device=device)
        if kind == "sentinel":
            self.buf.fill_(pad_value)
        else:
            self.buf.view(dtype).fill_(_as_signed(kind, pad_value))
        self.tensor = self.buf[GUARD:GUARD + n].view(dtype).view(shape)
        self.initial = None

    def snapshot(self) -> None:
        self.initial = self.buf.clone()

    def pads_hold(self, byte: int) -> bool:
        return bool((self.buf[:GUARD] == byte).all() and
                    (self.buf[GUARD + self.nbytes:] == byte).all())

    def unchanged(self) -> bool:
        return bool(torch.equal(self.buf, self.initial))


class _GuardedOutputs(torch.overrides.TorchFunctionMode):
    """Within the block, every ``torch.empty`` on a CUDA device (the
    wrappers' outputs) comes from a guarded buffer whose bytes, pads
    included, hold ``OUT_SENTINEL``."""

    def __init__(self):
        super().__init__()
        self.outputs: List[Guarded] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.empty and kwargs.get("device") is not None \
                and torch.device(kwargs["device"]).type == "cuda" and not kwargs.get("out"):
            shape = args[0] if len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)) \
                else args
            g = Guarded(tuple(shape), kwargs.get("dtype") or torch.get_default_dtype(),
                        kwargs["device"], OUT_SENTINEL, kind="sentinel")
            self.outputs.append(g)
            return g.tensor
        return func(*args, **kwargs)


def _place(op: Operand, fill: str, device) -> Tuple[torch.Tensor, Guarded]:
    """The operand inside a guarded device buffer, pads and dead positions
    holding filling ``fill``; a view of its live rows when it has extra
    rows."""
    full = _host(op, fill)
    g = Guarded(full.shape, op.dtype, device, _junk(op.kind, fill), kind=op.kind)
    g.tensor.copy_(full.to(device))
    t = g.tensor[:, :, :op.data.shape[2]] if op.extra_rows else g.tensor
    return t, g


def _resolve(args, named: Dict[str, Any]):
    return tuple(named[a] if isinstance(a, str) and a in named else a for a in args)


def _resolve_kw(kwargs, named):
    return {k: (named[v] if isinstance(v, str) and v in named else v) for k, v in kwargs.items()}


def _results(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _act_quant_cases() -> List[KernelCase]:
    rng = np.random.default_rng(10)
    cases = []
    grid = [(m, k, torch.float32) for m in (1, 4, 8, 9, 20, 130) for k in (64, 1540)]
    grid.append((9, 1540, torch.bfloat16))
    for m, k, dtype in grid:
        x = rng.standard_normal((m, k)).astype(np.float32)
        x *= (10.0 ** rng.uniform(-2, 2, (m, 1))).astype(np.float32)
        x[0] = 0.0  # an all-zero row
        if dtype == torch.bfloat16:
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        beta = np.array([0.037], np.float32)
        ops = {"x": Operand(x, dtype, "float"), "beta": Operand(beta, torch.float32, "float")}
        cases.append(KernelCase("act_quant", f"act_quant M={m} K={k} {str(dtype)[6:]}", ops,
                                ("x", "beta"), {}, ("x", "beta"), {}))
    return cases


def _tlmm_cases() -> List[KernelCase]:
    rng = np.random.default_rng(11)
    cases = []
    for m in (1, 4, 8, 9, 20, 130):
        for k, n in ((1536, 200), (260, 136), (4096, 1000)):
            x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
            w = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
            scale = (rng.random((m, 1)) * 1e-3).astype(np.float32)
            ops = {"x_q": Operand(x_q, torch.int8, "int8"),
                   "w": Operand(w, torch.uint8, "packed"),
                   "scale": Operand(scale, torch.float32, "float")}
            path = "split-K" if costs.tlmm_split(m, k, n) else "MMA"
            cases.append(KernelCase("tlmm", f"tlmm M={m} K={k} N={n} ({path})", ops,
                                    ("x_q", "w", "scale"), {}, ("x_q", "w", "scale"), {}))
    return cases


def _prefill_cases() -> List[KernelCase]:
    rng = np.random.default_rng(12)
    cases = []
    grid = [(s, d, h, hkv) for s in (1, 63, 64, 65, 257) for d in (64, 128)
            for h, hkv in ((4, 4), (8, 2))]
    grid += [(520, 64, 4, 2), (65, 32, 4, 4)]
    for s, d, h, hkv in grid:
        q = rng.standard_normal((1, h, s, d)).astype(np.float32)
        k, v = (rng.standard_normal((1, hkv, s, d)).astype(np.float32) for _ in range(2))
        ops = {n: Operand(a, torch.float32, "float", extra_rows=EXTRA_ROWS)
               for n, a in (("q", q), ("k", k), ("v", v))}
        cases.append(KernelCase("prefill_attention", f"prefill H={h} Hkv={hkv} S={s} D={d}", ops,
                                ("q", "k", "v"), {}, ("q", "k", "v"), {}))
    return cases


def _payload(rng, shape, kv: str, d: int):
    if kv == "int4":
        return rng.integers(0, 256, shape + (d // 2,)).astype(np.uint8), torch.uint8, "int4"
    return rng.integers(-127, 128, shape + (d,)).astype(np.int8), torch.int8, "int8"


def _walk_tensors(rng, shape, fmt: str, d: int, dead: np.ndarray, extra: int):
    """K and V (or their payloads and scale planes) of shape ``shape`` + D
    with ``dead`` (shape) positions marked."""
    if fmt in ("bf16", "f32"):
        dtype = torch.bfloat16 if fmt == "bf16" else torch.float32
        out = {}
        for n in ("k", "v"):
            a = rng.standard_normal(shape + (d,)).astype(np.float32)
            if fmt == "bf16":
                a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            a[dead] = 0.0
            out[n] = Operand(a, dtype, "float", np.broadcast_to(dead[..., None], a.shape).copy(),
                             extra)
        return out
    out = {}
    for n in ("k", "v"):
        p, dt, kind = _payload(rng, shape, fmt, d)
        p[dead] = 0
        s = (rng.random(shape) * 0.02 + 0.01).astype(np.float32)
        s[dead] = 0.0
        out[n] = Operand(p, dt, kind, np.broadcast_to(dead[..., None], p.shape).copy(), extra)
        out[n + "_scale"] = Operand(s, torch.float32, "float", dead.copy(), extra)
    return out


def _slot_cases() -> List[KernelCase]:
    rng = np.random.default_rng(13)
    cases = []
    hkv, s = 2, 40  # S off a multiple of the 16-row virtual page
    for fmt in ("bf16", "f32", "int8", "int4"):
        quant = fmt in ("int8", "int4")
        kernel = "decode_attention_quant" if quant else "decode_attention"
        for d in (64, 128):
            for g in (1, 5):
                for variant in ("lengths", "window", "rows5"):
                    if variant == "lengths":
                        r, lengths, starts = 1, [0, 1, 23, s], None
                    elif variant == "window":
                        r, lengths, starts = 1, [17, s + 5, 33, 40], [0, 21, 16, 40]
                    else:  # a verify block: 5 rows a slot, each its own length
                        r = 5
                        lengths = [3 + i for i in range(5)] + [s - 4 + i for i in range(5)]
                        starts = None
                    n_rows = len(lengths)
                    slots = n_rows // r
                    lo = [0] * n_rows if starts is None else starts
                    live = np.zeros((slots, s), bool)
                    for b in range(n_rows):
                        live[b // r, lo[b]:min(lengths[b], s)] = True
                    dead = np.broadcast_to(~live[:, None, :], (slots, hkv, s)).copy()
                    ops = _walk_tensors(rng, (slots, hkv, s), fmt, d, dead, EXTRA_ROWS)
                    q = rng.standard_normal((n_rows, hkv, g, d)).astype(np.float32)
                    ops["q"] = Operand(q, torch.float32, "float")
                    ops["lengths"] = Operand(np.array(lengths, np.int32), torch.int32, "index")
                    if starts is not None:
                        ops["starts"] = Operand(np.array(starts, np.int32), torch.int32, "index")
                    st = "starts" if starts is not None else None
                    label = (f"{kernel} {fmt} D={d} G={g} S={s} lengths={lengths}"
                             + (f" starts={starts}" if starts else "") + f" rows_per_slot={r}")
                    rep = {"rows_per_slot": r}
                    if quant:
                        args = ("q", "k", "k_scale", "v", "v_scale", "lengths", st)
                        kw = dict(rep, kv_dtype=fmt)
                        plain = ("q", "k_r", "k_scale_r", "v_r", "v_scale_r", "lengths", st)
                        pkw = {"kv_dtype": fmt}
                        fp_elems = slots * hkv * s * d
                    else:
                        args = ("q", "k", "v", "lengths", st)
                        kw = rep
                        plain = ("q", "k_r", "v_r", "lengths", st)
                        pkw = {}
                        fp_elems = None
                    cases.append(KernelCase(kernel, label, ops, args, kw, plain, pkw,
                                            fp_elems=fp_elems, repeat=r))
    return cases


def _paged_cases() -> List[KernelCase]:
    rng = np.random.default_rng(14)
    cases = []
    hkv, n_pages, bs, p = 2, 8, PAGE, 4
    # ids 0 and N-1, repeats, ids past N-1 (clipped to N-1) and below 0
    tables = np.array([[0, 3, 3, n_pages - 1],
                       [n_pages + 2, 5, 1, 2],
                       [6, 6, 0, -3],
                       [4, 2, n_pages - 1, 7]], np.int32)
    for fmt in ("bf16", "f32", "int8", "int4"):
        quant = fmt in ("int8", "int4")
        kernel = "paged_decode_attention_quant" if quant else "paged_decode_attention"
        for d in (64, 128):
            for g in (1, 5):
                for variant in ("lengths", "window"):
                    if variant == "lengths":  # empty, one, a partial last page, past P*bs
                        lengths, starts = [0, 1, 37, p * bs + 6], None
                    else:
                        lengths, starts = [20, 49, 64, 33], [3, 17, 48, 0]
                    lo = [0] * 4 if starts is None else starts
                    clipped = np.clip(tables, 0, n_pages - 1)
                    live = np.zeros((n_pages, bs), bool)
                    for b in range(4):
                        for pos in range(lo[b], min(lengths[b], p * bs)):
                            live[clipped[b, pos // bs], pos % bs] = True
                    dead = np.broadcast_to(~live[:, None, :], (n_pages, hkv, bs)).copy()
                    ops = _walk_tensors(rng, (n_pages, hkv, bs), fmt, d, dead, EXTRA_ROWS)
                    q = rng.standard_normal((4, hkv, g, d)).astype(np.float32)
                    ops["q"] = Operand(q, torch.float32, "float")
                    ops["tables"] = Operand(tables.copy(), torch.int32, "index")
                    ops["lengths"] = Operand(np.array(lengths, np.int32), torch.int32, "index")
                    if starts is not None:
                        ops["starts"] = Operand(np.array(starts, np.int32), torch.int32, "index")
                    st = "starts" if starts is not None else None
                    label = (f"{kernel} {fmt} D={d} G={g} N={n_pages} bs={bs} P={p} "
                             f"lengths={lengths}" + (f" starts={starts}" if starts else ""))
                    if quant:
                        args = ("q", "k", "k_scale", "v", "v_scale", "tables", "lengths", st)
                        kw = {"kv_dtype": fmt}
                        fp_elems = n_pages * hkv * bs * d
                    else:
                        args = ("q", "k", "v", "tables", "lengths", st)
                        kw = {}
                        fp_elems = None
                    cases.append(KernelCase(kernel, label, ops, args, kw, args, dict(kw),
                                            fp_elems=fp_elems))
    return cases


def mesh_cases(kernels: Optional[Sequence[str]] = None) -> List[KernelCase]:
    """The launches a rank of a (data 2, model 2) mesh makes at
    bitnet-730m's widths: ``act_quant`` over a row shard with its extra
    column (K/2 + 4), B1 at the column shards (N/2) and the row shards
    (K/2, unit scale: the rank's int32 partial), B2 on 12 of 24 heads, B3
    and B4 over a sequence half with an empty slot, B5 and B6 over a data
    rank's 2 slots; then granite-moe-3b-a800m's on the same mesh: B2 on 12
    of 24 heads over 4 of 8 KV heads, B3 over a sequence half and B6 over a
    data rank's 2 slots of int8 pages, both at G = 3 (decode keeps the
    heads whole), D = 64; a decode rank's of the pod split of the
    disaggregated pools (data 1): B3 over a sequence half at 4 slots, B6
    over 4 slots of the whole pool; and the verify pass's and the chunks':
    B1 at a data rank's verify rows (M = 10) and a 256-row chunk's, the
    walks over verify rows (``_verify_mesh_cases``)."""
    rng = np.random.default_rng(15)
    cases = []
    for m in (2, 4):
        for k in (772, 2052):
            for dtype in (torch.float32, torch.bfloat16):
                x = rng.standard_normal((m, k)).astype(np.float32)
                x[0] = 0.0
                x[:, -4] = np.abs(x[:, :-4]).max(axis=1) * 1.5  # the whole row's absmax
                x[:, -3:] = 0.0
                if dtype == torch.bfloat16:
                    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                ops = {"x": Operand(x, dtype, "float"),
                       "beta": Operand(np.array([0.037], np.float32), torch.float32, "float")}
                cases.append(KernelCase("act_quant", f"act_quant M={m} K={k} {str(dtype)[6:]} "
                                        "(a row shard + its absmax column)", ops, ("x", "beta"),
                                        {}, ("x", "beta"), {}))
    # decode rows, a verify round's rows of a data rank (2 slots x 5), a
    # prefill's and a 256-row chunk's
    for m in (2, 4, 10, 130, 256):
        for k, n, row in ((1536, 768, False), (1536, 2048, False), (768, 1536, True),
                          (2048, 1536, True)):
            # a row shard's B1 returns the rank's int32 partial: a unit scale
            scale = (np.ones((m, 1), np.float32) if row
                     else (rng.random((m, 1)) * 1e-3).astype(np.float32))
            ops = {"x_q": Operand(rng.integers(-127, 128, (m, k)).astype(np.int8), torch.int8,
                                  "int8"),
                   "w": Operand(rng.integers(0, 256, (k // 4, n)).astype(np.uint8), torch.uint8,
                                "packed"),
                   "scale": Operand(scale, torch.float32, "float")}
            cases.append(KernelCase("tlmm", f"tlmm M={m} K={k} N={n} (a model rank's "
                                    f"{'row' if row else 'column'} shard)", ops,
                                    ("x_q", "w", "scale"), {}, ("x_q", "w", "scale"), {}))
    for s_ in (65, 257):
        q, k, v = (rng.standard_normal((1, 12, s_, 64)).astype(np.float32) for _ in range(3))
        ops = {n: Operand(a, torch.float32, "float", extra_rows=EXTRA_ROWS)
               for n, a in (("q", q), ("k", k), ("v", v))}
        cases.append(KernelCase("prefill_attention", f"prefill H=12 Hkv=12 S={s_} D=64 (12 of "
                                "24 heads)", ops, ("q", "k", "v"), {}, ("q", "k", "v"), {}))
    hkv, half, d = 24, 48, 64
    for fmt in ("bf16", "int8", "int4"):
        quant = fmt != "bf16"
        kernel = "decode_attention_quant" if quant else "decode_attention"
        for lengths in ([0, half], [30, 0]):
            live = np.zeros((2, half), bool)
            for b_, n_ in enumerate(lengths):
                live[b_, :n_] = True
            dead = np.broadcast_to(~live[:, None, :], (2, hkv, half)).copy()
            ops = _walk_tensors(rng, (2, hkv, half), fmt, d, dead, EXTRA_ROWS)
            ops["q"] = Operand(rng.standard_normal((2, hkv, 1, d)).astype(np.float32),
                               torch.float32, "float")
            ops["lengths"] = Operand(np.array(lengths, np.int32), torch.int32, "index")
            label = f"{kernel} {fmt} D={d} G=1 Hkv={hkv} a sequence half of {half} lengths={lengths}"
            if quant:
                args = ("q", "k", "k_scale", "v", "v_scale", "lengths", None)
                plain = ("q", "k_r", "k_scale_r", "v_r", "v_scale_r", "lengths", None)
                cases.append(KernelCase(kernel, label, ops, args, {"kv_dtype": fmt}, plain,
                                        {"kv_dtype": fmt}, fp_elems=2 * hkv * half * d))
            else:
                cases.append(KernelCase(kernel, label, ops, ("q", "k", "v", "lengths", None), {},
                                        ("q", "k_r", "v_r", "lengths", None), {}))
    n_pages, bs = 8, PAGE
    tables = np.array([[3, 0, 6, 1], [5, 2, 7, 4]], np.int32)
    lengths = [37, 64]
    live = np.zeros((n_pages, bs), bool)
    for b_ in range(2):
        for pos in range(lengths[b_]):
            live[tables[b_, pos // bs], pos % bs] = True
    dead = np.broadcast_to(~live[:, None, :], (n_pages, hkv, bs)).copy()
    for fmt in ("bf16", "int8"):
        quant = fmt != "bf16"
        kernel = "paged_decode_attention_quant" if quant else "paged_decode_attention"
        ops = _walk_tensors(rng, (n_pages, hkv, bs), fmt, d, dead, EXTRA_ROWS)
        ops["q"] = Operand(rng.standard_normal((2, hkv, 1, d)).astype(np.float32),
                           torch.float32, "float")
        ops["tables"] = Operand(tables.copy(), torch.int32, "index")
        ops["lengths"] = Operand(np.array(lengths, np.int32), torch.int32, "index")
        label = f"{kernel} {fmt} D={d} G=1 Hkv={hkv} a data rank's 2 slots lengths={lengths}"
        if quant:
            args = ("q", "k", "k_scale", "v", "v_scale", "tables", "lengths", None)
            cases.append(KernelCase(kernel, label, ops, args, {"kv_dtype": fmt}, args,
                                    {"kv_dtype": fmt}, fp_elems=n_pages * hkv * bs * d))
        else:
            args = ("q", "k", "v", "tables", "lengths", None)
            cases.append(KernelCase(kernel, label, ops, args, {}, args, {}))
    cases += _granite_mesh_cases(rng, tables, lengths, live)
    cases += _split_pool_cases(rng)
    cases += _verify_mesh_cases(rng)
    cases += _family_mesh_cases(rng)
    return [c for c in cases if kernels is None or c.kernel in kernels]


# the other families served on a (data 2, model 2) mesh: hymba's windowed
# walk over a model rank's half of a 4,096-row cache (the prompts of 1,000
# to 4,000 tokens), whisper's self and cross walks over their halves, and
# hymba's long-context walk over a quarter of 524,288 rows
HYMBA_MESH_WALK = (5, 5, 64, 4096, 1024)  # Hkv, G, D, Smax, window
HYMBA_MESH_LENGTHS = [1000, 2048, 3000, 4000]
WHISPER_MESH = (20, 64, 1536, 1500)  # Hkv = H, D, cross rows, encoder_seq
WHISPER_SELF = (128, [70, 79])  # max_len, a data rank's 2 slots' lengths
LONG_MESH_ROWS = (524288, 4)  # the long_500k cache over data x model


def _window_half(lengths, starts, half: int, r: int):
    """Rank r's local (lengths, starts) of a walk from ``starts`` over the
    ``half`` rows [r * half, (r + 1) * half) it holds."""
    off = r * half
    return ([min(max(n - off, 0), half) for n in lengths],
            [min(max(a - off, 0), half) for a in starts])


def _family_mesh_cases(rng) -> List[KernelCase]:
    """The launches of hymba, xLSTM and whisper served on a (data 2, model
    2) mesh (xLSTM launches none): B3 over each model rank's half of
    hymba's 4,096-row cache from the window's start (Hkv 5, G 5, D 64,
    window 1,024; rank 0's half of the 4,000-token slot lies wholly before
    its window, rank 1's of the 1,000- and 2,048-token slots past their
    lengths), over whisper's cross halves (768 and 732 valid of 768 rows,
    the pad dead) and self halves (a data rank's 2 slots over 128 rows),
    B2 on 10 of whisper's 20 decoder heads, and B3 over the last quarter
    of hymba's 524,288-row long-context cache at batch 1."""
    cases = []

    def walk(label, hkv, g, d, rows, lengths, starts, slots):
        lo = [0] * len(lengths) if starts is None else starts
        live = np.zeros((slots, rows), bool)
        for b_, (a, n_) in enumerate(zip(lo, lengths)):
            live[b_, a:n_] = True
        dead = np.broadcast_to(~live[:, None, :], (slots, hkv, rows)).copy()
        ops = _walk_tensors(rng, (slots, hkv, rows), "bf16", d, dead, EXTRA_ROWS)
        ops["q"] = Operand(rng.standard_normal((slots, hkv, g, d)).astype(np.float32),
                           torch.float32, "float")
        ops["lengths"] = Operand(np.array(lengths, np.int32), torch.int32, "index")
        st = None
        if starts is not None:
            ops["starts"] = Operand(np.array(starts, np.int32), torch.int32, "index")
            st = "starts"
        cases.append(KernelCase("decode_attention", label, ops, ("q", "k", "v", "lengths", st),
                                {}, ("q", "k_r", "v_r", "lengths", st), {}))

    hkv, g, d, smax, window = HYMBA_MESH_WALK
    half = smax // 2
    starts = [max(0, n + 1 - window) for n in HYMBA_MESH_LENGTHS]
    for r in (0, 1):
        lens, st = _window_half(HYMBA_MESH_LENGTHS, starts, half, r)
        walk(f"decode_attention bf16 D={d} G={g} Hkv={hkv} hymba's window {window} over model "
             f"rank {r}'s half of {smax}: local lengths={lens} starts={st}",
             hkv, g, d, half, lens, st, len(lens))
    hkv, d, rows, enc = WHISPER_MESH
    for r in (0, 1):
        n_ = min(max(enc - r * rows // 2, 0), rows // 2)
        walk(f"decode_attention bf16 D={d} G=1 Hkv={hkv} whisper's cross half {r}: {n_} of "
             f"{rows // 2} rows", hkv, 1, d, rows // 2, [n_, n_], None, 2)
    max_len, lengths = WHISPER_SELF
    for r in (0, 1):
        lens, _ = _window_half(lengths, [0, 0], max_len // 2, r)
        walk(f"decode_attention bf16 D={d} G=1 Hkv={hkv} whisper's self half {r} of {max_len}: "
             f"local lengths={lens}", hkv, 1, d, max_len // 2, lens, None, 2)
    q, k, v = (rng.standard_normal((1, 10, 64, 64)).astype(np.float32) for _ in range(3))
    ops = {n: Operand(a, torch.float32, "float", extra_rows=EXTRA_ROWS)
           for n, a in (("q", q), ("k", k), ("v", v))}
    cases.append(KernelCase("prefill_attention", "prefill H=10 Hkv=10 S=64 D=64 (10 of "
                            "whisper's 20 decoder heads)", ops, ("q", "k", "v"), {},
                            ("q", "k", "v"), {}))
    hkv, g, d = HYMBA_MESH_WALK[:3]
    total, parts = LONG_MESH_ROWS
    quarter = total // parts
    n_ = total - 1 - (parts - 1) * quarter
    walk(f"decode_attention bf16 D={d} G={g} Hkv={hkv} hymba's long context, B=1: the last "
         f"quarter of {total} rows, local length {n_} of {quarter}", hkv, g, d, quarter, [n_],
         None, 1)
    return cases


VERIFY_ROWS = 5  # a verify block's rows a slot (spec_decode 4)


def _verify_mesh_cases(rng) -> List[KernelCase]:
    """The verify pass's walks on a mesh at bitnet-730m's widths
    (``rows_per_slot`` 5): B4 (int8) and B3 (bf16) over each sequence half
    of a data rank's 2 slots, each row at its local length, slot 0's block
    straddling the halves (global lengths 45-49 over halves of 48 rows);
    B6 (int8) and B5 (bf16) over a data rank's 2 slots' tables, each row
    5 times, into the whole pool; and on the pod split's decode rank (data
    1) B4 over a sequence half and B6 at 4 slots x 5 rows."""
    hkv, half, d, r = 24, 48, 64, VERIFY_ROWS
    cases = []

    def slot_walk(fmt, base, h, what):
        rows = [min(max(b + i - h * half, 0), half) for b in base for i in range(r)]
        slots = len(base)
        live = np.zeros((slots, half), bool)
        for j, n_ in enumerate(rows):
            live[j // r, :n_] = True
        dead = np.broadcast_to(~live[:, None, :], (slots, hkv, half)).copy()
        ops = _walk_tensors(rng, (slots, hkv, half), fmt, d, dead, EXTRA_ROWS)
        ops["q"] = Operand(rng.standard_normal((slots * r, hkv, 1, d)).astype(np.float32),
                           torch.float32, "float")
        ops["lengths"] = Operand(np.array(rows, np.int32), torch.int32, "index")
        quant = fmt != "bf16"
        kernel = "decode_attention_quant" if quant else "decode_attention"
        label = (f"{kernel} {fmt} D={d} G=1 Hkv={hkv} sequence half {h} of {half}, {what}, "
                 f"local lengths={rows} rows_per_slot={r}")
        if quant:
            args = ("q", "k", "k_scale", "v", "v_scale", "lengths", None)
            plain = ("q", "k_r", "k_scale_r", "v_r", "v_scale_r", "lengths", None)
            return KernelCase(kernel, label, ops, args, {"rows_per_slot": r, "kv_dtype": fmt},
                              plain, {"kv_dtype": fmt}, fp_elems=slots * hkv * half * d,
                              repeat=r)
        return KernelCase(kernel, label, ops, ("q", "k", "v", "lengths", None),
                          {"rows_per_slot": r}, ("q", "k_r", "v_r", "lengths", None), {},
                          repeat=r)

    for fmt in ("int8", "bf16"):
        for h in (0, 1):
            cases.append(slot_walk(fmt, [45, 10], h, "a data rank's 2 slots x 5 verify rows"))
    cases.append(slot_walk("int8", [0, 45, 60, 20], 1,
                           "4 slots x 5 verify rows (the split's decode rank)"))

    def paged_walk(fmt, tables, lens, what):
        n_pages, bs = int(tables.max()) + 1, PAGE
        live = np.zeros((n_pages, bs), bool)
        for b_ in range(len(lens)):
            for pos in range(lens[b_] + r - 1):
                live[tables[b_, pos // bs], pos % bs] = True
        dead = np.broadcast_to(~live[:, None, :], (n_pages, hkv, bs)).copy()
        ops = _walk_tensors(rng, (n_pages, hkv, bs), fmt, d, dead, EXTRA_ROWS)
        rows = [b + i for b in lens for i in range(r)]
        ops["q"] = Operand(rng.standard_normal((len(rows), hkv, 1, d)).astype(np.float32),
                           torch.float32, "float")
        ops["tables"] = Operand(np.repeat(tables, r, axis=0), torch.int32, "index")
        ops["lengths"] = Operand(np.array(rows, np.int32), torch.int32, "index")
        quant = fmt != "bf16"
        kernel = "paged_decode_attention_quant" if quant else "paged_decode_attention"
        label = (f"{kernel} {fmt} D={d} G=1 Hkv={hkv} {what}, each table row {r} times, "
                 f"lengths={rows} over the whole pool")
        if quant:
            args = ("q", "k", "k_scale", "v", "v_scale", "tables", "lengths", None)
            return KernelCase(kernel, label, ops, args, {"kv_dtype": fmt}, args,
                              {"kv_dtype": fmt}, fp_elems=n_pages * hkv * bs * d)
        args = ("q", "k", "v", "tables", "lengths", None)
        return KernelCase(kernel, label, ops, args, {}, args, {})

    two = rng.permutation(8).astype(np.int32).reshape(2, 4)
    for fmt in ("int8", "bf16"):
        cases.append(paged_walk(fmt, two, [37, 12], "a data rank's 2 slots x 5 verify rows"))
    four = rng.permutation(16).astype(np.int32).reshape(4, 4)
    cases.append(paged_walk("int8", four, [5, 59, 33, 1],
                            "4 slots x 5 verify rows (the split's decode rank)"))
    return cases


def _split_pool_cases(rng) -> List[KernelCase]:
    """A decode rank's walks on the pod split of the disaggregated pools,
    (pod 2, data 1, model 2) at bitnet-730m's widths: B3 over a sequence
    half at the pool's 4 slots (data 1: every slot on every rank), an
    empty slot and a full half among them; B6 over 4 slots' tables into
    the decode pool's whole int8 pages."""
    hkv, half, d = 24, 48, 64
    cases = []
    lens = [0, 30, half, 17]
    live = np.zeros((4, half), bool)
    for b_, n_ in enumerate(lens):
        live[b_, :n_] = True
    dead = np.broadcast_to(~live[:, None, :], (4, hkv, half)).copy()
    ops = _walk_tensors(rng, (4, hkv, half), "bf16", d, dead, EXTRA_ROWS)
    ops["q"] = Operand(rng.standard_normal((4, hkv, 1, d)).astype(np.float32), torch.float32,
                       "float")
    ops["lengths"] = Operand(np.array(lens, np.int32), torch.int32, "index")
    cases.append(KernelCase("decode_attention", f"decode_attention bf16 D={d} G=1 Hkv={hkv} a "
                            f"sequence half of {half}, 4 slots lengths={lens} (the split's "
                            "decode pool)", ops, ("q", "k", "v", "lengths", None), {},
                            ("q", "k_r", "v_r", "lengths", None), {}))
    n_pages, bs = 16, PAGE
    tables = rng.permutation(n_pages).astype(np.int32).reshape(4, 4)
    lens = [5, 64, 33, 0]
    page_live = np.zeros((n_pages, bs), bool)
    for b_ in range(4):
        for pos in range(lens[b_]):
            page_live[tables[b_, pos // bs], pos % bs] = True
    dead = np.broadcast_to(~page_live[:, None, :], (n_pages, hkv, bs)).copy()
    ops = _walk_tensors(rng, (n_pages, hkv, bs), "int8", d, dead, EXTRA_ROWS)
    ops["q"] = Operand(rng.standard_normal((4, hkv, 1, d)).astype(np.float32), torch.float32,
                       "float")
    ops["tables"] = Operand(tables, torch.int32, "index")
    ops["lengths"] = Operand(np.array(lens, np.int32), torch.int32, "index")
    args = ("q", "k", "k_scale", "v", "v_scale", "tables", "lengths", None)
    cases.append(KernelCase("paged_decode_attention_quant", f"paged_decode_attention_quant int8 "
                            f"D={d} G=1 Hkv={hkv} 4 slots lengths={lens} over the whole pool "
                            "(the split's decode pool, data 1)", ops, args, {"kv_dtype": "int8"},
                            args, {"kv_dtype": "int8"}, fp_elems=n_pages * hkv * bs * d))
    return cases


def _granite_mesh_cases(rng, tables, lengths, page_live) -> List[KernelCase]:
    """granite-moe-3b-a800m's launches on a rank of a (data 2, model 2)
    mesh: 24 heads over 8 KV heads (G = 3) of 64."""
    cases = []
    for s_ in (65, 257):
        q = rng.standard_normal((1, 12, s_, 64)).astype(np.float32)
        k, v = (rng.standard_normal((1, 4, s_, 64)).astype(np.float32) for _ in range(2))
        ops = {n: Operand(a, torch.float32, "float", extra_rows=EXTRA_ROWS)
               for n, a in (("q", q), ("k", k), ("v", v))}
        cases.append(KernelCase("prefill_attention", f"prefill H=12 Hkv=4 S={s_} D=64 (granite: "
                                "12 of 24 heads)", ops, ("q", "k", "v"), {}, ("q", "k", "v"), {}))
    hkv, g, half, d = 8, 3, 48, 64
    for lens in ([0, half], [30, 0]):
        live = np.zeros((2, half), bool)
        for b_, n_ in enumerate(lens):
            live[b_, :n_] = True
        dead = np.broadcast_to(~live[:, None, :], (2, hkv, half)).copy()
        ops = _walk_tensors(rng, (2, hkv, half), "bf16", d, dead, EXTRA_ROWS)
        ops["q"] = Operand(rng.standard_normal((2, hkv, g, d)).astype(np.float32), torch.float32,
                           "float")
        ops["lengths"] = Operand(np.array(lens, np.int32), torch.int32, "index")
        cases.append(KernelCase("decode_attention", f"decode_attention bf16 D={d} G={g} "
                                f"Hkv={hkv} a sequence half of {half} lengths={lens} (granite)",
                                ops, ("q", "k", "v", "lengths", None), {},
                                ("q", "k_r", "v_r", "lengths", None), {}))
    n_pages, bs = page_live.shape
    dead = np.broadcast_to(~page_live[:, None, :], (n_pages, hkv, bs)).copy()
    ops = _walk_tensors(rng, (n_pages, hkv, bs), "int8", d, dead, EXTRA_ROWS)
    ops["q"] = Operand(rng.standard_normal((2, hkv, g, d)).astype(np.float32), torch.float32,
                       "float")
    ops["tables"] = Operand(tables.copy(), torch.int32, "index")
    ops["lengths"] = Operand(np.array(lengths, np.int32), torch.int32, "index")
    args = ("q", "k", "k_scale", "v", "v_scale", "tables", "lengths", None)
    cases.append(KernelCase("paged_decode_attention_quant", f"paged_decode_attention_quant int8 "
                            f"D={d} G={g} Hkv={hkv} a data rank's 2 slots lengths={lengths} "
                            "(granite)", ops, args, {"kv_dtype": "int8"}, args,
                            {"kv_dtype": "int8"}, fp_elems=n_pages * hkv * bs * d))
    return cases


def device_cases(kernels: Optional[Sequence[str]] = None) -> List[KernelCase]:
    """The card half's case grid, restricted to ``kernels`` when given."""
    cases = (_act_quant_cases() + _tlmm_cases() + _prefill_cases() + _slot_cases()
             + _paged_cases())
    return [c for c in cases if kernels is None or c.kernel in kernels]


def _live(op: Operand, t: torch.Tensor) -> torch.Tensor:
    """The operand's own rows of its full contents."""
    return t[:, :, :op.data.shape[2]] if op.extra_rows else t


def _plain_named(case: KernelCase, fill: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The plain version's operands on the CPU: live data, 0 (or junk of
    ``fill``) where dead, and for verify rows each slot's planes repeated
    for its rows."""
    named = {n: _live(op, _host(op, fill)) for n, op in case.operands.items()}
    for n in ("k", "v", "k_scale", "v_scale"):
        if n in named:
            named[n + "_r"] = (named[n].repeat_interleave(case.repeat, 0) if case.repeat > 1
                               else named[n])
    return named


def _max_err(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor],
             kernel: str) -> float:
    """B1 and act-quant: 0 when bit-equal, else inf; B2: the largest
    difference; the walks: the largest of out's and m's differences and
    l's relative one."""
    if kernel == "prefill_attention":
        return (got[0].cpu() - want[0]).abs().max().item()
    if kernel in ("act_quant", "tlmm"):
        same = all(g.shape == w.shape and torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))
        return 0.0 if same else float("inf")
    out, l, m = (t.cpu() for t in got)
    out_r, l_r, m_r = want
    return max((out - out_r).abs().max().item(), (m - m_r).abs().max().item(),
               ((l - l_r).abs() / l_r.clamp(min=1.0)).max().item())


def against_f64(got: torch.Tensor, want: torch.Tensor,
                exact: torch.Tensor) -> Tuple[float, float]:
    """B2's result's largest difference from ``exact`` (its plain version
    in f64), and the limit it is held to: TOL, or ``WITNESS`` times the f32
    plain version ``want``'s own difference from ``exact`` where larger."""
    witness = (want.double() - exact).abs().max().item()
    return ((got.cpu().double() - exact).abs().max().item(),
            max(TOL["prefill_attention"], WITNESS * witness))


def run_case(case: KernelCase, fn: Callable, plain: Callable, device,
             where: Tuple[str, int], errors: Optional[Dict[str, float]] = None) -> List[Finding]:
    """One case on the card, twice (fillings a and b), against its plain
    version on the CPU; ``errors`` keeps each kernel's largest difference
    (and B2's from f64, with the largest share of its limit)."""
    rel, line = where
    found: List[Finding] = []

    def emit(rule, msg):
        found.append(Finding(PASS, rule, rel, line, f"{case.label}: {msg}", scope=case.kernel))

    try:
        host = _plain_named(case)
        want = _results(plain(*_resolve(case.plain_args, host),
                              **_resolve_kw(case.plain_kwargs, host)))
        if case.kernel == "prefill_attention":
            exact = plain(*(t.double() for t in _resolve(case.plain_args, host)))
    except Exception as e:  # noqa: BLE001 — a finding, not a crash
        emit("kernel:eval-error", f"the plain version raised {e!r}")
        return found
    runs = []
    for fill in ("a", "b"):
        placed = {n: _place(op, fill, device) for n, op in case.operands.items()}
        for _, g in placed.values():
            g.snapshot()
        named = {n: t for n, (t, _) in placed.items()}
        mode = _GuardedOutputs()
        try:
            with torch.no_grad(), mode:
                got = _results(fn(*_resolve(case.args, named), **_resolve_kw(case.kwargs, named)))
            torch.cuda.synchronize(device)
        except Exception as e:  # noqa: BLE001
            emit("kernel:eval-error", f"the launch raised {e!r} (filling {fill})")
            return found
        if not all(g.pads_hold(OUT_SENTINEL) for g in mode.outputs):
            emit("kernel:oob-write", f"an output's guard band changed (filling {fill})")
        if not all(g.unchanged() for _, g in placed.values()):
            emit("kernel:oob-write", f"an input's bytes changed (filling {fill})")
        runs.append([t.clone() for t in got])
    a, b = runs
    floats = [t for t in a if t.dtype.is_floating_point]
    if any(not torch.isfinite(t).all() for t in floats) and all(
            torch.isfinite(w).all() for w in want if w.dtype.is_floating_point):
        emit("kernel:oob-read", "NaN in the result: it read a pad or a dead row")
    elif not all(torch.equal(x, y) for x, y in zip(a, b)):
        emit("kernel:oob-read", "the result changed with what the pads and dead rows hold")
    err = _max_err(a, want, case.kernel)
    limit = TOL[case.kernel]
    if errors is not None:
        errors[case.kernel] = max(errors.get(case.kernel, 0.0), err)
    if case.kernel == "prefill_attention":
        err, limit = against_f64(a[0], want[0], exact)
        if errors is not None:
            for key, v in (("prefill_attention vs f64", err),
                           ("prefill_attention share of its limit", err / limit)):
                errors[key] = max(errors.get(key, 0.0), v)
    if not err <= limit:
        what = "an f64 evaluation" if case.kernel == "prefill_attention" else "its plain version"
        emit("kernel:mismatch", f"{err:.3g} off {what}, beyond its limit {limit:.3g}")
    if case.fp_elems is not None:
        found += check_fp_alloc(case, device, where)
    return found


def check_fp_alloc(case: KernelCase, device, where: Tuple[str, int]) -> List[Finding]:
    """``kernel:fp-cache-alloc``: the quantized entry point (the op the
    model calls, ``decode_attention`` / ``paged_decode_attention``) over the
    case's operands under a dispatch recorder."""
    from repro_torch.analysis.progcheck import OpRecorder
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention

    named = {n: _live(op, _host(op, None).to(device)) for n, op in case.operands.items()}
    q = named["q"]
    b, hkv, g, d = q.shape
    qf = q.reshape(b, hkv * g, d)
    kw = dict(k_scales=named["k_scale"], v_scales=named["v_scale"], kv_dtype=case.kwargs["kv_dtype"],
              starts=named.get("starts"))
    rec = OpRecorder()
    with torch.no_grad(), rec:
        if "tables" in named:
            paged_decode_attention(qf, named["k"], named["v"], named["tables"], named["lengths"],
                                   **kw)
        else:
            decode_attention(qf, named["k"], named["v"], named["lengths"],
                             rows_per_slot=case.kwargs.get("rows_per_slot", 1), **kw)
    big = rec.f32_at_least(case.fp_elems)
    if not big:
        return []
    rel, line = where
    op, shape = big[0]
    return [Finding(PASS, "kernel:fp-cache-alloc", rel, line,
                    f"{case.label}: {op} allocates f32 {shape} (>= one dequantized KV operand, "
                    f"{case.fp_elems} elements) — the dequant belongs to the tile",
                    scope=case.kernel)]


# ---------------------------------------------------- CPU: plain contracts --

def check_contracts(plains: Optional[Dict[str, Callable]] = None,
                    root: Optional[Path] = None) -> Tuple[List[Finding], int]:
    """The plain versions' contracts at the grid's extremes (the CPU half):
    (findings, checks made).  ``plains`` overrides the plain versions."""
    from repro_torch.kernels.tlmm.ref import tlmm_lut_reference

    plains = dict(_plains(), **(plains or {}))
    where = {k: _where(fn, root) for k, fn in _wrappers().items()}
    found: List[Finding] = []
    n = 0

    def emit(kernel, rule, label, msg):
        rel, line = where[kernel]
        found.append(Finding(PASS, rule, rel, line, f"{label}: {msg}", scope=kernel))

    def call(case, named, fn):
        return _results(fn(*_resolve(case.plain_args, named),
                           **_resolve_kw(case.plain_kwargs, named)))

    for case in device_cases():
        n += 1
        fn = plains[case.kernel]
        try:
            named = _plain_named(case)
            base = call(case, named, fn)
            if case.kernel == "tlmm":
                lut = tlmm_lut_reference(named["x_q"], named["w"], named["scale"])
                if not torch.equal(base[0], lut):
                    emit("tlmm", "kernel:contract", case.label,
                         "the plain product differs from the table-lookup algorithm")
            elif case.kernel == "act_quant":
                x_q, scale = base
                if not (torch.isfinite(scale).all() and (scale > 0).all()
                        and x_q.abs().max() <= 127 and (x_q[0] == 0).all()):
                    emit("act_quant", "kernel:contract", case.label,
                         "scales must be finite and positive, |x_q| <= 127, a zero row 0")
            elif case.kernel == "prefill_attention":
                s = case.operands["q"].data.shape[2]
                r = max(1, s // 2)
                junk = dict(named)
                for nm in ("q", "k", "v"):
                    junk[nm] = named[nm].clone()
                    junk[nm][:, :, r:] = 0.5
                got = call(case, junk, fn)
                if not torch.equal(got[0][:, :, :r], base[0][:, :, :r]):
                    emit(case.kernel, "kernel:contract", case.label,
                         f"rows past {r} changed the first {r} rows: the causal mask leaks")
            else:
                # finite junk where the operands are dead, and (paged) the
                # tables clipped by hand: the same result
                got = call(case, _plain_named(case, "b"), fn)
                if not all(torch.equal(x, y) for x, y in zip(got, base)):
                    emit(case.kernel, "kernel:contract", case.label,
                         "positions outside [start, length) changed the result: a mask leaks")
                if "tables" in named:
                    n_pages = case.operands["k"].data.shape[0]
                    clip = dict(named)
                    clip["tables"] = named["tables"].clamp(0, n_pages - 1)
                    got = call(case, clip, fn)
                    if not all(torch.equal(x, y) for x, y in zip(got, base)):
                        emit(case.kernel, "kernel:contract", case.label,
                             f"table ids outside [0, {n_pages - 1}] are not clipped")
        except Exception as e:  # noqa: BLE001
            emit(case.kernel, "kernel:eval-error", case.label,
                 f"the plain version raised {e!r}")
    return found, n


# ---------------------------------------------------------------- the pass --

def run(root: Path, subset: Optional[Sequence[str]] = None, *, device: str = "cpu",
        kernels: Optional[Sequence[str]] = None,
        stats: Optional[Dict[str, int]] = None) -> List[Finding]:
    """The kernel pass.  The CPU half always; with ``device="cuda"`` the
    card half over the case grid (``kernels`` restricts it).  ``root``
    relativizes the reported paths (the kernels checked are the imported
    ones).  ``stats`` receives the counts of launches, contract checks and
    card cases made."""
    where = {k: _where(fn, root) for k, fn in _wrappers().items()}
    found, n_launches = check_registry(where)
    contract, n_contract = check_contracts(root=root)
    found += contract
    n_cases = 0
    errors: Dict[str, float] = {}
    if device == "cuda":
        wrappers, plains = _wrappers(), _plains()
        dev = torch.device("cuda")
        for case in device_cases(kernels) + mesh_cases(kernels):
            n_cases += 1
            found += run_case(case, wrappers[case.kernel], plains[case.kernel], dev,
                              where[case.kernel], errors)
    if stats is not None:
        stats.update(launches=n_launches, contracts=n_contract, cases=n_cases,
                     max_err=errors)
    return found


def main(argv=None) -> int:
    """``python -m repro_torch.analysis.kernel_check [--device cuda]
    [--kernels a,b]``: the kernel pass alone, for a run under a sanitizer."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.kernel_check")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--kernels", default=None,
                    help=f"comma-separated launches of the card half: {', '.join(LAUNCHES)}")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",") if args.kernels else None
    stats: Dict[str, int] = {}
    found = run(Path(__file__).resolve().parents[1], device=args.device, kernels=kernels,
                stats=stats)
    for f in found:
        print(f"  {f.render()}")
    print(f"kernel pass: {stats['cases']} card cases, {stats['contracts']} contract checks, "
          f"{stats['launches']} launch shapes, {len(found)} findings; largest difference from "
          f"the plain version: {stats['max_err']}")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
