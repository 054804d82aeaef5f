"""Analytic cost models of the port's CUDA kernels, at their Hopper tiles.

The port of the JAX package's ``repro.kernels.costs``.  Each function
writes down one launch's work and traffic from its shapes and the tile
constants of its source in ``csrc/``, so that nothing has to run to know
them:

* ``flops``: the operations of the function (2 a multiply-add), whatever
  implements it;
* ``hbm_bytes``: the device-memory traffic the kernel's tiles imply
  (operands a tile re-reads are counted each time, as if no cache held
  them);
* ``smem_bytes``: the shared memory one block takes, static and dynamic
  (the counterpart of the TPU kernels' VMEM working set);
* ``min_bytes``: each operand read once and each result written once:
  the bytes of the function, whatever implements it;
* ``cluster``: the blocks of a thread-block cluster (1 without one).

``min_bytes`` and ``flops`` give the least time the card can take (the
bound in ``chip_smoke.py``); ``smem_bytes`` and ``cluster`` are what the
``kernel`` analysis pass holds to the card's limits.  The mLSTM and sLSTM
models are the JAX package's analytic models, kept as they are: the port
runs those layers in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

SMEM_PER_BLOCK = 227 * 1024  # shared memory one block can use on sm_90
MAX_CLUSTER = 8  # the portable limit on a thread-block cluster's blocks
SMS = 132  # streaming multiprocessors of the H100 SXM


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float  # operations of the function
    hbm_bytes: float  # device-memory traffic of the kernel's tiles
    smem_bytes: int  # shared memory a block takes
    min_bytes: float  # each operand read once, each result written once
    cluster: int = 1  # blocks of a cluster

    def __add__(self, other: "KernelCost") -> "KernelCost":
        return KernelCost(self.flops + other.flops, self.hbm_bytes + other.hbm_bytes,
                          max(self.smem_bytes, other.smem_bytes),
                          self.min_bytes + other.min_bytes, max(self.cluster, other.cluster))


ZERO = KernelCost(0.0, 0.0, 0, 0.0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- csrc/tlmm.cu --

AQ_THREADS = 256  # kAqThreads
SPLIT_COLS = 64  # kSmallCols: the split-K kernel's column tile
SPLIT_THREADS = 128  # kSmallThreads
SPLIT_X_WORDS = 2048  # kSmallXWords: x_q words of a block's K range, all rows
MMA_BN, MMA_BK = 128, 64  # kBN, kBK: the tensor-core kernel's column tile and K step


def tlmm_split(m: int, k: int, n: int) -> Optional[int]:
    """The K split of the cluster kernel ``tlmm_launch`` picks for M <= 8
    (4 or 8 blocks a cluster), or None where it runs the tensor-core kernel
    (``csrc/tlmm.cu`` ``tlmm_launch``)."""
    kw = k // 4
    if m <= 8 and m * _cdiv(kw, 8) <= SPLIT_X_WORDS:
        cols = _cdiv(n, SPLIT_COLS)
        four = cols * 4 >= SMS and kw // 4 >= 96 and m * (kw // 4 + 1) <= SPLIT_X_WORDS
        return 4 if four else 8
    return None


def tlmm_mma_rows(m: int, n: int) -> int:
    """Rows of the tensor-core kernel's block tile: 128 where that still
    gives a full wave of blocks, else 64."""
    return 128 if _cdiv(m, 128) * _cdiv(n, MMA_BN) >= SMS else 64


def tlmm_cost(m: int, k: int, n: int) -> KernelCost:
    """B1: y (M,N) f32 = (x_q (M,K) int8 @ unpack(w (K/4,N) uint8)) * scale
    (M,).  M <= 8: the split-K cluster kernel, a 64-column tile a block and
    K split over the cluster's blocks, so every column tile reads all of
    x_q; larger M: the int8 tensor-core kernel, whose (64 or 128) x 128
    tiles re-read x_q once a column tile and the packed weight once a row
    tile."""
    kw = k // 4
    split = tlmm_split(m, k, n)
    flops = 2.0 * m * k * n
    min_bytes = m * k + kw * n + m * 4 + m * n * 4
    if split is not None:
        tiles_n = _cdiv(n, SPLIT_COLS)
        hbm = tiles_n * m * k + kw * n + tiles_n * m * 4 + m * n * 4
        # xs, the warps' partial tiles, the block's partial tile
        smem = 4 * SPLIT_X_WORDS + 4 * (SPLIT_THREADS // 32) * m * SPLIT_COLS + 4 * m * SPLIT_COLS
        return KernelCost(flops, float(hbm), smem, float(min_bytes), split)
    bm = tlmm_mma_rows(m, n)
    tiles_n, tiles_m = _cdiv(n, MMA_BN), _cdiv(m, bm)
    hbm = tiles_n * m * k + tiles_m * kw * n + tiles_n * m * 4 + m * n * 4
    # x_q and packed tiles twice (rows padded by 16 bytes), the decoded tile
    smem = 2 * bm * (MMA_BK + 16) + 2 * (MMA_BK // 4) * (MMA_BN + 16) + 4 * (MMA_BK // 4) * (MMA_BN + 8)
    return KernelCost(flops, float(hbm), smem, float(min_bytes))


def act_quant_cost(m: int, k: int, *, elt: int = 4) -> KernelCost:
    """The per-token int8 quantization before each B1: x (M,K) f32 (elt 4)
    or bf16 (elt 2) -> x_q int8 and the folded scale.  One block a row
    reads the row twice (the absmax, then the quantizing pass) and beta
    once; two operations an element (|x| and the max; the divide and the
    round), none on the tensor cores."""
    return KernelCost(2.0 * m * k, float(2 * m * k * elt + m * 4 + m * k + m * 4),
                      4 * (AQ_THREADS // 32), float(m * k * elt + 4 + m * k + m * 4))


# ---------------------------------------------------- csrc/prefill_attention.cu --

PREFILL_BQ = 64  # kBQ: query rows of a block
PREFILL_THREADS = 128  # kThreads
PREFILL_HEAD_DIMS = (32, 64, 128)


def prefill_kv_rows(d: int, s: int) -> int:
    """KV rows of a tile, as ``prefill_attention_launch`` picks them: 64 at
    D = 32 and at D = 64 up to S = 512, else 32."""
    if d == 32 or (d == 64 and s <= 512):
        return 64
    return 32


def prefill_smem_bytes(d: int, bkv: int) -> int:
    """``smem_bytes<D, BKV>()``: Q, and K and V twice, rows of D + 4 words."""
    return (PREFILL_BQ + 4 * bkv) * (d + 4) * 4


def prefill_attention_cost(b: int, h: int, hkv: int, s: int, d: int, *, elt: int = 4,
                           causal: bool = True, window: Optional[int] = None,
                           skv: Optional[int] = None) -> KernelCost:
    """B2: out (B,H,S,D) = softmax(q k^T) v over k/v (B,Hkv,S,D), causal,
    GQA head h reading KV head h // (H/Hkv).  ``flops`` counts the scores
    each query row needs (q + 1 keys when causal; ``window`` caps it and
    ``skv`` gives a rectangular q-against-skv walk, as in the JAX model),
    two products of D each.  The kernel runs a 64-row query tile a block;
    a tile walks the KV tiles from 0 to its diagonal, each K and V tile
    read once a query head (GQA heads re-read their KV head's tiles)."""
    skv = s if skv is None else skv
    if causal and skv == s:
        keys = (s + 1) / 2
    else:
        keys = float(skv)
    if window is not None and window < skv:
        keys = min(keys, window + 1.0)
    flops = 4.0 * b * h * d * s * keys
    min_bytes = (2 * b * h * s * d + 2 * b * hkv * skv * d) * elt
    bkv = prefill_kv_rows(d, s)
    rows = 0
    for i in range(_cdiv(s, PREFILL_BQ)):
        last = min((i + 1) * PREFILL_BQ, s)
        if causal and skv == s:
            reach = last if window is None else min(last, window + PREFILL_BQ)
        else:
            reach = skv if window is None else min(skv, window + PREFILL_BQ)
        rows += min(_cdiv(reach, bkv) * bkv, skv)
    hbm = (2 * b * h * s * d + 2 * b * h * rows * d) * elt
    return KernelCost(flops, float(hbm), prefill_smem_bytes(d, bkv), float(min_bytes))


# ---------------------------------------------------------- csrc/paged_walk.cuh --

WALK_CLUSTER = 8  # kCluster
WALK_WARPS = 4  # kWarps
WALK_CHUNK_ROWS = 64  # kChunkRows
WALK_RING_BYTES = 26 * 1024  # kRingBytes
WALK_MAX_CHUNKS = 8  # kMaxChunks
WALK_SLOT_PAGE = 16  # kSlotPage: rows of a contiguous slot's virtual page
WALK_HEAD_DIMS = (32, 64, 128)
WALK_MAX_GROUP = 8
FP_ELT = {"bf16": 2, "f32": 4}


def walk_row_bytes(kv_dtype: str, d: int, elt: int = 2) -> int:
    """Bytes of one staged row: the payload (``Slice<Fmt, D>::kRowBytes``)."""
    if kv_dtype == "fp":
        return elt * d
    return d // 2 if kv_dtype == "int4" else d


def walk_chunk_bytes(kv_dtype: str, d: int, rows: int, elt: int = 2) -> int:
    """``chunk_bytes<Fmt, D>(rows)``: K rows, V rows, then their scales."""
    scales = (8 * rows + 15) // 16 * 16 if kv_dtype != "fp" else 0
    return 2 * rows * walk_row_bytes(kv_dtype, d, elt) + scales


def walk_chunk_pages(kv_dtype: str, d: int, bs: int, elt: int = 2) -> int:
    """``chunk_pages<Fmt, D>(bs)``: whole pages, at most 64 rows, two chunks
    within the ring."""
    cp = WALK_CHUNK_ROWS // bs if bs < WALK_CHUNK_ROWS else 1
    while cp > 1 and 2 * walk_chunk_bytes(kv_dtype, d, cp * bs, elt) > WALK_RING_BYTES:
        cp -= 1
    return cp


def walk_max_group(g: int) -> int:
    """The query-group bound ``dispatch`` instantiates for G."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def walk_smem_bytes(kv_dtype: str, d: int, g: int, cap: int, *, paged: bool,
                    bs: int = WALK_SLOT_PAGE, elt: int = 2) -> int:
    """Shared memory of one walk block, as ``paged_walk::launch`` sizes it:
    the merge's and q's static arrays, the barriers, the ring of staged
    chunks (2 to 8 within ``kRingBytes``, no more than a rank uses) and, when
    paged, the rank's table entries.  ``cap``: positions a sequence can
    hold (P * bs paged, the slot's S contiguous)."""
    maxg = walk_max_group(g)
    static = (4 * (WALK_WARPS + 1) * maxg * (d + 2) + 4 * (maxg * d if d == 32 else 4)
              + 8 * WALK_MAX_CHUNKS + 64)
    cp = walk_chunk_pages(kv_dtype, d, bs, elt)
    cb = walk_chunk_bytes(kv_dtype, d, cp * bs, elt)
    per_max = _cdiv(_cdiv(cap, bs), WALK_CLUSTER)
    table = 4 * max(per_max, 1) if paged else 0
    used = _cdiv(per_max, cp) + 1
    chunks = min(max(WALK_RING_BYTES // cb, 2), WALK_MAX_CHUNKS)
    if chunks > used:
        chunks = max(used, 2)
    while chunks > 2 and chunks * cb + table + static > SMEM_PER_BLOCK:
        chunks -= 1
    return chunks * cb + table + static


def decode_attention_cost(lengths: Sequence[int], hkv: int, g: int, d: int, *,
                          starts: Optional[Sequence[int]] = None, kv_dtype: str = "fp",
                          elt: int = 2, paged: bool = False, bs: int = WALK_SLOT_PAGE,
                          cap: Optional[int] = None, rows_per_slot: int = 1) -> KernelCost:
    """B3-B6, the decode walks: query row b (G heads over each of Hkv KV
    heads) attends positions [starts[b], lengths[b]) of its slot (row b
    reads slot b // ``rows_per_slot``) or of its block table's pages
    (``paged``; table rows ``rows_per_slot`` apart repeat one sequence's).
    ``kv_dtype`` fp reads ``elt``-byte elements (2 bf16, 4 f32); int8 and
    int4 read packed payload plus an f32 scale a row.  ``cap`` (positions a
    sequence can hold: the slot's S, or P * bs) sizes the ring and the
    table; it defaults to the longest length.

    ``min_bytes`` reads each slot's rows once (the union of its query
    rows' ranges), with the table entries that find them, q, lengths and
    starts, and writes out, l and m.  ``hbm_bytes`` is what the clusters
    move: each query row's cluster reads its own range (whole pages when
    paged, exact rows from a slot), q once a rank, and its table entries
    once a KV head."""
    n_rows = len(lengths)
    lo = [0] * n_rows if starts is None else [max(int(x), 0) for x in starts]
    cap = max(int(x) for x in lengths) if cap is None else cap
    hi = [min(int(x), cap) for x in lengths]
    live = [max(0, h_ - l_) for l_, h_ in zip(lo, hi)]
    row = walk_row_bytes(kv_dtype, d, elt) + (4 if kv_dtype != "fp" else 0)
    flops = 4.0 * g * d * hkv * sum(live)

    small_in = n_rows * hkv * g * d * 4 + n_rows * 4 * (1 if starts is None else 2)
    small_out = n_rows * hkv * g * (d + 2) * 4
    slot_rows, slot_pages = 0, 0
    for s0 in range(0, n_rows, rows_per_slot):
        spans = [(lo[i], hi[i]) for i in range(s0, min(s0 + rows_per_slot, n_rows))
                 if hi[i] > lo[i]]
        if spans:
            a, z = min(x for x, _ in spans), max(y for _, y in spans)
            slot_rows += z - a
            slot_pages += _cdiv(z, bs) - a // bs
    min_bytes = 2 * hkv * row * slot_rows + small_in + small_out + (4 * slot_pages if paged else 0)

    hbm = WALK_CLUSTER * n_rows * hkv * g * d * 4 + WALK_CLUSTER * n_rows * 4 + small_out
    for l_, h_ in zip(lo, hi):
        if h_ <= l_:
            continue
        if paged:
            pages = _cdiv(h_, bs) - l_ // bs
            hbm += hkv * (2 * pages * bs * row + 4 * pages)
        else:
            hbm += 2 * hkv * (h_ - l_) * row
    smem = walk_smem_bytes(kv_dtype, d, g, cap, paged=paged, bs=bs if paged else WALK_SLOT_PAGE,
                           elt=elt)
    return KernelCost(flops, float(hbm), smem, float(min_bytes), WALK_CLUSTER)


# --------------------------------------------- the JAX package's recurrent models --

def mlstm_chunk_cost(b: int, h: int, s: int, hd: int, *, chunk: int = 64,
                     elt: int = 2) -> KernelCost:
    """The chunkwise-parallel mLSTM (the xlstm prefill), the JAX model: grid
    (b, h, s/chunk) sequential over chunks; q/k/v chunk tiles stream in,
    the (hd, hd) matrix memory and its normalizer stay on chip, h streams
    out.  A chunk: qk (c x c x hd), the weighted PV (c x c x hd), the state
    update and the query-state product (c x hd x hd)."""
    nc = max(s // chunk, 1)
    io = 4 * b * h * s * hd * elt
    flops = b * h * nc * (4 * chunk * chunk * hd + 4 * chunk * hd * hd)
    on_chip = (hd * hd * 4 + 2 * hd * 4 + 3 * 2 * chunk * hd * elt + chunk * chunk * 4
               + chunk * hd * 4)
    return KernelCost(flops, float(io), on_chip, float(io))


def slstm_scan_cost(b: int, s: int, d: int, h: int, *, elt: int = 2) -> KernelCost:
    """The sequential sLSTM, the JAX model: the (B,S,4d) pre-activations read
    once, the per-head recurrent state on chip, (B,S,d) h written out;
    R h (hd x 4hd a head) and the gates' elementwise work a step."""
    hd = d // h
    io = b * s * (4 * d + d) * elt
    flops = b * s * h * (2 * hd * 4 * hd) + 10.0 * b * s * d
    on_chip = h * hd * 4 * 4 + 4 * d * elt * 2 + h * hd * 4 * hd * elt
    return KernelCost(flops, float(io), on_chip, float(io))
