// The decode walk of B3-B6: the attention of one query token per sequence
// over one layer's KV cache, as a thread-block cluster that splits the
// positions.  decode_attention.cu (B3, B4) walks the contiguous cache,
// paged_attention.cu (B5, B6) the paged pool; both launch this template.
//
// For each sequence b and KV head hk, the walk computes the attention of
// the G grouped query heads q (B,Hkv,G,D) f32 over cache positions
// [start_b, length_b) and returns the normalized output (B,Hkv,G,D) f32
// and the softmax statistics l and m (B,Hkv,G) f32.  An empty range gives
// out 0, l 0 and m -1e30.  Where the rows lie is the template parameter
// Src:
//  * Paged: position pos is slot pos % bs of page table[b, pos / bs]
//    (clipped to [0, N-1]) of the pool; page i of a rank lies at
//    tab[i] * page_stride + hk * head_stride.
//  * Slot: the (s, hk) slot of the batch-leading contiguous cache, read in
//    virtual pages of kSlotPage rows: position pos lies at
//    s * batch_stride + hk * head_stride + pos * row_bytes, where query row
//    b reads slot s = b / rows_per_slot (1 for decode; the W rows of a
//    speculative verify block, each with its own length, share a slot).
//    No table.  Lengths are clipped to the slot's S, which need not be a
//    multiple of kSlotPage.
// In both a page (or a slot) is contiguous rows (row stride = row length,
// and 1 for the scale planes), as in every cache the engine builds.
//
// Design.
//  * One cluster of kCluster blocks per (b, hk), grid (kCluster, Hkv, B).
//    The pages that hold [start, length) are split evenly, in page order,
//    over the cluster's ranks (rank_pages): each block takes whole pages.
//    The split and the chunks are a function of (start, length, bs) alone,
//    never of page ids, pool size, batch or where the slot lies, so the
//    same contents give the same bits wherever their pages lie (preemption
//    replay and prefix sharing rely on it), and a slot gives the bits of a
//    pool of kSlotPage-row pages holding the same rows.
//  * Paged: a block reads its pages' table entries once, clipped, into
//    shared memory (the table row is prefetched into L2 while the length is
//    read); no row access reads the table or divides by bs.  Slot: nothing
//    to look up, one dependent round trip (the length) fewer.
//  * The block stages its pages a chunk of up to kChunkRows rows (whole
//    pages) at a time in a ring in shared memory.  Paged: whole pages with
//    cp.async (16 bytes a thread; 4 for the scales).  Slot: a chunk is one
//    contiguous run of rows in each plane, so its rows of [start, length)
//    come in two bulk copies (cp.async.bulk, one thread, completing on the
//    ring slot's mbarrier) and the scales by cp.async; the last virtual
//    page stops at the length, never past S.  The ring holds 2 to
//    kMaxChunks chunks within kRingBytes, so that 8 blocks fit on an SM
//    (all 768 blocks of the serving path at once, with 64 registers a
//    thread), and the next chunk's copy is issued before the current one
//    is scored.
//  * Scoring and accumulation read the staged rows: a row is split across
//    D/8 lanes, each lane owning 8 dimensions, so a warp's access covers
//    contiguous bytes (bank-conflict free: 16-byte accesses for bf16 and
//    f32, 8 for int8, 4 for int4) and a lane's accumulator stays at 8 x G
//    floats for every format.  Each group of D/8 lanes keeps its own
//    online softmax (m, l, acc) over the rows it scores, several rows of a
//    chunk scored independently before one update; quantized rows are
//    dequantized in registers (the scale folded into the score and into p),
//    so no f32 copy of a quantized cache reaches global memory.  Rows of
//    the ring outside [start, length) are skipped by a branch, never
//    multiplied by 0: they may hold any bits, NaN included.
//  * The lane groups of a warp merge with shuffles, the warps of a block in
//    shared memory, and the ranks of the cluster through distributed shared
//    memory (32-bit shared::cluster addresses), in rank order; rank 0
//    writes out, l and m.  One launch, no
//    global workspace, no atomics.  A rank with no pages takes part in the
//    merge with m -1e30 and l 0; a sequence with nothing to walk skips the
//    merge on every rank.
//
// What bounds it on the H100: the bytes of the live positions (payload
// plus, when quantized, the 4-byte scales) over 3.35 TB/s, about 7 us for
// the serving path's four sequences of up to 2048 positions in bf16; the
// operations (4*G*D per position) are far below the FMA rate.  What the
// design pays beyond the bytes: the cluster launch, the dependent round
// trips before the first copy is issued (the length, and for Paged the
// table entries), the chunks' latency where the ring cannot hide it, and
// the cluster barriers around rank 0's merge.
#pragma once

#include <cooperative_groups.h>

#include "decode_walk.cuh"

namespace paged_walk {

namespace cg = cooperative_groups;
using decode_walk::kNegInf;

constexpr int kCluster = 8;    // blocks of a cluster splitting one (b, hk): the portable limit
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneDims = 8;   // dimensions of a row that one lane owns
constexpr int kChunkRows = 64;         // rows of the whole pages staged and scored together, at most
constexpr int kRingBytes = 26 * 1024;  // the ring of staged chunks: kSmBlocks blocks fit on an SM
constexpr int kSmBlocks = 8;           // blocks an SM holds where G * D <= 64
constexpr int kMaxChunks = 8;          // chunks the ring holds at most
constexpr int kMaxSmem = 227 * 1024;   // shared memory a block can use
constexpr int kSlotPage = 16;          // rows of a contiguous slot's virtual page

// where a sequence's rows lie: pages through a block table, or one slot
enum class Src { Paged, Slot };

// whether q waits in shared memory rather than in registers: at D = 32,
// where G x D <= 64 leaves the fewest registers
__host__ __device__ constexpr bool q_shared(int D) { return D == 32; }

// ---- a lane's 8 dimensions of a staged row, as f32 (unscaled): dim(c, e)
// is the dimension of element e of lane slice c, load() reads them.

template <class Fmt, int D>
struct Slice;

template <int D>
struct Slice<decode_walk::Bf16, D> {
  static constexpr int kRowBytes = 2 * D;
  __device__ __forceinline__ static int dim(int c, int e) { return kLaneDims * c + e; }
  __device__ __forceinline__ static void load(const unsigned char* row, int c, float* out) {
    decode_walk::Bf16::load(reinterpret_cast<const __nv_bfloat16*>(row), kLaneDims * c, out);
  }
};

// f32: the two halves 4c..4c+3 and D/2+4c..D/2+4c+3, so that each of the
// two 16-byte accesses of a warp covers contiguous bytes
template <int D>
struct Slice<decode_walk::F32, D> {
  static constexpr int kRowBytes = 4 * D;
  __device__ __forceinline__ static int dim(int c, int e) {
    return (e < 4 ? 0 : D / 2) + 4 * c + (e & 3);
  }
  __device__ __forceinline__ static void load(const unsigned char* row, int c, float* out) {
    const float* r = reinterpret_cast<const float*>(row);
    decode_walk::F32::load(r, 4 * c, out);
    decode_walk::F32::load(r, D / 2 + 4 * c, out + 4);
  }
};

template <int D>
struct Slice<decode_walk::Int8, D> {
  static constexpr int kRowBytes = D;
  __device__ __forceinline__ static int dim(int c, int e) { return kLaneDims * c + e; }
  __device__ __forceinline__ static void load(const unsigned char* row, int c, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + kLaneDims * c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = static_cast<float>(b[e]);
  }
};

// int4: byte j holds dimension 2j in its low nibble and 2j+1 in its high one
template <int D>
struct Slice<decode_walk::Int4, D> {
  static constexpr int kRowBytes = D / 2;
  __device__ __forceinline__ static int dim(int c, int e) { return kLaneDims * c + e; }
  __device__ __forceinline__ static void load(const unsigned char* row, int c, float* out) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(row + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t b = static_cast<uint8_t>(raw >> (8 * i));
      out[2 * i] = decode_walk::Int4::lo(b);
      out[2 * i + 1] = decode_walk::Int4::hi(b);
    }
  }
};

// One staged chunk of `rows` rows: K rows, V rows, then the rows' K and V
// scales when quantized, padded to 16 bytes.
template <class Fmt, int D>
__host__ __device__ constexpr int chunk_bytes(int rows) {
  return 2 * rows * Slice<Fmt, D>::kRowBytes + (Fmt::kScaled ? (8 * rows + 15) / 16 * 16 : 0);
}

// Pages a chunk holds: whole pages, at most kChunkRows rows, and few
// enough that two chunks fit in kRingBytes (at least one page).
template <class Fmt, int D>
__host__ __device__ constexpr int chunk_pages(int bs) {
  int cp = bs < kChunkRows ? kChunkRows / bs : 1;
  while (cp > 1 && 2 * chunk_bytes<Fmt, D>(cp * bs) > kRingBytes) --cp;
  return cp;
}

// Rank `rank`'s share of [start, len): table columns first .. first+npg-1,
// the pages that hold [start, len) split evenly in page order.
__device__ __forceinline__ void rank_pages(int start, int len, int bs, int rank, int& first,
                                           int& npg) {
  const int p0 = start / bs;
  const int n = len > start ? (len + bs - 1) / bs - p0 : 0;
  const int per = (n + kCluster - 1) / kCluster;
  first = p0 + rank * per;
  npg = max(0, min(per, p0 + n - first));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..kMaxChunks-1) of this thread's copy groups are
// pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void prefetch_l2(const void* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gmem));
}

// The shared::cluster address of rank r's copy of the shared variable at
// smem, and a load from such an address: 32-bit addresses, so that rank 0's
// merge holds its reads of all ranks in registers without spilling.
__device__ __forceinline__ unsigned cluster_addr(const void* smem, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "r"(r));
  return out;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// The bytes the next phase of bar waits for, and a bulk copy of `bytes`
// (a multiple of 16, 16-byte aligned ends) that completes them.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of bar with this parity; a copy that never lands
// traps rather than hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (ok) return;
    if (tries > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

struct Params {
  const float* q;          // (B, Hkv, G, D) contiguous
  const unsigned char* k;  // payloads: a page's (or a slot's) head slice is contiguous rows
  const unsigned char* v;
  const float* k_scale;    // scale planes, null for unscaled formats
  const float* v_scale;
  const int* tables;       // Paged: (B, P) int32 contiguous; Slot: null
  const int* lengths;      // (B,)
  const int* starts;       // (B,) or null: every start is 0
  float* out;              // (B, Hkv, G, D)
  float* l;                // (B, Hkv, G)
  float* m;
  long long k_st[2], v_st[2];    // (page or batch, head) strides of the payloads, in bytes
  long long ks_st[2], vs_st[2];  // (page or batch, head) strides of the scale planes, in floats
  int Hkv, G;
  int N, P;                      // Paged: pages of the pool, table columns
  int rows_per_slot;             // Slot: query rows that read one slot (row b reads b / it)
  int bs;                        // rows of a page (kSlotPage for a slot)
  int cap;                       // positions a sequence can hold: P * bs, or the slot's S
  int cp;                        // pages a chunk holds
  int chunks;                    // chunks the ring holds
  float sm_scale;
};

// kSmBlocks blocks an SM where the group's registers fit in that without
// spilling: G * D <= 64, the serving path's G = 1, D = 64
template <class Fmt, Src kSrc, int D, int MAXG>
__global__ void __launch_bounds__(kThreads, MAXG * D <= 64 ? kSmBlocks : 1) walk(const Params p) {
  using S = Slice<Fmt, D>;
  constexpr int RB = S::kRowBytes;
  constexpr int LV = D / kLaneDims;          // lanes a row is split across
  constexpr int GROUPS = kThreads / LV;      // row groups of the block
  // rows a group scores at once: up to a chunk, fewer where G is large
  constexpr int RPG0 = kChunkRows / GROUPS > 0 ? kChunkRows / GROUPS : 1;
  constexpr int RPG = RPG0 < 16 / MAXG ? RPG0 : (16 / MAXG > 0 ? 16 / MAXG : 1);
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float wm[kWarps][MAXG], wl[kWarps][MAXG];
  __shared__ float wacc[kWarps][MAXG][D];
  // this rank's (m, l, acc), which rank 0 reads through distributed shared memory
  __shared__ float red[MAXG * (D + 2)];
  float* rm = red;
  float* rl = red + MAXG;
  float* racc = red + 2 * MAXG;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = lane % LV;    // the lane's slice of a row
  const int grp = tid / LV;   // the lane's row group
  const int G = p.G;
  // a slot's pages and chunks are known at compile time
  const int bs = kSrc == Src::Slot ? kSlotPage : p.bs;
  const int cp = kSrc == Src::Slot ? chunk_pages<Fmt, D>(kSlotPage) : p.cp;  // pages a chunk holds
  long long slot = b;  // Slot: the cache slot query row b reads
  if constexpr (kSrc == Src::Slot) slot = b / p.rows_per_slot;

  // q first and (Paged) the table row into L2: neither waits for the length
  const long long bh = static_cast<long long>(b) * p.Hkv + hk;
  // q's slice of a row for query head g, as this lane scores it: read from
  // shared memory where it is used (q_shared), else held in registers
  constexpr bool kQShared = q_shared(D);
  __shared__ __align__(16) float qs[kQShared ? MAXG * D : 4];
  float qr[kQShared ? 1 : MAXG][kLaneDims];
  auto q_slice = [&](const float* qg, float* out) {  // qg: head g's D values
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(qg + S::dim(c, 4 * h));
      out[4 * h] = x.x;
      out[4 * h + 1] = x.y;
      out[4 * h + 2] = x.z;
      out[4 * h + 3] = x.w;
    }
  };
  if constexpr (kQShared) {  // read after the barrier before the first chunk is scored
    for (int e = tid; e < G * D; e += kThreads) qs[e] = p.q[bh * G * D + e];
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) q_slice(p.q + (bh * G + g) * D, qr[g]);
    }
  }
  const int* trow = nullptr;
  if constexpr (kSrc == Src::Paged) {
    trow = p.tables + static_cast<long long>(b) * p.P;
    for (int e = 32 * tid; e < p.P; e += 32 * kThreads) prefetch_l2(trow + e);
  }

  const int len = min(p.lengths[b], p.cap);
  const int start = p.starts != nullptr ? max(p.starts[b], 0) : 0;
  int first, npg;
  rank_pages(start, len, bs, rank, first, npg);
  const int lo = max(start, first * bs);
  const int hi = min(len, (first + npg) * bs);
  const int CR = cp * bs;  // rows of a chunk
  const int cb = chunk_bytes<Fmt, D>(CR);
  const int nch = (npg + cp - 1) / cp;
  if (len <= start) {  // nothing to walk, for every rank alike: no merge
    if (rank == 0) {
      for (int e = tid; e < G * D; e += kThreads) p.out[bh * G * D + e] = 0.f;
      for (int g = tid; g < G; g += kThreads) {
        p.l[bh * G + g] = 0.f;
        p.m[bh * G + g] = kNegInf;
      }
    }
    return;
  }
  __shared__ unsigned long long bars[kMaxChunks];  // Slot bulk copies: a chunk has landed
  int* tab = nullptr;
  if constexpr (kSrc == Src::Paged) {
    tab = reinterpret_cast<int*>(ring + p.chunks * cb);
    for (int i = tid; i < npg; i += kThreads) tab[i] = min(max(trow[first + i], 0), p.N - 1);
    __syncthreads();  // the table entries
  }

  // chunk k (pages k*cp ..) into ring slot rs = k % chunks, one copy group
  // a chunk (an empty group past the range, so that the waits count chunks)
  auto issue = [&](int k, int rs) {
    if (k >= nch) {
    } else if constexpr (kSrc == Src::Slot) {
      // the chunk's rows in [lo, hi), one run in each plane: bulk copies of
      // the payload, completing on the slot's barrier; the scales by cp.async
      unsigned char* dst = ring + rs * cb;
      const int c0 = (first + k * cp) * bs;  // the position of the chunk's row 0
      const int r0 = max(lo, c0), n = min(hi, c0 + CR) - r0;
      unsigned char* kd = dst + (r0 - c0) * RB;
      if (tid == 0) {
        unsigned long long* bar = &bars[rs];
        mbar_expect(bar, 2 * n * RB);
        bulk_copy(kd, p.k + slot * p.k_st[0] + hk * p.k_st[1] + static_cast<long long>(r0) * RB,
                  n * RB, bar);
        bulk_copy(kd + CR * RB,
                  p.v + slot * p.v_st[0] + hk * p.v_st[1] + static_cast<long long>(r0) * RB,
                  n * RB, bar);
      }
      if constexpr (Fmt::kScaled) {
        float* sd = reinterpret_cast<float*>(dst + 2 * CR * RB) + (r0 - c0);
        const float* kss = p.k_scale + slot * p.ks_st[0] + hk * p.ks_st[1] + r0;
        const float* vss = p.v_scale + slot * p.vs_st[0] + hk * p.vs_st[1] + r0;
        for (int e = tid; e < n; e += kThreads) {
          cp_async4(sd + e, kss + e);
          cp_async4(sd + CR + e, vss + e);
        }
      }
    } else {  // Paged: whole pages, by cp.async
      unsigned char* dst = ring + rs * cb;
      const int np = min(cp, npg - k * cp);
      for (int pg = 0; pg < np; ++pg) {
        const long long page = tab[k * cp + pg];
        const unsigned char* ksrc = p.k + page * p.k_st[0] + hk * p.k_st[1];
        const unsigned char* vsrc = p.v + page * p.v_st[0] + hk * p.v_st[1];
        unsigned char* kd = dst + pg * bs * RB;
        unsigned char* vd = kd + CR * RB;
        for (int e = tid; e < bs * RB / 16; e += kThreads) {
          cp_async16(kd + 16 * e, ksrc + 16 * e);
          cp_async16(vd + 16 * e, vsrc + 16 * e);
        }
        if constexpr (Fmt::kScaled) {
          float* sd = reinterpret_cast<float*>(dst + 2 * CR * RB) + pg * bs;
          const float* kss = p.k_scale + page * p.ks_st[0] + hk * p.ks_st[1];
          const float* vss = p.v_scale + page * p.vs_st[0] + hk * p.vs_st[1];
          for (int e = tid; e < bs; e += kThreads) {
            cp_async4(sd + e, kss + e);
            cp_async4(sd + CR + e, vss + e);
          }
        }
      }
    }
    cp_async_commit();
  };

  float m_run[MAXG], l_run[MAXG], acc[MAXG][kLaneDims];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneDims; ++e) acc[g][e] = 0.f;
  }

  if constexpr (kSrc == Src::Slot) {
    if (tid == 0) {
      for (int i = 0; i < p.chunks; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // the first chunks - 1 chunks' copies, then at each chunk the next one's,
  // before this one is scored (one call site: issue() is inlined once).
  // The ring slot and its barrier's phase are counted, not divided out.
  int rs = 0;        // the ring slot of the next chunk issued, then of chunk k
  unsigned ph = 1;   // the phase of chunk k's use of its slot
  for (int k = 1 - p.chunks; k < nch; ++k) {
    issue(k + p.chunks - 1, rs);
    rs = rs + 1 == p.chunks ? 0 : rs + 1;
    if (k < 0) continue;
    if (rs == 0) ph ^= 1;
    cp_async_wait(p.chunks - 1);  // chunk k has landed (this thread's copies)
    if constexpr (kSrc == Src::Slot) mbar_wait(&bars[rs], ph);
    __syncthreads();              // (everyone's)
    const unsigned char* st = ring + rs * cb;
    const float* sc = reinterpret_cast<const float*>(st + 2 * CR * RB);
    const int base = (first + k * cp) * bs;  // the position of the chunk's row 0
    for (int r0 = 0; r0 < CR; r0 += RPG * GROUPS) {
      // RPG rows of the group, scored independently, then one online-softmax
      // step.  Rows past the chunk or outside [lo, hi) are read (they lie in
      // the ring) but change nothing: they may hold any bits.
      float x[RPG][MAXG];
      float vsc[RPG];
      bool ok[RPG];
      int row[RPG];
#pragma unroll
      for (int u = 0; u < RPG; ++u) {
        const int j = r0 + u * GROUPS + grp;
        row[u] = min(j, CR - 1);
        ok[u] = j < CR && base + j >= lo && base + j < hi;
        float kf[kLaneDims];
        S::load(st + row[u] * RB, c, kf);
        float ksc = p.sm_scale;
        vsc[u] = 1.f;
        if constexpr (Fmt::kScaled) {
          ksc *= sc[row[u]];
          vsc[u] = sc[CR + row[u]];
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          float s = 0.f;
          if (g < G) {
            if constexpr (kQShared) {
              float qv[kLaneDims];
              q_slice(qs + g * D, qv);
#pragma unroll
              for (int e = 0; e < kLaneDims; ++e) s = fmaf(qv[e], kf[e], s);
            } else {
#pragma unroll
              for (int e = 0; e < kLaneDims; ++e) s = fmaf(qr[g][e], kf[e], s);
            }
#pragma unroll
            for (int o = LV / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          }
          x[u][g] = s * ksc;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float m_new = m_run[g];
#pragma unroll
          for (int u = 0; u < RPG; ++u)
            if (ok[u]) m_new = fmaxf(m_new, x[u][g]);
          const float alpha = expf(m_run[g] - m_new);
          l_run[g] *= alpha;
#pragma unroll
          for (int e = 0; e < kLaneDims; ++e) acc[g][e] *= alpha;
          m_run[g] = m_new;
#pragma unroll
          for (int u = 0; u < RPG; ++u) {
            x[u][g] = ok[u] ? expf(x[u][g] - m_new) : 0.f;  // p
            l_run[g] += x[u][g];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < RPG; ++u) {
        if (ok[u]) {
          float vf[kLaneDims];
          S::load(st + (CR + row[u]) * RB, c, vf);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float pv = x[u][g] * vsc[u];
#pragma unroll
              for (int e = 0; e < kLaneDims; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // slot k % chunks is free for chunk k + chunks
  }
  cp_async_wait(0);

  // the lane groups of a warp, pairwise in a fixed order
#pragma unroll
  for (int o = LV; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m_run[g], o);
        const float l_o = __shfl_xor_sync(0xffffffffu, l_run[g], o);
        const float m_new = fmaxf(m_run[g], m_o);
        const float fa = expf(m_run[g] - m_new), fb = expf(m_o - m_new);
        l_run[g] = l_run[g] * fa + l_o * fb;
#pragma unroll
        for (int e = 0; e < kLaneDims; ++e)
          acc[g][e] = acc[g][e] * fa + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * fb;
        m_run[g] = m_new;
      }
    }
  }
  if (lane < LV) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        if (lane == 0) {
          wm[warp][g] = m_run[g];
          wl[warp][g] = l_run[g];
        }
#pragma unroll
        for (int e = 0; e < kLaneDims; ++e) wacc[warp][g][S::dim(c, e)] = acc[g][e];
      }
    }
  }
  __syncthreads();
  // the warps of the block: this rank's (m, l, acc)
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][g] - mx);
      l += wl[w][g] * f;
      a += wacc[w][g][d] * f;
    }
    racc[e] = a;
    if (d == 0) {
      rm[g] = mx;
      rl[g] = l;
    }
  }
  cluster.sync();  // every rank's (m, l, acc) is written
  if (rank == 0) {
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      float mr[kCluster], lr[kCluster], ar[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {  // all remote reads first, then the sums
        const unsigned base = cluster_addr(red, r);  // rank r's red
        mr[r] = ld_cluster(base + 4 * g);
        lr[r] = ld_cluster(base + 4 * (MAXG + g));
        ar[r] = ld_cluster(base + 4 * (2 * MAXG + e));
      }
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) mx = fmaxf(mx, mr[r]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const float f = expf(mr[r] - mx);
        l += lr[r] * f;
        a += ar[r] * f;
      }
      p.out[bh * G * D + e] = a / fmaxf(l, 1e-30f);
      if (e % D == 0) {
        p.l[bh * G + g] = l;
        p.m[bh * G + g] = mx;
      }
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its shared memory
}

template <class Fmt, Src kSrc, int D, int MAXG>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  // the kernel's static shared memory: the merge's, q's, the barriers, and
  // 64 bytes for their alignment
  constexpr int kStatic =
      4 * (kWarps + 1) * MAXG * (D + 2) + 4 * (q_shared(D) ? MAXG * D : 4) + 8 * kMaxChunks + 64;
  const int cp = chunk_pages<Fmt, D>(p.bs);
  const int cb = chunk_bytes<Fmt, D>(cp * p.bs);
  const int pages = (p.cap + p.bs - 1) / p.bs;  // P, or a slot's virtual pages
  const int per_max = (pages + kCluster - 1) / kCluster;  // the most pages a rank takes
  const int table = kSrc == Src::Paged ? 4 * (per_max > 0 ? per_max : 1) : 0;
  // as many chunks as fill kRingBytes, 2 to kMaxChunks, no more than a rank
  // can use; fewer where the pages are large
  const int used = (per_max + cp - 1) / cp + 1;
  int chunks = kRingBytes / cb;
  chunks = chunks < 2 ? 2 : (chunks > kMaxChunks ? kMaxChunks : chunks);
  if (chunks > used) chunks = used > 2 ? used : 2;
  while (chunks > 2 && chunks * cb + table + kStatic > kMaxSmem) --chunks;
  const int smem = chunks * cb + table;
  if (smem + kStatic > kMaxSmem) return cudaErrorInvalidValue;
  p.cp = cp;
  p.chunks = chunks;
  auto kernel = walk<Fmt, kSrc, D, MAXG>;
  if (smem + kStatic > 48 * 1024) {  // above 48 KB a block must opt in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, p.Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// Picks the head dim and the query-group bound, launches, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
template <class Fmt, Src kSrc>
int dispatch(int D, const Params& p, int B, cudaStream_t stream) {
  if (p.G < 1 || p.G > 8 || p.bs < 1 || p.cap < 0 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
#define PAGED_WALK_G(DD)                                                \
  e = p.G <= 1   ? launch<Fmt, kSrc, DD, 1>(p, B, stream)               \
      : p.G <= 2 ? launch<Fmt, kSrc, DD, 2>(p, B, stream)               \
      : p.G <= 4 ? launch<Fmt, kSrc, DD, 4>(p, B, stream)               \
                 : launch<Fmt, kSrc, DD, 8>(p, B, stream);
  switch (D) {
    case 32: PAGED_WALK_G(32) break;
    case 64: PAGED_WALK_G(64) break;
    case 128: PAGED_WALK_G(128) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_WALK_G
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves its error for the next caller: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launchers' common entry.  format: 0 bf16, 1 f32, 2 int8, 3 int4.
// strides: 12 values in elements, (page or batch, head, row) of k, v,
// k_scale and v_scale (the scales' ignored for formats 0 and 1).  The rows
// of a page or slot must be contiguous: row stride = row length, and 1 for
// the scale planes; any other strides give cudaErrorInvalidValue.  Fills
// in the payload and scale strides of p and launches.
template <Src kSrc>
int run(int format, int D, Params p, const long long* strides, int B, cudaStream_t stream) {
  static const int kElemBytes[4] = {2, 4, 1, 1};
  if (format < 0 || format > 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long row = format == 3 ? D / 2 : D;  // payload elements of a row
  const bool scaled = format >= 2;
  if (strides[2] != row || strides[5] != row || (scaled && (strides[8] != 1 || strides[11] != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int eb = kElemBytes[format];
  for (int i = 0; i < 2; ++i) {
    p.k_st[i] = strides[i] * eb;
    p.v_st[i] = strides[3 + i] * eb;
    p.ks_st[i] = scaled ? strides[6 + i] : 0;
    p.vs_st[i] = scaled ? strides[9 + i] : 0;
  }
  switch (format) {
    case 0: return dispatch<decode_walk::Bf16, kSrc>(D, p, B, stream);
    case 1: return dispatch<decode_walk::F32, kSrc>(D, p, B, stream);
    case 2: return dispatch<decode_walk::Int8, kSrc>(D, p, B, stream);
    default: return dispatch<decode_walk::Int4, kSrc>(D, p, B, stream);
  }
}

}  // namespace paged_walk
