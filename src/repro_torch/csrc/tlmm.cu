// Ternary table-lookup matmul (TLMM) and its activation quantization, for
// Hopper.
//
// Replaces: src/repro/kernels/tlmm/kernel.py :: tlmm_pallas (_tlmm_kernel,
// _decode_ternary_tile), the TPU kernel behind every linear of the
// W1.58-A8 model in both phases, and the per-token int8 quantization
// (src/repro/quant/act_quant.py) that the JAX wrapper runs before it.
//
// TLMM computes y[M,N] = float(sum_k x_q[m,k] * w[k,n]) * scale[m], where
// x_q is int8 (M,K) row-major, w is ternary and arrives 2-bit packed as
// uint8 (K/4,N) (value k = 4j+i in bits [2i,2i+2) of byte j; codes 00 -> 0,
// 01 -> +1, 10 -> -1, 11 -> 0), and scale is f32 (M,) = act_scale * beta.
// The sum is an exact int32 in any order; the epilogue rounds once, as the
// TPU kernel does, so the result is bit-identical to the plain version.
//
// What bounds it on the H100: in decode (M = 1..8 slots) the packed weight
// bytes, K*N/4, over 3.35 TB/s (about half a microsecond), so the number of
// blocks in flight and the round trips to memory decide; in prefill
// (M = 64..2048) the int8 multiply-adds, 2*M*K*N operations, over the
// tensor cores' 1,979 TOP/s.
//
// Design.  One packed byte holds four consecutive K values of one column:
// decode4 turns it into one int32 word of four int8 lanes (an arithmetic
// table lookup, no branch), which is both a __dp4a operand and, exactly, a
// register of the m16n8k32 int8 MMA's B fragment.  No unpacked weight ever
// exists in device memory.
//  * act_quant: one block per row; a block-wide absmax, then the
//    elementwise pass writing x_q and the folded scale act_scale * beta.
//  * tlmm_split_k (M <= 8): a 64-column tile per block, and K split across
//    the 8 (or 4) blocks of a thread-block cluster, so that N/64 * 8 blocks
//    (192 at N = 1536) stream the weight 16 bytes a thread, four loads in
//    flight.  Each block sums its K range in int32; the cluster adds the
//    partial tiles through distributed shared memory, each block finishing
//    its slice of the tile: one launch, no workspace, no atomics.  A split
//    of 4 where that still fills the card with blocks of at least 96
//    packed rows: with fewer, the reduction and the cluster barrier cost
//    more than the stream.
//  * tlmm_mma (M > 8): int8 tensor cores, mma.sync m16n8k32, a 64- or
//    128-row by 128-column block tile, K walked 64 at a time through
//    shared memory with cp.async, double-buffered; the packed tile is
//    decoded once per block into shared memory, from which each warp reads
//    its B fragments.  M/N edges are masked, a K tail is zero-filled.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Byte b (four 2-bit codes) -> four int8 lanes: lane i = bit 2i - bit 2i+1
// (code 11 gives 0).  The multiply by 0x41041 moves bits 0,2,4,6 to bits
// 0,8,16,24 without carries into those bits.
__device__ __forceinline__ int decode4(uint32_t b) {
  const uint32_t lo = ((b & 0x55u) * 0x41041u) & 0x01010101u;
  const uint32_t hi = (((b >> 1) & 0x55u) * 0x41041u) & 0x01010101u;
  return static_cast<int>((lo | (hi * 0xFFu)) & ~((lo & hi) * 0xFFu));
}

// ------------------------------------------------------------ act_quant --

constexpr int kAqThreads = 256;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void load4(const uint16_t* p, float v[4]) {  // bf16
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// x (M,K) contiguous, K % 4 == 0 -> x_q (M,K) int8 and scale (M,) =
// fmaf(absmax, f32(1/127), eps) * beta.  One rounding for the scale, as the
// jitted JAX program's fused multiply-add; x / scale a true division,
// rounded half to even, clipped to +-127.  Bit-equal to the plain
// quantize_activations_int8 followed by the fold.
template <typename T>
__global__ void __launch_bounds__(kAqThreads)
act_quant(const T* __restrict__ x, const float* __restrict__ beta, int8_t* __restrict__ xq,
          float* __restrict__ scale, int K, float eps) {
  __shared__ float red[kAqThreads / 32];
  const int m = blockIdx.x;
  const T* row = x + static_cast<size_t>(m) * K;
  float amax = 0.f;
  for (int k = threadIdx.x * 4; k < K; k += kAqThreads * 4) {
    float v[4];
    load4(row + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kAqThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaf(amax, __int_as_float(0x3C010204), eps);  // f32(1/127)
  char4* out = reinterpret_cast<char4*>(xq + static_cast<size_t>(m) * K);
  for (int k = threadIdx.x * 4; k < K; k += kAqThreads * 4) {
    float v[4];
    load4(row + k, v);
    signed char q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = static_cast<signed char>(fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f));
    out[k / 4] = make_char4(q[0], q[1], q[2], q[3]);
  }
  if (threadIdx.x == 0) scale[m] = __fmul_rn(s, *beta);
}

// ---------------------------------------------------- M <= 8: split K --

constexpr int kMaxSplit = 8;         // blocks of a cluster, splitting K (portable limit)
constexpr int kSmallCols = 64;       // columns of a block: 4 threads x 16
constexpr int kSmallThreads = 128;   // 4 column threads x 32 row threads
constexpr int kBatch = 4;            // 16-byte loads in flight a thread
constexpr int kSmallXWords = 2048;   // x_q words of a block's K range, all rows

// Sixteen packed bytes: columns n..n+15 of packed row j, zero past N.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ wp, int j, int N, int n) {
  const uint8_t* p = wp + static_cast<size_t>(j) * N + n;
  if (VEC) return n < N ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (n + c < N) w[c / 4] |= static_cast<uint32_t>(p[c]) << (8 * (c % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int M, int SPLIT, bool VEC>
__global__ void __launch_bounds__(kSmallThreads)
tlmm_split_k(const int8_t* __restrict__ xq, const uint8_t* __restrict__ wp,
             const float* __restrict__ scale, float* __restrict__ y, int N, int K) {
  __shared__ int xs[kSmallXWords];
  __shared__ int wpart[kSmallThreads / 32][M * kSmallCols];
  __shared__ int part[M * kSmallCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int KW = K / 4;
  const int chunk = (KW + SPLIT - 1) / SPLIT;
  const int j0 = rank * chunk;
  const int nrows = max(0, min(KW, j0 + chunk) - j0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ct = lane & 3;   // column thread: columns ct*16 .. ct*16+15
  const int rt = tid >> 2;   // row thread: packed rows rt, rt+32, ...
  const int n = blockIdx.x * kSmallCols + ct * 16;
  const int* x32 = reinterpret_cast<const int*>(xq);
  for (int e = tid; e < M * nrows; e += kSmallThreads) {
    const int m = e / nrows, j = e - m * nrows;
    xs[m * chunk + j] = x32[static_cast<size_t>(m) * KW + j0 + j];
  }
  __syncthreads();

  int acc[M][16];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0;
  for (int i0 = 0; i0 < nrows; i0 += 32 * kBatch) {
    uint4 wb[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = i0 + rt + 32 * b;
      wb[b] = j < nrows ? load16<VEC>(wp, j0 + j, N, n) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = i0 + rt + 32 * b;
      if (j >= nrows) break;
      const uint32_t words[4] = {wb[b].x, wb[b].y, wb[b].z, wb[b].w};
      int a[M];
#pragma unroll
      for (int m = 0; m < M; ++m) a[m] = xs[m * chunk + j];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int w = decode4((words[q] >> (8 * c)) & 0xFFu);
#pragma unroll
          for (int m = 0; m < M; ++m) acc[m][q * 4 + c] = __dp4a(a[m], w, acc[m][q * 4 + c]);
        }
    }
  }
  // the 8 row threads of a warp, then the 4 warps, then the blocks of the cluster
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      int v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 16; ++c) wpart[tid >> 5][m * kSmallCols + ct * 16 + c] = acc[m][c];
  }
  __syncthreads();
  for (int e = tid; e < M * kSmallCols; e += kSmallThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kSmallThreads / 32; ++w) s += wpart[w][e];
    part[e] = s;
  }
  cluster.sync();  // every block's partial tile is written
  constexpr int kSlice = M * kSmallCols / SPLIT;
  if (tid < kSlice) {
    const int e = rank * kSlice + tid;
    int s = 0;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) s += cluster.map_shared_rank(part, r)[e];
    const int m = e / kSmallCols;
    const int col = blockIdx.x * kSmallCols + e % kSmallCols;
    if (col < N) y[static_cast<size_t>(m) * N + col] = static_cast<float>(s) * scale[m];
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

// ------------------------------------------- M > 8: int8 tensor cores --

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_s8(int c[4], const int a[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kBN = 128;
constexpr int kBK = 64;            // K values a step
constexpr int kBKW = kBK / 4;      // packed rows a step
constexpr int kAS = kBK + 16;      // bytes a row of the x_q tile (bank spread)
constexpr int kPS = kBN + 16;      // bytes a row of the packed tile
constexpr int kDS = kBN + 8;       // words a row of the decoded tile

// WM warps down (64 rows each) x 4 warps across (32 columns each); FAST:
// K % 16 == 0, N % 16 == 0 and 16-byte aligned bases, so every 16-byte
// chunk is wholly inside or outside and goes by cp.async; otherwise the
// tiles are copied byte by byte (same arithmetic).
template <int WM, bool FAST>
__global__ void __launch_bounds__(WM * 128)
tlmm_mma(const int8_t* __restrict__ xq, const uint8_t* __restrict__ wp,
         const float* __restrict__ scale, float* __restrict__ y, int M, int N, int K) {
  constexpr int BM = WM * 64;
  constexpr int THREADS = WM * 128;
  __shared__ __align__(16) int8_t as[2][BM][kAS];
  __shared__ __align__(16) uint8_t ps[2][kBKW][kPS];
  __shared__ int ds[kBKW][kDS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int KW = K / 4;
  const int KT = (K + kBK - 1) / kBK;

  auto load_tile = [&](int kt, int buf) {
    if (FAST) {
      for (int e = tid; e < BM * (kBK / 16); e += THREADS) {
        const int r = e / (kBK / 16), c = (e % (kBK / 16)) * 16;
        const int m = m0 + r, k = kt * kBK + c;
        const bool ok = m < M && k < K;
        cp_async16(&as[buf][r][c], ok ? xq + static_cast<size_t>(m) * K + k : xq, ok);
      }
      for (int e = tid; e < kBKW * (kBN / 16); e += THREADS) {
        const int r = e / (kBN / 16), c = (e % (kBN / 16)) * 16;
        const int j = kt * kBKW + r, n = n0 + c;
        const bool ok = j < KW && n < N;
        cp_async16(&ps[buf][r][c], ok ? wp + static_cast<size_t>(j) * N + n : wp, ok);
      }
    } else {
      for (int e = tid; e < BM * kBK; e += THREADS) {
        const int r = e / kBK, c = e % kBK;
        const int m = m0 + r, k = kt * kBK + c;
        as[buf][r][c] = (m < M && k < K) ? xq[static_cast<size_t>(m) * K + k] : 0;
      }
      for (int e = tid; e < kBKW * kBN; e += THREADS) {
        const int r = e / kBN, c = e % kBN;
        const int j = kt * kBKW + r, n = n0 + c;
        ps[buf][r][c] = (j < KW && n < N) ? wp[static_cast<size_t>(j) * N + n] : 0;
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile kt has landed (this thread's copies)
    __syncthreads();   // ... and every thread's
    for (int e = tid; e < kBKW * (kBN / 4); e += THREADS) {
      const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
      const uint32_t w4 = *reinterpret_cast<const uint32_t*>(&ps[buf][r][c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[r][c + i] = decode4((w4 >> (8 * i)) & 0xFFu);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      int a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        const int c = ks * 32 + t * 4;
        a[i][0] = *reinterpret_cast<const int*>(&as[buf][r][c]);
        a[i][1] = *reinterpret_cast<const int*>(&as[buf][r + 8][c]);
        a[i][2] = *reinterpret_cast<const int*>(&as[buf][r][c + 16]);
        a[i][3] = *reinterpret_cast<const int*>(&as[buf][r + 8][c + 16]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        const int b0 = ds[ks * 8 + t][col];
        const int b1 = ds[ks * 8 + 4 + t][col];
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();  // tile kt is consumed before its buffers are refilled
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float s = scale[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        float* out = y + static_cast<size_t>(m) * N;
        if (n < N) out[n] = static_cast<float>(acc[i][j][2 * h]) * s;
        if (n + 1 < N) out[n + 1] = static_cast<float>(acc[i][j][2 * h + 1]) * s;
      }
    }
  }
}

template <int M, int SPLIT, bool VEC>
cudaError_t launch_cluster(const int8_t* x, const uint8_t* w, const float* sc, float* out,
                           int N, int K, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kSmallCols - 1) / kSmallCols, SPLIT);
  cfg.blockDim = dim3(kSmallThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = SPLIT;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tlmm_split_k<M, SPLIT, VEC>, x, w, sc, out, N, K);
}

template <int M>
cudaError_t launch_split_k(int split, bool vec, const int8_t* x, const uint8_t* w,
                           const float* sc, float* out, int N, int K, cudaStream_t s) {
  if (split == 4)
    return vec ? launch_cluster<M, 4, true>(x, w, sc, out, N, K, s)
               : launch_cluster<M, 4, false>(x, w, sc, out, N, K, s);
  return vec ? launch_cluster<M, 8, true>(x, w, sc, out, N, K, s)
             : launch_cluster<M, 8, false>(x, w, sc, out, N, K, s);
}

template <int WM>
void launch_mma(bool fast, const int8_t* x, const uint8_t* w, const float* sc, float* out,
                int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + WM * 64 - 1) / (WM * 64));
  if (fast) tlmm_mma<WM, true><<<grid, WM * 128, 0, s>>>(x, w, sc, out, M, N, K);
  else tlmm_mma<WM, false><<<grid, WM * 128, 0, s>>>(x, w, sc, out, M, N, K);
}

// M <= 8: the cluster kernel for this M, K split `split` (4 or 8) ways.
int split_k_launch(const void* xq, const void* wp, const void* scale, void* y, int M, int N,
                   int K, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  cudaError_t e;
  switch (M) {
    case 1: e = launch_split_k<1>(split, vec, x, w, sc, out, N, K, s); break;
    case 2: e = launch_split_k<2>(split, vec, x, w, sc, out, N, K, s); break;
    case 3: e = launch_split_k<3>(split, vec, x, w, sc, out, N, K, s); break;
    case 4: e = launch_split_k<4>(split, vec, x, w, sc, out, N, K, s); break;
    case 5: e = launch_split_k<5>(split, vec, x, w, sc, out, N, K, s); break;
    case 6: e = launch_split_k<6>(split, vec, x, w, sc, out, N, K, s); break;
    case 7: e = launch_split_k<7>(split, vec, x, w, sc, out, N, K, s); break;
    case 8: e = launch_split_k<8>(split, vec, x, w, sc, out, N, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x (M,K) contiguous, f32 (dtype 0) or bf16 (dtype 1), K % 4 == 0; beta a
// device f32 scalar; x_q (M,K) int8; scale (M,) f32.  Launches on `stream`.
extern "C" int act_quant_launch(const void* x, int dtype, const void* beta, void* xq,
                                void* scale, int M, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(scale);
  if (K % 4 != 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    act_quant<float><<<M, kAqThreads, 0, s>>>(static_cast<const float*>(x), b, q, sc, K, eps);
  else if (dtype == 1)
    act_quant<uint16_t><<<M, kAqThreads, 0, s>>>(static_cast<const uint16_t*>(x), b, q, sc, K, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x_q (M,K) int8 contiguous with M >= 1 and K % 4 == 0; w_packed (K/4,N)
// uint8 contiguous; scale (M,) f32; y (M,N) f32.  M <= 8 runs the cluster
// split-K kernel, larger M the tensor-core kernel with 128-row tiles where
// that still gives a full wave of blocks, else 64.  Launches on `stream`.
extern "C" int tlmm_launch(const void* xq, const void* wp, const void* scale, void* y,
                           int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int KW = K / 4;
  if (M <= 8 && M * ((KW + kMaxSplit - 1) / kMaxSplit) <= kSmallXWords) {
    // split K 8 ways, or 4 where that still gives a full wave of blocks
    // and each block at least 96 packed rows
    const int cols = (N + kSmallCols - 1) / kSmallCols;
    const int split = (cols * 4 >= 132 && KW / 4 >= 96 && M * (KW / 4 + 1) <= kSmallXWords) ? 4 : 8;
    return split_k_launch(xq, wp, scale, y, M, N, K, split, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  const bool fast = K % 16 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  if (((M + 127) / 128) * ((N + kBN - 1) / kBN) >= 132) launch_mma<2>(fast, x, w, sc, out, M, N, K, s);
  else launch_mma<1>(fast, x, w, sc, out, M, N, K, s);
  return static_cast<int>(cudaGetLastError());
}
