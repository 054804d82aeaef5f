// Ternary table-lookup matmul (TLMM) for Hopper.
//
// Replaces: src/repro/kernels/tlmm/kernel.py :: tlmm_pallas (_tlmm_kernel,
// _decode_ternary_tile), the TPU kernel behind every linear of the
// W1.58-A8 model in both phases.
//
// Computes y[M,N] = float(sum_k x_q[m,k] * w[k,n]) * scale[m], where x_q is
// int8 (M,K) row-major, w is ternary and arrives 2-bit packed as uint8
// (K/4,N) (value k = 4j+i in bits [2i,2i+2) of byte j; codes 00 -> 0,
// 01 -> +1, 10 -> -1, 11 -> 0), and scale is f32 (M,) = act_scale * beta.
// The sum is an exact int32; the epilogue rounds once, as the TPU kernel
// does, so the result is bit-identical to the plain version.
//
// What bounds it on the H100: in decode (M = 1..8 slots) the packed weight
// bytes, K*N/4, over 3.35 TB/s, a few microseconds at most, so launch
// overhead and the number of blocks in flight dominate; in prefill
// (M = 64..2048) the int8 multiply-adds, 2*M*K*N operations.
//
// Design: one packed byte holds four consecutive K values of one column,
// which is exactly one __dp4a against the int32 word x_q[m, 4j:4j+4].  The
// byte is decoded to a char4 word in registers (no unpacked weight ever
// exists in device memory: 0.25 B/weight is what is streamed).
//  * tlmm_small_m (M <= 8): 32 lanes x 4 columns per block = 128 columns,
//    16 warps split K, each thread keeping 8 weight loads in flight (the
//    stream is round-trip bound at these sizes); partial int32 sums meet in
//    shared memory.  No 64/128-row tile is launched for a handful of rows.
//  * tlmm_tiled (M > 8): 64x64 output tile per 256-thread block, 4x4 per
//    thread, K walked 64 values at a time through shared memory (x words and
//    decoded weight words), M/N/K edges masked in the kernel (no padding).
// Tensor-core int8 MMA (wgmma) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int decode4(uint32_t byte) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = (byte >> (2 * i)) & 3u;
    const uint32_t v = c == 1u ? 0x01u : (c == 2u ? 0xFFu : 0u);
    w |= static_cast<int>(v << (8 * i));
  }
  return w;
}

constexpr int kSmallMaxM = 8;
constexpr int kSmallCols = 128;  // 32 lanes x 4 columns
constexpr int kSmallSplit = 16;  // warps splitting K
constexpr int kSmallBatch = 8;   // packed rows each thread loads before using them
constexpr int kSmallXWords = 8192;  // x_q staged in shared memory: M*K <= 32 KB

// Four packed bytes: columns nb..nb+3 of packed row j.  VEC (N % 4 == 0,
// aligned rows) is one predicated 4-byte load with no branch, so a batch of
// them stays in flight together; otherwise four byte loads, zero past N.
template <bool VEC>
__device__ __forceinline__ uint32_t load_cols4(const uint8_t* __restrict__ wp, int j, int N,
                                               int nb) {
  const uint8_t* row = wp + static_cast<size_t>(j) * N;
  if (VEC) return nb < N ? *reinterpret_cast<const uint32_t*>(row + nb) : 0u;
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    r |= (nb + c < N ? static_cast<uint32_t>(row[nb + c]) : 0u) << (8 * c);
  return r;
}

// M <= 8 rows (the decode slots).  The packed weight is read once, so the
// kernel is a stream of K*N/4 bytes too short to reach bandwidth: it is
// bounded by round trips to memory.  x_q is staged in shared memory first,
// each thread then issues kSmallBatch independent weight loads before it
// uses any of them, and 16 warps split K.
template <bool VEC>
__global__ void __launch_bounds__(32 * kSmallSplit)
tlmm_small_m(const int8_t* __restrict__ xq, const uint8_t* __restrict__ wp,
             const float* __restrict__ scale, float* __restrict__ y,
             int M, int N, int K) {
  __shared__ int xs[kSmallXWords];
  __shared__ int red[kSmallSplit][kSmallCols];
  const int lane = threadIdx.x;
  const int ks = threadIdx.y;
  const int tid = ks * 32 + lane;
  const int nb = blockIdx.x * kSmallCols + lane * 4;
  const int KW = K / 4;
  const int* x32 = reinterpret_cast<const int*>(xq);
  for (int e = tid; e < M * KW; e += 32 * kSmallSplit) xs[e] = x32[e];
  __syncthreads();
  int acc[kSmallMaxM][4];
#pragma unroll
  for (int m = 0; m < kSmallMaxM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  for (int j0 = ks; j0 < KW; j0 += kSmallSplit * kSmallBatch) {
    uint32_t wb[kSmallBatch];
#pragma unroll
    for (int b = 0; b < kSmallBatch; ++b) {
      const int j = j0 + b * kSmallSplit;
      wb[b] = j < KW ? load_cols4<VEC>(wp, j, N, nb) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kSmallBatch; ++b) {
      const int j = j0 + b * kSmallSplit;
      int w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = decode4((wb[b] >> (8 * c)) & 0xFFu);
#pragma unroll
      for (int m = 0; m < kSmallMaxM; ++m) {
        if (m < M && j < KW) {
          const int a = xs[m * KW + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = __dp4a(a, w[c], acc[m][c]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kSmallMaxM; ++m) {
    if (m >= M) break;  // M is the same for the whole block
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ks][lane * 4 + c] = acc[m][c];
    __syncthreads();
    if (tid < kSmallCols) {
      int sum = 0;
#pragma unroll
      for (int r = 0; r < kSmallSplit; ++r) sum += red[r][tid];
      const int n = blockIdx.x * kSmallCols + tid;
      if (n < N) y[static_cast<size_t>(m) * N + n] = static_cast<float>(sum) * scale[m];
    }
    __syncthreads();
  }
}

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 16;  // K words (4 values each) per tile: 64 K values
constexpr int kTiledThreads = 256;

__global__ void __launch_bounds__(kTiledThreads)
tlmm_tiled(const int8_t* __restrict__ xq, const uint8_t* __restrict__ wp,
           const float* __restrict__ scale, float* __restrict__ y,
           int M, int N, int K) {
  __shared__ int xs[kBM][kBKW + 1];
  __shared__ int ws[kBKW][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int KW = K / 4;
  const int* x32 = reinterpret_cast<const int*>(xq);
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kw0 = 0; kw0 < KW; kw0 += kBKW) {
    for (int e = tid; e < kBM * kBKW; e += kTiledThreads) {
      const int r = e / kBKW, c = e % kBKW;
      const int m = m0 + r, j = kw0 + c;
      xs[r][c] = (m < M && j < KW) ? x32[static_cast<size_t>(m) * KW + j] : 0;
    }
    for (int e = tid; e < kBKW * kBN; e += kTiledThreads) {
      const int r = e / kBN, c = e % kBN;
      const int j = kw0 + r, n = n0 + c;
      ws[r][c] = (j < KW && n < N) ? decode4(wp[static_cast<size_t>(j) * N + n]) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s = scale[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = static_cast<float>(acc[i][j]) * s;
    }
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// x_q (M,K) int8 contiguous with K % 4 == 0; w_packed (K/4,N) uint8
// contiguous; scale (M,) f32; y (M,N) f32.  Launches on `stream`.
extern "C" int tlmm_launch(const void* xq, const void* wp, const void* scale, void* y,
                           int M, int N, int K, void* stream) {
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(wp) % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(wp);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  if (M <= kSmallMaxM && M * (K / 4) <= kSmallXWords) {
    dim3 grid((N + kSmallCols - 1) / kSmallCols);
    dim3 block(32, kSmallSplit);
    if (vec) tlmm_small_m<true><<<grid, block, 0, s>>>(x, w, sc, out, M, N, K);
    else tlmm_small_m<false><<<grid, block, 0, s>>>(x, w, sc, out, M, N, K);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    tlmm_tiled<<<grid, kTiledThreads, 0, s>>>(x, w, sc, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
