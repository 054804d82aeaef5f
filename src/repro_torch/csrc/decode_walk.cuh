// The one-query decode attention walk of the contiguous decode kernels
// (decode_attention.cu: B3 over a bf16/f32 cache, B4 over a quantized one).
// paged_attention.cu (B5, B6) walks pages with paged_walk.cuh, which uses
// the element formats of this header.
//
// For each sequence b and KV head hk (one 256-thread block each), the walk
// computes the attention of the G grouped query heads q (B,Hkv,G,D) f32 over
// cache positions [start_b, length_b), returning the normalized output
// (B,Hkv,G,D) f32 and the softmax statistics l and m (B,Hkv,G) f32 that the
// caller uses to fold in the freshly projected token.  An empty range gives
// out 0, l 0 and m -1e30.
//
// It is templated on two things:
//
// * the row source, `Strided`: the slot (b, hk, pos) of a batch-leading
//   cache through its strides (the per-layer slice cache[:, li] is used
//   where it lies);
// * the element format: bf16, f32, int8 with an f32 scale per row, or int4
//   nibble pairs (even index in the low nibble) with an f32 scale per row.
//   Quantized rows are dequantized in registers as (float)q * scale[row],
//   the TPU kernels' _dequant_tile; no f32 copy of the cache is ever
//   written to global memory.
//
// Design (B3's): eight warps take 32-position chunks of [start, length) in
// turn, so chunks past the length are never read (the TPU kernels' block
// skip).  In a chunk each lane scores one position (16-byte loads
// along its K row, q broadcast from shared memory), the warp reduces max and
// sum with shuffles, and then each lane owns D/32 output dimensions and
// accumulates p * V row by row, so V is read with neighbouring lanes on
// neighbouring addresses, eight rows' loads in flight at once.  The eight
// warps' (m, l, acc) are merged once in shared memory.
//
// What bounds it on the H100: the bytes of the live positions' rows (payload
// plus, when quantized, the 4-byte scale) over 3.35 TB/s; the operations
// (4*G*D per position) are far below the FMA rate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_walk {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVBatch = 8;  // V rows loaded before use

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- element formats: T is the storage type, N the elements in 16 bytes;
// load() converts the N elements starting at element d0 of a row, one() the
// element d.  Unscaled formats ignore the scale.

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr bool kScaled = false;
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const T* row, int d0, float, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float one(const T* row, int d, float) {
    return __bfloat162float(row[d]);
  }
};

struct F32 {
  using T = float;
  static constexpr bool kScaled = false;
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const T* row, int d0, float, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(row + d0);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
  __device__ __forceinline__ static float one(const T* row, int d, float) { return row[d]; }
};

struct Int8 {
  using T = int8_t;
  static constexpr bool kScaled = true;
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const T* row, int d0, float scale, float* out) {
    const int4 raw = *reinterpret_cast<const int4*>(row + d0);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]) * scale;
  }
  __device__ __forceinline__ static float one(const T* row, int d, float scale) {
    return static_cast<float>(row[d]) * scale;
  }
};

struct Int4 {
  using T = uint8_t;  // a row holds D/2 bytes
  static constexpr bool kScaled = true;
  static constexpr int N = 32;
  __device__ __forceinline__ static float lo(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4);
  }
  __device__ __forceinline__ static float hi(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(b) >> 4);
  }
  __device__ __forceinline__ static void load(const T* row, int d0, float scale, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0 / 2);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      out[2 * i] = lo(b[i]) * scale;
      out[2 * i + 1] = hi(b[i]) * scale;
    }
  }
  __device__ __forceinline__ static float one(const T* row, int d, float scale) {
    const uint8_t b = row[d >> 1];
    return ((d & 1) ? hi(b) : lo(b)) * scale;
  }
};

// ---- the row source: offsets (in storage elements, and in floats for the
// scale planes) of position pos of sequence b, head hk.  Strides are
// [K payload, V payload, K scale, V scale] x [outer, head, position].

struct Strided {
  long long st[4][3];  // outer = batch
  int S;               // positions a slot holds
  __device__ __forceinline__ long long at(int which, int b, int hk, int pos) const {
    return b * st[which][0] + hk * st[which][1] + pos * st[which][2];
  }
};

__host__ __device__ __forceinline__ int capacity(const Strided& s) { return s.S; }

template <class Fmt, class Src, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
walk(const float* __restrict__ q, const typename Fmt::T* __restrict__ k,
     const typename Fmt::T* __restrict__ v, const float* __restrict__ k_scale,
     const float* __restrict__ v_scale, const Src src, const int* __restrict__ lengths,
     const int* __restrict__ starts, float* __restrict__ out, float* __restrict__ l_out,
     float* __restrict__ m_out, int Hkv, int G, float sm_scale) {
  using T = typename Fmt::T;
  constexpr int DL = D / 32;  // output dimensions per lane
  constexpr int VN = Fmt::N;
  __shared__ float qs[MAXG][D];
  __shared__ float wm[kWarps][MAXG];
  __shared__ float wl[kWarps][MAXG];
  __shared__ float wacc[kWarps][MAXG][D];
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = min(lengths[b], capacity(src));
  const int st = starts != nullptr ? max(starts[b], 0) : 0;
  const long long bh = static_cast<long long>(b) * Hkv + hk;

  for (int e = tid; e < G * D; e += kThreads) qs[e / D][e % D] = q[bh * G * D + e];
  __syncthreads();

  float m_run[MAXG], l_run[MAXG], acc[MAXG][DL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[g][i] = 0.f;
  }

  const int c_end = (len + 31) / 32;
  for (int c = st / 32 + warp; c < c_end; c += kWarps) {
    const int pos = c * 32 + lane;
    const bool valid = pos >= st && pos < len;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = k + src.at(0, b, hk, pos);
      const float ksc = Fmt::kScaled ? k_scale[src.at(2, b, hk, pos)] : 1.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VN) {
        float kf[VN];
        Fmt::load(kr, d0, ksc, kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VN; ++e) s[g] += qs[g][d0 + e] * kf[e];
          }
        }
      }
    }
    float p[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      p[g] = 0.f;
      if (g < G) {
        const float sc = valid ? s[g] * sm_scale : kNegInf;
        const float m_new = fmaxf(m_run[g], warp_max(sc));
        const float alpha = expf(m_run[g] - m_new);
        p[g] = valid ? expf(sc - m_new) : 0.f;
        l_run[g] = alpha * l_run[g] + warp_sum(p[g]);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] *= alpha;
        m_run[g] = m_new;
      }
    }
    // V rows of the chunk, kVBatch at a time: the loads of a batch are all
    // issued before any is used, so the walk is not one round trip per row.
    // Rows past the chunk's end read the last live row instead (an address
    // that is always valid, in every row source) and count as 0, so the
    // loads need no branch between them.
    const int hi = min(32, len - c * 32);
    for (int kk0 = max(st - c * 32, 0); kk0 < hi; kk0 += kVBatch) {
      float vv[kVBatch][DL];
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const int kk = kk0 + u;
        const int vpos = c * 32 + min(kk, hi - 1);
        const T* vr = v + src.at(1, b, hk, vpos);
        const float vsc = Fmt::kScaled ? v_scale[src.at(3, b, hk, vpos)] : 1.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const float x = Fmt::one(vr, lane + 32 * i, vsc);
          vv[u][i] = kk < hi ? x : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const float pg = __shfl_sync(0xffffffffu, p[g], (kk0 + u) & 31);
          if (g < G && kk0 + u < hi) {
#pragma unroll
            for (int i = 0; i < DL; ++i) acc[g][i] += pg * vv[u][i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm[warp][g] = m_run[g];
        wl[warp][g] = l_run[g];
      }
#pragma unroll
      for (int i = 0; i < DL; ++i) wacc[warp][g][lane + 32 * i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w][g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w][g] - m);
      l += wl[w][g] * f;
      a += wacc[w][g][d] * f;
    }
    out[(bh * G + g) * D + d] = a / fmaxf(l, 1e-30f);
    if (d == 0) {
      l_out[bh * G + g] = l;
      m_out[bh * G + g] = m;
    }
  }
}

// Launch arguments common to every instantiation.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;  // null for unscaled formats
  const void* v_scale;
  const void* lengths;
  const void* starts;  // null: every start is 0
  void* out;
  void* l;
  void* m;
  int B, Hkv, G;
  float sm_scale;
  cudaStream_t stream;
};

template <class Fmt, class Src, int D, int MAXG>
void launch(const Args& a, const Src& src) {
  using T = typename Fmt::T;
  dim3 grid(a.Hkv, a.B);
  walk<Fmt, Src, D, MAXG><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), src,
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.starts),
      static_cast<float*>(a.out), static_cast<float*>(a.l), static_cast<float*>(a.m), a.Hkv,
      a.G, a.sm_scale);
}

// Picks the head dim and the query-group bound, launches, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
template <class Fmt, class Src>
int dispatch(int D, const Args& a, const Src& src) {
  if (a.G < 1 || a.G > 8) return static_cast<int>(cudaErrorInvalidValue);
#define DECODE_WALK_G(DD)                                             \
  if (a.G <= 1) launch<Fmt, Src, DD, 1>(a, src);                      \
  else if (a.G <= 2) launch<Fmt, Src, DD, 2>(a, src);                 \
  else if (a.G <= 4) launch<Fmt, Src, DD, 4>(a, src);                 \
  else launch<Fmt, Src, DD, 8>(a, src);
  switch (D) {
    case 32: DECODE_WALK_G(32) break;
    case 64: DECODE_WALK_G(64) break;
    case 128: DECODE_WALK_G(128) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_WALK_G
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_walk
