// Single-token decode attention over the KV cache (the decode engine) for
// Hopper.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_pallas (_decode_kernel).
//
// Computes, for each sequence b and KV head hk, the attention of its G
// grouped query heads q (B,Hkv,G,D) f32 over cache positions
// [start_b, length_b) of k/v (B,Hkv,S,D), returning the normalized output
// (B,Hkv,G,D) f32 plus the softmax statistics l and m (B,Hkv,G) f32 that
// the caller uses to fold in the freshly projected token.  K/V are upcast
// to f32 and q stays f32, as in the TPU kernel.  An empty range gives
// out 0, l 0 and m -1e30.
//
// What bounds it on the H100: the cache bytes of the live positions,
// 2 * sum_b (length_b - start_b) * Hkv * D * sizeof(T), over 3.35 TB/s;
// the operations (4*G*D per position) are far below the FMA rate.
//
// Design: one 256-thread block per (b, hk), eight warps taking 32-position
// chunks of [start, length) in turn, so chunks past the length are never
// read (the TPU kernel's block skip).  In a chunk each lane scores one
// position (16-byte loads along its K row, q broadcast from shared memory),
// the warp reduces max and sum with shuffles, and then each lane owns D/32
// output dimensions and accumulates p * V row by row, so V is read with
// neighbouring lanes on neighbouring addresses, eight rows' loads in flight
// at once.  The eight warps' (m, l, acc) are merged once in shared memory.  The cache is read through its
// (batch, head, position) strides: the per-layer slice cache[:, li] of the
// batch-leading (B,L,Hkv,S,D) cache is used where it lies, never copied.
// A split over positions across blocks (for few sequences with long
// contexts) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
};

template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_attn(const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ lengths, const int* __restrict__ starts,
            float* __restrict__ out, float* __restrict__ l_out, float* __restrict__ m_out,
            int Hkv, int G, int S,
            long long ksb, long long ksh, long long kss,
            long long vsb, long long vsh, long long vss, float sm_scale) {
  constexpr int DL = D / 32;  // output dimensions per lane
  constexpr int VN = Vec<T>::N;
  __shared__ float qs[MAXG][D];
  __shared__ float wm[kWarps][MAXG];
  __shared__ float wl[kWarps][MAXG];
  __shared__ float wacc[kWarps][MAXG][D];
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = min(lengths[b], S);
  const int st = starts != nullptr ? max(starts[b], 0) : 0;
  const long long bh = static_cast<long long>(b) * Hkv + hk;

  for (int e = tid; e < G * D; e += kThreads) qs[e / D][e % D] = q[bh * G * D + e];
  __syncthreads();

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
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
      const T* kr = kb + pos * kss;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VN) {
        float kf[VN];
        Vec<T>::load(kr + d0, kf);
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
    // issued before any is used, so the walk is not one round trip per row
    const int hi = min(32, len - c * 32);
    for (int kk0 = max(st - c * 32, 0); kk0 < hi; kk0 += kVBatch) {
      float vv[kVBatch][DL];
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const int kk = kk0 + u;
        const T* vr = vb + (c * 32 + kk) * vss;
#pragma unroll
        for (int i = 0; i < DL; ++i) vv[u][i] = kk < hi ? Vec<T>::one(vr + lane + 32 * i) : 0.f;
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

template <typename T, int D, int MAXG>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            const void* starts, void* out, void* l, void* m, int B, int Hkv, int G, int S,
            const long long* st, float sm_scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_attn<T, D, MAXG><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<float*>(out), static_cast<float*>(l), static_cast<float*>(m), Hkv, G, S,
      st[0], st[1], st[2], st[3], st[4], st[5], sm_scale);
}

template <typename T, int D>
int dispatch_g(const void* q, const void* k, const void* v, const void* lengths,
               const void* starts, void* out, void* l, void* m, int B, int Hkv, int G, int S,
               const long long* st, float sm_scale, cudaStream_t stream) {
  if (G <= 1) launch<T, D, 1>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
  else if (G <= 2) launch<T, D, 2>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
  else if (G <= 4) launch<T, D, 4>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
  else if (G <= 8) launch<T, D, 8>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* lengths,
               const void* starts, void* out, void* l, void* m, int B, int Hkv, int G, int S,
               const long long* st, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B,Hkv,G,D) f32 contiguous; k/v (B,Hkv,S,D) bf16 (kv_bf16 != 0) or f32
// with unit stride along D, 16-byte aligned rows and the given (batch, head,
// position) strides in elements; lengths (B,) int32; starts (B,) int32 or
// null; out (B,Hkv,G,D), l and m (B,Hkv,G) f32 contiguous.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, const void* starts,
    void* out, void* l, void* m, int B, int Hkv, int G, int S, int D, int kv_bf16,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, float sm_scale, void* stream) {
  const long long st[6] = {ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = kv_bf16
      ? dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, s)
      : dispatch_d<float>(D, q, k, v, lengths, starts, out, l, m, B, Hkv, G, S, st, sm_scale, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
