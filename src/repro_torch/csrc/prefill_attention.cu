// Causal prefill attention (the prefill engine) for Hopper.
//
// Replaces: src/repro/kernels/prefill_attention/kernel.py ::
// prefill_attention_pallas (_prefill_kernel).
//
// Computes out[b,h,q,:] = softmax_k<=q(q.k * sm_scale) . v for q (B,H,S,D),
// k/v (B,Hkv,S,D), all f32, GQA head h reading KV head h / (H/Hkv).  Online
// softmax in f32 with NEG_INF = -1e30, l clamped at 1e-30, the final divide
// as in the TPU kernel; expf, never __expf.
//
// What bounds it on the H100: the operations, 4*B*H*D*S*(S+1)/2 for the
// causal half (two products per score); bytes are q, k, v and out once.
// This first version runs the products on the f32 FMA units (67 TFLOP/s
// peak), not the tensor cores.
//
// Design: one 256-thread block per (b, h, 64-row query tile); four threads
// share a query row, each owning every fourth head dimension (interleaved so
// the shared-memory reads of a K/V row hit distinct banks), and combine
// their partial dot products with two shuffles.  The block walks KV tiles
// through shared memory from the diagonal tile backwards (the TPU kernel's
// reverse schedule: the first tile carries the row maxima, so the rescale
// chain starts at the true max), and applies the causal/ragged-edge mask
// only on tiles that reach past the tile's first query row or past S.  The
// ragged S edge is masked in the kernel, never padded; inputs are read
// through strides, so the (B,S,H,D) projections need no copy.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kThreads = 256;
constexpr int kTPR = 4;  // threads per query row

template <int D, int BKV>
__global__ void __launch_bounds__(kThreads)
prefill_attn(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             int H, int Hkv, int S,
             long long qsb, long long qsh, long long qss,
             long long ksb, long long ksh, long long kss,
             long long vsb, long long vsh, long long vss, float sm_scale) {
  constexpr int DP = D / kTPR;
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int sub = tid % kTPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int qpos = q0 + row;
  const bool row_valid = qpos < S;

  const float* qp = q + b * qsb + h * qsh + static_cast<long long>(row_valid ? qpos : S - 1) * qss;
  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = qp[sub + kTPR * i];
    acc[i] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const int last = min(q0 + kBQ - 1, S - 1);

  for (int t = last / BKV; t >= 0; --t) {
    const int kv0 = t * BKV;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BKV * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int p = kv0 + r;
      ks[r][c] = p < S ? kb[p * kss + c] : 0.f;
      vs[r][c] = p < S ? vb[p * vss + c] : 0.f;
    }
    __syncthreads();
    const bool need_mask = (kv0 + BKV - 1 > q0) || (kv0 + BKV > S);
    float s[BKV];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part += qr[i] * ks[j][sub + kTPR * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float sc = part * sm_scale;
      if (need_mask) {
        const int kp = kv0 + j;
        if (kp > qpos || kp >= S) sc = kNegInf;
      }
      s[j] = sc;
      m_cur = fmaxf(m_cur, sc);
    }
    const float m_new = fmaxf(m_run, m_cur);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l_run = alpha * l_run + psum;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j)
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] += s[j] * vs[j][sub + kTPR * i];
    m_run = m_new;
  }
  if (row_valid) {
    const float l = fmaxf(l_run, 1e-30f);
    float* op = out + ((static_cast<long long>(b) * H + h) * S + qpos) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[sub + kTPR * i] = acc[i] / l;
  }
}

template <int D, int BKV>
void launch(const float* q, const float* k, const float* v, float* out, int B, int H,
            int Hkv, int S, const long long* st, float sm_scale, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  prefill_attn<D, BKV><<<grid, kThreads, 0, stream>>>(
      q, k, v, out, H, Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], sm_scale);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B,H,S,D), k/v (B,Hkv,S,D) f32 with unit stride along D and the given
// (batch, head, position) strides in elements; out (B,H,S,D) f32 contiguous.
extern "C" int prefill_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv, int S,
    int D, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, float sm_scale,
    void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32, 64>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s); break;
    case 64: launch<64, 64>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s); break;
    case 128: launch<128, 32>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
