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
// causal half (two products per score).  On the tensor cores at f32
// accuracy (3xTF32, below) that is three TF32 products each, over 495
// TFLOP/s; bytes are q, k, v and out once.  In practice the last query
// tiles' walks over the whole prefix, one dependent MMA chain after
// another, set the time.
//
// Design (FlashAttention-2 on mma.sync): one 128-thread block per (b, h,
// 64-row query tile), the longest tiles scheduled first; each of its 4
// warps owns 16 query rows.  Both products run on the tensor cores as
// mma.sync m16n8k8 TF32 with the 3xTF32 split: each f32 operand x becomes
// hi = tf32(x), lo = tf32(x - hi), and a.b = lo.hi + hi.lo + hi.hi (the
// lo.lo term is below f32's last bit).  The three products of each 8-wide
// step go into a zeroed accumulator that is added to the running f32 sum:
// chained through the MMA accumulator, the tensor cores' truncating
// additions left errors of 5e-6 that flipped the next layer's int8
// roundings.  The scores stay in the MMA accumulators; the online softmax
// works on them (row max and sum over a quad of lanes by shuffles).  The
// P.V product takes P straight from those accumulators: its k index walks
// the KV rows of an 8-row group in the order 0,2,4,6,1,3,5,7, which is the
// order in which the accumulator layout holds them, so no shuffle is
// needed; V's B fragment reads its rows in the same order.  K/V tiles (64
// rows, or 32 for D = 64 past S = 512, which fits four blocks an SM) come
// in by cp.async, double-buffered.  The block walks KV tiles from the
// diagonal tile backwards (the TPU kernel's reverse schedule: the first
// tile carries the row maxima), applies the causal/ragged-edge mask only
// on tiles that reach past the tile's first query row or past S, and a
// warp skips the 8-column groups of a tile that lie wholly past its last
// row.  The ragged S edge is masked, never padded; inputs are read through
// strides, so the (B,S,H,D) projections need no copy (16-byte aligned
// K/V rows: the wrapper checks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kThreads = 128;

// x -> hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away,
// as cvt.rna) by integer adds on the bits: full-rate ALU work in place of
// the conversion unit.  The MMA reads only a TF32 operand's top 19 bits,
// so lo is left unmasked.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32 (lo.hi + hi.lo + hi.hi, the small terms first).  The
// three products go into a zeroed accumulator that one rounded f32 add then
// adds to c: the tensor cores' own accumulation truncates, and chained over
// a long walk that bias, not the split, set the error (5e-6 at S=2048 and
// flipped int8 roundings downstream; 1e-6 this way).
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Q, and K and V tiles twice (double-buffered), rows padded to D + 4 words
template <int D, int BKV>
constexpr int smem_bytes() {
  return (kBQ + 4 * BKV) * (D + 4) * 4;
}

template <int D, int BKV>
__global__ void __launch_bounds__(kThreads)
prefill_attn(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             int H, int Hkv, int S,
             long long qsb, long long qsh, long long qss,
             long long ksb, long long ksh, long long kss,
             long long vsb, long long vsh, long long vss, float sm_scale) {
  constexpr int ST = D + 4;  // row stride in words: conflict-free fragment reads
  constexpr int NJ = BKV / 8;
  constexpr int ND = D / 8;
  constexpr int TILE = BKV * ST;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [kBQ][ST]
  float* kvs = qs + kBQ * ST;   // [2 buffers][K, V][BKV][ST]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // the longest query tiles (most KV tiles to walk) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const int last = min(q0 + kBQ - 1, S - 1);

  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * BKV;
    float* kd = kvs + 2 * buf * TILE;
    for (int e = tid; e < BKV * (D / 4); e += kThreads) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      const int p = kv0 + r;
      const bool ok = p < S;
      cp_async16(&kd[r * ST + c], ok ? kb + p * kss + c : kb, ok);
      cp_async16(&kd[TILE + r * ST + c], ok ? vb + p * vss + c : vb, ok);
    }
  };
  load_kv(last / BKV, 0);
  cp_async_commit();

  const float* qb = q + b * qsb + h * qsh;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int p = q0 + r;
    qs[r * ST + c] = p < S ? qb[p * qss + c] : 0.f;
  }

  const int r0 = warp * 16 + g;  // this lane's rows r0 and r0 + 8 of the tile
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int wlast = min(q0 + warp * 16 + 15, S - 1);  // the warp's last valid row
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  int buf = 0;
  for (int tile = last / BKV; tile >= 0; --tile) {
    if (tile > 0) load_kv(tile - 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // the tile's K/V (and, the first time, Q) have landed
    const float* kt = kvs + 2 * buf * TILE;
    const float* vt = kt + TILE;
    const int kv0 = tile * BKV;
    const int nj = min(NJ, (wlast - kv0) / 8 + 1);  // 8-column groups this warp needs
    if (wlast >= kv0) {
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const int c = kk * 8 + t;
        uint32_t ah[4], al[4];
        split(qs[r0 * ST + c], ah[0], al[0]);
        split(qs[(r0 + 8) * ST + c], ah[1], al[1]);
        split(qs[r0 * ST + c + 4], ah[2], al[2]);
        split(qs[(r0 + 8) * ST + c + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const int i0 = (j * 8 + g) * ST + c;
            uint32_t bh0, bh1, bl0, bl1;
            split(kt[i0], bh0, bl0);
            split(kt[i0 + 4], bh1, bl1);
            mma3(s[j], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
      const bool need_mask = (kv0 + BKV - 1 > q0) || (kv0 + BKV > S);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + j * 8 + 2 * t + (e & 1);
          float x = s[j][e] * sm_scale;
          if (j >= nj || (need_mask && (col > qpos[e >> 1] || col >= S))) x = kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_new[i] = fmaxf(m_run[i], mx[i]);
        alpha[i] = expf(m_run[i] - m_new[i]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m_new[e >> 1]);
          psum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
        l_run[i] = alpha[i] * l_run[i] + psum[i];
        m_run[i] = m_new[i];
      }
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] *= alpha[e >> 1];
      // O += P.V over the 8-row groups; k order 0,2,4,6,1,3,5,7 of each group
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          uint32_t ph[4], pl[4];
          split(s[j][0], ph[0], pl[0]);
          split(s[j][2], ph[1], pl[1]);
          split(s[j][1], ph[2], pl[2]);
          split(s[j][3], ph[3], pl[3]);
          const int i0 = (j * 8 + 2 * t) * ST + g;
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            uint32_t bh0, bh1, bl0, bl1;
            split(vt[i0 + d * 8], bh0, bl0);
            split(vt[i0 + ST + d * 8], bh1, bl1);
            mma3(o[d], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= S) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    float* op = out + ((static_cast<long long>(b) * H + h) * S + qpos[i]) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<float2*>(op + d * 8 + 2 * t) =
          make_float2(o[d][2 * i] / l, o[d][2 * i + 1] / l);
  }
}

template <int D, int BKV>
int launch(const float* q, const float* k, const float* v, float* out, int B, int H, int Hkv,
           int S, const long long* st, float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, BKV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attn<D, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  prefill_attn<D, BKV><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, H, Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// q (B,H,S,D), k/v (B,Hkv,S,D) f32 with unit stride along D and the given
// (batch, head, position) strides in elements; k and v 16-byte aligned with
// strides that are multiples of 4; out (B,H,S,D) f32 contiguous.
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
    case 32: return launch<32, 64>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s);
    // 64-row KV tiles for short prompts, 32-row tiles (four blocks an SM in
    // place of two) where the long walks of the last query tiles decide
    case 64: return S <= 512 ? launch<64, 64>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s)
                             : launch<64, 32>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s);
    case 128: return launch<128, 32>(qf, kf, vf, of, B, H, Hkv, S, st, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
