// K5: flash-attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (_fwd_kernel,
// src/repro/kernels/flash_attention/flash_attention.py:146): forward
// attention of q (B, H, Sq, hd) against k/v (B, Hkv, Sk, hd) with an
// online softmax; causal with q rows tail-aligned (q_pos += Sk - Sq), an
// optional sliding window (0 = global), a bidirectional mode, GQA through
// kv head h / groups, and tiles that are dead by causality or window never
// loaded.
//
// Bound on the H100 (SXM data sheet rates at its 700 W limit): at the
// serving prefill's shapes (B = 1, H = 32, Hkv = 8, Sq = Sk = 128, hd = 64,
// bf16) the function moves 1.3 MB and does 68 MFLOP of causal products,
// so it is bound by bytes (0.4 us at 3.35 TB/s) long before the tensor
// cores (0.07 us at 989 TFLOP/s); any real time is launch and latency.
//
// Design (simple and right first; wgmma and TMA are later work):
//   * one block of 128 threads per (q tile of BQ = 32 rows, head, batch);
//     4 threads share a query row, each holding a quarter of its scores and
//     a quarter of its f32 output accumulator in registers;
//   * a loop over kv tiles of BKV = 32 keys staged in shared memory as f32
//     (rows padded by one word so the warp's reads fall in distinct banks),
//     from the first tile the window can reach to the last the causal mask
//     allows; the ragged edges (Sq, Sk not multiples of the tiles) are
//     masked in the tile;
//   * products on CUDA cores in f32; q is scaled by hd^-0.5 in f32 before
//     the product, as the reference does; the running max uses the
//     reference's guards (m_safe for rows with nothing live yet,
//     max(l, 1e-30) at the end);
//   * inputs are read through element strides (head_dim contiguous), so
//     the model layout (B, S, H, hd) needs no transposed copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int THREADS = 128;  // 4 threads per query row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;  // element strides; head_dim is contiguous
};

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int sq, int sk, int groups,
                 int window, int bidirectional, float scale) {
  constexpr int HDP = HD + 1;
  constexpr int BKVP = BKV + 1;
  constexpr int DPT = HD / 4;   // output dims per thread
  constexpr int CPT = BKV / 4;  // scores per thread per tile
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][HDP]
  float* k_s = q_s + BQ * HDP;    // [BKV][HDP]
  float* v_s = k_s + BKV * HDP;   // [BKV][HD]
  float* p_s = v_s + BKV * HD;    // [BQ][BKVP]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / groups;
  const int off = sk - sq;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    q_s[r * HDP + d] = qi < sq ? to_f(qb[qi * qs.s + d]) * scale : 0.f;
  }

  // Keys any row of this tile can see: [kv_lo, kv_hi).
  const int first_q = q0 + off;
  const int last_q = min(q0 + BQ, sq) - 1 + off;
  int kv_lo = 0, kv_hi = sk;
  if (!bidirectional) {
    kv_hi = min(sk, last_q + 1);
    if (window > 0) kv_lo = max(0, first_q - window + 1);
  }
  const int t_lo = kv_lo / BKV;
  const int t_hi = kv_hi > 0 ? (kv_hi + BKV - 1) / BKV : 0;

  const int my_q = first_q + row;
  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // q_s written / the previous tile consumed
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const int kj = k0 + c;
      const bool in = kj < sk;
      k_s[c * HDP + d] = in ? to_f(kb[kj * ks.s + d]) : 0.f;
      v_s[c * HD + d] = in ? to_f(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = sub + 4 * j;
      const int kp = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(q_s[row * HDP + d], k_s[c * HDP + d], dot);
      bool vis = kp < sk;
      if (!bidirectional) {
        vis = vis && kp <= my_q;
        if (window > 0) vis = vis && (my_q - kp) < window;
      }
      s[j] = vis ? dot : NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
    const float corr = expf((m <= NEG_INF * 0.5f ? NEG_INF : m) - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(s[j] - m_safe);
      psum += p;
      p_s[row * BKVP + sub + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's p_s is written and read by its own 4 lanes
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = sub + 4 * j;
      float a = acc[j] * corr;
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) a = fmaf(p_s[row * BKVP + c], v_s[c * HD + d], a);
      acc[j] = a;
    }
  }

  const int qi = q0 + row;
  if (qi < sq) {
    T* ob = o + b * os.b + h * os.h + qi * os.s;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[sub + 4 * j] = from_f<T>(acc[j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int h, int hkv, int sq, int sk, Strides qs, Strides ks,
                   Strides vs, Strides os, int window, int bidirectional,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, sq, sk, h / hkv, window, bidirectional,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int b, int h, int hkv, int sq, int sk, Strides qs,
                        Strides ks, Strides vs, Strides os, int window,
                        int bidirectional, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 32: return launch<T, 32>(q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 64: return launch<T, 64>(q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 128: return launch<T, 128>(q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, per (batch, head,
// sequence); head_dim contiguous. Returns cudaGetLastError() of the launch.
extern "C" int fedfog_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int h, int hkv, int sq, int sk, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int window, int bidirectional, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
  return cudaErrorInvalidValue;
}
