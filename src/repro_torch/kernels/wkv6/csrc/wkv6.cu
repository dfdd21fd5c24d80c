// K6: the RWKV6 ("Finch") recurrence, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv6_fwd` (_wkv6_kernel,
// src/repro/kernels/wkv6/wkv6.py:111): from a zero state, for each batch b
// and head h,
//
//     y_t = r_t . (S_{t-1} + (u * k_t)^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// returning y (B, T, H, V) in the input dtype and the final state
// (B, H, K, V) in float32, with the wrapper's clamp w >= e^-20 applied as
// the values are read (repro/kernels/wkv6/ops.py).
//
// Bound on the H100 (SXM data sheet rates at its 700 W limit): at the
// serving prefill's shapes (B = 1, T = 128, H = 32, K = V = 64, bf16) the
// function moves 3.15 MB (0.94 us at 3.35 TB/s); the recurrence needs
// 5*K*V + 3*K + 2*V operations per step and head, 85.2 MFLOP (1.27 us at
// 67 TFLOP/s in float32; the TPU kernel's chunked form does 100.7 MFLOP),
// so it is bound by operations, and any real time is latency: T
// sequential steps.
//
// Design (simple and right first):
//   * the TPU kernel's closed form per chunk divides by the in-chunk
//     cumulative decay, which overflows float32 once the decay passes
//     e^-88 (five steps at the clamp). This kernel runs the recurrence
//     step by step instead, so every factor is a product of decays <= 1
//     and nothing overflows; its per-element arithmetic (k*v, u*kv,
//     S + u*kv, w*S + kv) rounds as the plain version's does, so the
//     state agrees with it bit for bit and y differs only in the order of
//     its sum over K;
//   * column v of S and of y needs only column v of v, so the V columns
//     are split across blocks: one block per (16 columns, head, batch),
//     B*H*4 blocks (128 at the prefill's shape) with no communication
//     between them. Inside a block, 16 threads share a column, each
//     holding 4 of its K state rows in registers, and the sum over K of
//     r . S is closed with warp shuffles;
//   * r, k, w (clamped) and the block's v columns are staged in shared
//     memory as float32, 32 steps at a time, read through element strides
//     (K contiguous), so the model's (B, T, H, K) views go in without a
//     copy; y is staged per chunk and written coalesced. A ragged last
//     chunk simply stops at T: the padding of the JAX wrapper (w = 1,
//     k = v = 0) would leave the state unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;                 // K = V = 64: the repo's only head size
constexpr int KSUB = 16;               // threads that share one state column
constexpr int KPT = HD / KSUB;         // state rows per thread
constexpr int COLS = 16;               // state columns per block
constexpr int THREADS = COLS * KSUB;   // 256
constexpr int CHUNK = 32;              // steps staged in shared memory at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, t, h;  // element strides; the last dim (K or V) is contiguous
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ s_out, Strides rs, Strides ks, Strides vs,
            Strides ws, int t_len, int heads, float w_min) {
  __shared__ float r_s[CHUNK][HD];
  __shared__ float k_s[CHUNK][HD];
  __shared__ float w_s[CHUNK][HD];
  __shared__ float v_s[CHUNK][COLS];
  __shared__ float y_s[CHUNK][COLS];

  const int tid = threadIdx.x;
  const int ksub = tid % KSUB;  // lanes of one column are neighbours in a warp
  const int col = tid / KSUB;
  const int v0 = blockIdx.x * COLS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* wb = w + b * ws.b + h * ws.h;

  // This thread's state rows are kk = ksub + KSUB * j: a warp's reads of
  // one staged row fall on KSUB consecutive words (no bank conflicts).
  float uk[KPT], s[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    uk[j] = u[h * HD + ksub + KSUB * j];
    s[j] = 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += CHUNK) {
    const int n = min(CHUNK, t_len - t0);
    __syncthreads();  // the previous chunk's stage and y_s are consumed
    for (int i = tid; i < n * HD; i += THREADS) {
      const int tt = i / HD, kk = i % HD;
      const long long t = t0 + tt;
      r_s[tt][kk] = to_f(rb[t * rs.t + kk]);
      k_s[tt][kk] = to_f(kb[t * ks.t + kk]);
      w_s[tt][kk] = fmaxf(to_f(wb[t * ws.t + kk]), w_min);
    }
    for (int i = tid; i < n * COLS; i += THREADS) {
      const int tt = i / COLS, c = i % COLS;
      v_s[tt][c] = to_f(vb[static_cast<long long>(t0 + tt) * vs.t + v0 + c]);
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vt = v_s[tt][col];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = ksub + KSUB * j;
        const float kv = __fmul_rn(k_s[tt][kk], vt);
        acc = fmaf(r_s[tt][kk], __fadd_rn(s[j], __fmul_rn(uk[j], kv)), acc);
        s[j] = __fadd_rn(__fmul_rn(w_s[tt][kk], s[j]), kv);
      }
#pragma unroll
      for (int off = KSUB / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (ksub == 0) y_s[tt][col] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * COLS; i += THREADS) {
      const int tt = i / COLS, c = i % COLS;
      const long long row = (static_cast<long long>(b) * t_len + t0 + tt) * heads + h;
      y[row * HD + v0 + c] = from_f<T>(y_s[tt][c]);
    }
  }

  float* sb = s_out + (static_cast<long long>(b) * heads + h) * HD * HD;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    sb[(ksub + KSUB * j) * HD + v0 + col] = s[j];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, void* y, float* s_out, int b, int t, int h,
                   Strides rs, Strides ks, Strides vs, Strides ws, float w_min,
                   cudaStream_t stream) {
  const dim3 grid(HD / COLS, h, b);
  wkv6_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, static_cast<T*>(y), s_out, rs, ks, vs, ws, t, h,
      w_min);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u (H, K) and the
// final state (B, H, K, V) are float32, y and the state contiguous. Strides
// in elements per (batch, time, head), the last dim contiguous. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for shapes the
// kernel does not take (K = V = 64 only).
extern "C" int fedfog_wkv6_fwd(
    const void* r, const void* k, const void* v, const void* w, const float* u,
    void* y, float* s_out, int dtype, int b, int t, int h, int dk, int dv,
    long long rsb, long long rst, long long rsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh, long long wsb,
    long long wst, long long wsh, float w_min, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || dk != HD || dv != HD) return cudaErrorInvalidValue;
  const Strides rs{rsb, rst, rsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      ws{wsb, wst, wsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, y, s_out, b, t, h, rs, ks, vs, ws, w_min, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, y, s_out, b, t, h, rs, ks, vs, ws,
                                 w_min, st);
  return cudaErrorInvalidValue;
}
