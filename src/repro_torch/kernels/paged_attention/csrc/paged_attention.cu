// K7: paged decode attention, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_fwd` (_decode_kernel,
// src/repro/kernels/paged_attention/paged_attention.py:159): one query
// token per slot against a physical page pool (P, page, Hkv, hd), the
// slot -> page indirection resolved in the pass through device memory
// (no gathered copy of the cache), a ragged boundary page masked with
// k_pos <= length - 1 (and q_pos - k_pos < window when window > 0), dead
// pages skipped (past the slot's length, below its window, or the whole
// slot when its length is 0), and the g query heads of a kv head scored
// together against each page, which is read once per kv head.
//
// Bound on the H100 (SXM data sheet rates at its 700 W limit): decoding
// reads each live key and value once, about 2.4 MB at the serving phase's
// shapes (8 slots of ~145 tokens, Hkv = 8, hd = 64, bf16) against
// ~10 MFLOP, so it is bound by bytes (~0.7 us at 3.35 TB/s); the kernel's
// real cost is launch and latency.
//
// Design (simple and right first):
//   * one block per (slot, kv head), one warp per query head of the group
//     (g warps); the block walks the slot's pages in order and reads the
//     page table itself; entries past the live pages may name the trash
//     page 0 and are never read;
//   * a live page's keys and values are staged in shared memory as f32;
//     lane c scores key c of the page (page <= 32), the warp reduces the
//     page's max and sum with shuffles, and each lane keeps hd/32 dims of
//     the f32 output accumulator in registers;
//   * the reference's guards: m_safe for a head with nothing live yet,
//     max(l, 1e-30) at the end, so an empty slot writes zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T, int HD>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ o, int hkv, int g, int page,
                                    int n_pages, int window, float scale) {
  constexpr int HDP = HD + 1;
  constexpr int DPL = (HD + 31) / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;               // [g][HD]
  float* k_s = q_s + g * HD;       // [page][HDP]
  float* v_s = k_s + page * HDP;   // [page][HD]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;  // query head within the group
  const int nthr = blockDim.x;
  const int length = lengths[s];
  const int q_pos = length - 1;
  const long long row_stride = static_cast<long long>(hkv) * HD;  // one token

  const T* qb = q + (static_cast<long long>(s) * hkv + h) * g * HD;
  for (int i = threadIdx.x; i < g * HD; i += nthr) q_s[i] = to_f(qb[i]) * scale;

  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int p = 0; p < n_pages; ++p) {
    const int first_k = p * page;
    bool live = first_k < length;
    if (window > 0) live = live && (first_k + page - 1) > q_pos - window;
    if (!live) continue;  // the same for every thread of the block
    const long long phys = page_table[static_cast<long long>(s) * n_pages + p];
    const T* kb = k_pages + phys * page * row_stride + static_cast<long long>(h) * HD;
    const T* vb = v_pages + phys * page * row_stride + static_cast<long long>(h) * HD;
    __syncthreads();  // q_s written / the previous page consumed
    for (int i = threadIdx.x; i < page * HD; i += nthr) {
      const int r = i / HD, d = i % HD;
      k_s[r * HDP + d] = to_f(kb[r * row_stride + d]);
      v_s[r * HD + d] = to_f(vb[r * row_stride + d]);
    }
    __syncthreads();

    float sc = NEG_INF;
    if (lane < page) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(q_s[w * HD + d], k_s[lane * HDP + d], dot);
      const int k_pos = first_k + lane;
      bool vis = k_pos <= q_pos;
      if (window > 0) vis = vis && (q_pos - k_pos) < window;
      sc = vis ? dot : NEG_INF;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
    const float corr = expf((m <= NEG_INF * 0.5f ? NEG_INF : m) - m_safe);
    const float pr = lane < page ? expf(sc - m_safe) : 0.f;
    l = l * corr + warp_sum(pr);
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
    for (int c = 0; c < page; ++c) {
      const float pc = __shfl_sync(FULL, pr, c);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < HD) acc[j] = fmaf(pc, v_s[c * HD + d], acc[j]);
      }
    }
  }

  T* ob = o + ((static_cast<long long>(s) * hkv + h) * g + w) * HD;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < HD) ob[d] = from_f<T>(acc[j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lengths, void* o, int s, int hkv, int g, int page,
                   int n_pages, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (g * HD + page * (HD + 1) + page * HD);
  auto kern = paged_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(s, hkv), 32 * g, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      table, lengths, static_cast<T*>(o), hkv, g, page, n_pages, window,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const int* table, const int* lengths, void* o, int s,
                        int hkv, int g, int page, int n_pages, int window,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, window, st);
    case 32: return launch<T, 32>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, window, st);
    case 64: return launch<T, 64>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, window, st);
    case 128: return launch<T, 128>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (S, Hkv, g, hd), pools (P, page, Hkv, hd), out like q, all contiguous;
// page_table (S, n_pages) and lengths (S,) int32. dtype: 0 = float32,
// 1 = bfloat16. Needs 1 <= page <= 32 and 1 <= g <= 32. Returns
// cudaGetLastError() of the launch.
extern "C" int fedfog_paged_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, const void* page_table,
                                          const void* lengths, void* o, int dtype,
                                          int s, int hkv, int g, int hd, int page,
                                          int n_pages, int window, void* stream) {
  if (s <= 0 || hkv <= 0 || g < 1 || g > 32 || page < 1 || page > 32 || n_pages < 1)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, tab, len, o, s, hkv, g, page, n_pages, window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, tab, len, o, s, hkv, g, page, n_pages, window, st);
  return cudaErrorInvalidValue;
}
