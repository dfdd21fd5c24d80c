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
// real cost is latency. The first design (one block per (slot, kv
// head), 64 blocks on 132 SMs, each walking its ~10 pages in order with a
// table read, 2-byte loads and a barrier per page) took 0.027 ms there:
// ten dependent trips to device memory in a row. This one takes 0.0076
// ms, 9 % of the bound, against 0.017-0.026 ms for SDPA over a gathered
// copy of the cache (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// Head dims 16 to 256 are instantiated (256: gemma3-12b, 78 registers,
// no spill; 0.078 ms for 8 slots of 1,121..1,845 keys under a 1,024
// window, 26 % of its byte bound, beside 0.074 ms for SDPA over a
// gathered copy, chip_smoke.py on the same card).
//
// Design: split-KV over a thread-block cluster.
//   * each (slot, kv head) is a cluster of `splits` blocks (<= 8, the
//     portable cluster size), launched with cudaLaunchKernelEx and the
//     cluster-dimension attribute; block r takes pages [r·pps, (r+1)·pps).
//     The host picks (splits, pps) from the table's width alone, never
//     from `lengths` (the decode step does not synchronise the host):
//     10 pages -> 5 x 2, 320 blocks at the serving shape;
//   * a block reads its slot's length and its table entries together,
//     then requests every live page's keys and values at once (16-byte
//     `cp.async` copies, a ring of up to MAX_STAGES pages; with pps <=
//     MAX_STAGES all of them), so a block's pages arrive in about one
//     round trip; rows are padded by 16 bytes so the per-key reads of
//     the scores fall in distinct banks;
//   * one warp per query head (g warps); lane c scores key c of a page
//     (page <= 32) in f32 on CUDA cores (a 16-row tensor-core tile would
//     waste three quarters of its work on g = 4 query rows); each lane
//     keeps a pair of output dims per 64 in f32 registers;
//   * each block keeps its own f32 partial (m, l, acc) per query head with
//     the reference's guards (m_safe for a head with nothing live yet); a
//     block whose pages are all dead keeps m = -1e30 and l = 0;
//   * after cluster.sync(), block rank 0 reads the other blocks' partials
//     through distributed shared memory (cluster.map_shared_rank; lane r
//     reads rank r's m and l, and every rank's acc is requested before
//     the first is used, so the merge costs about one remote round trip)
//     and merges them: m* = max m_r, m_safe, weights exp(m_r - m_safe),
//     then acc / max(l, 1e-30), so an empty slot writes zeros. No second
//     launch, no workspace in device memory.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_STAGES = 4;       // pages in flight per block
constexpr int MAX_SPLITS = 8;       // portable cluster size
constexpr int MAX_SMEM = 232448;    // bytes of shared memory a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of elements from shared memory, as f32.
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Two adjacent elements from shared memory, as f32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
struct Layout {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int CHUNKS = HD / EPC;     // chunks per token row
  static constexpr int LD = HD + EPC;         // padded row in shared memory
};

// Bytes of dynamic shared memory: the page ring, q, the partials, the table.
template <typename T, int HD>
size_t smem_bytes(int g, int page, int pps) {
  const int stages = pps < MAX_STAGES ? pps : MAX_STAGES;
  return sizeof(T) * static_cast<size_t>(stages) * 2 * page * Layout<T, HD>::LD +
         sizeof(float) * (2 * static_cast<size_t>(g) * HD + 2 * g) + sizeof(int) * pps;
}

template <typename T, int HD>
__global__ void paged_decode_split_kernel(const T* __restrict__ q,
                                          const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          const int* __restrict__ page_table,
                                          const int* __restrict__ lengths,
                                          T* __restrict__ o, int hkv, int g, int page,
                                          int n_pages, int pps, int window, float scale) {
  using L = Layout<T, HD>;
  constexpr int EPC = L::EPC, CHUNKS = L::CHUNKS, LD = L::LD;
  constexpr int NPAIR = HD / 2;           // output dim pairs
  constexpr int PPL = (NPAIR + 31) / 32;  // pairs per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = pps < MAX_STAGES ? pps : MAX_STAGES;
  T* kv_s = reinterpret_cast<T*>(smem_raw);                              // [stage][K|V][page][LD]
  float* q_s = reinterpret_cast<float*>(kv_s + stages * 2 * page * LD);  // [g][HD]
  float* acc_s = q_s + g * HD;                                           // [g][HD]
  float* m_s = acc_s + g * HD;                                           // [g]
  float* l_s = m_s + g;                                                  // [g]
  int* tab_s = reinterpret_cast<int*>(l_s + g);                          // [pps]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;  // query head within the group
  const int nthr = blockDim.x;
  const long long row_stride = static_cast<long long>(hkv) * HD;  // one token

  // The slot's length, the block's table entries and q, all requested at once.
  const int length = lengths[s];
  const int p0 = rank * pps;
  const int p1 = min(p0 + pps, n_pages);
  for (int i = threadIdx.x; i < p1 - p0; i += nthr)
    tab_s[i] = page_table[static_cast<long long>(s) * n_pages + p0 + i];
  const T* qb = q + (static_cast<long long>(s) * hkv + h) * g * HD;
  for (int i = threadIdx.x; i < g * HD; i += nthr) q_s[i] = to_f(qb[i]) * scale;

  // Live pages of this block: [lo, hi). Page p is live if p·page < length
  // and, with a window, p·page + page - 1 > q_pos - window.
  const int q_pos = length - 1;
  const int hi = min(p1, (length + page - 1) / page);
  int lo = p0;
  if (window > 0) {
    const int num = q_pos - window - page + 2;  // live iff p·page >= num
    if (num > 0) lo = max(lo, (num + page - 1) / page);
  }
  const int n = max(0, hi - lo);
  __syncthreads();  // tab_s and q_s written

  auto load_page = [&](int j, int stage) {
    const long long phys = tab_s[lo + j - p0];
    const long long base = phys * page * row_stride + static_cast<long long>(h) * HD;
    T* kt = kv_s + stage * 2 * page * LD;
    T* vt = kt + page * LD;
    for (int i = threadIdx.x; i < page * CHUNKS; i += nthr) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * EPC;
      cp_async16(kt + r * LD + c, k_pages + base + r * row_stride + c);
      cp_async16(vt + r * LD + c, v_pages + base + r * row_stride + c);
    }
  };
  // Every group is committed, empty or not, so wait_group counts line up.
#pragma unroll
  for (int j = 0; j < MAX_STAGES; ++j) {
    if (j < n && j < stages) load_page(j, j);
    cp_async_commit();
  }

  float m = NEG_INF, l = 0.f;
  float2 acc[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) acc[j] = make_float2(0.f, 0.f);
  const float* qw = q_s + w * HD;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<MAX_STAGES - 1>();  // this thread's copies of page i have landed
    __syncthreads();                  // ... and every other thread's
    const int stage = i % stages;
    const T* kt = kv_s + stage * 2 * page * LD;
    const T* vt = kt + page * LD;
    const int first_k = (lo + i) * page;

    float sc = NEG_INF;
    if (lane < page) {
      const T* kr = kt + lane * LD;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float x[EPC];
        load_chunk(kr + c * EPC, x);
#pragma unroll
        for (int e = 0; e < EPC; ++e) dot = fmaf(qw[c * EPC + e], x[e], dot);
      }
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
    for (int j = 0; j < PPL; ++j) {
      acc[j].x *= corr;
      acc[j].y *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < page; ++c) {
      const float pc = __shfl_sync(FULL, pr, c);
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const int pi = lane + 32 * j;
        if (pi < NPAIR) {
          const float2 vv = load_pair(vt + c * LD + 2 * pi);
          acc[j].x = fmaf(pc, vv.x, acc[j].x);
          acc[j].y = fmaf(pc, vv.y, acc[j].y);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
    if (i + stages < n) load_page(i + stages, stage);
    cp_async_commit();
  }

  // This block's partial state, then the merge in block rank 0.
  if (lane == 0) {
    m_s[w] = m;
    l_s[w] = l;
  }
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    const int pi = lane + 32 * j;
    if (pi < NPAIR) *reinterpret_cast<float2*>(acc_s + w * HD + 2 * pi) = acc[j];
  }
  cluster.sync();
  if (rank == 0) {
    // Lane r holds rank r's (m, l) of this head; every remote read is
    // issued before the first is used.
    float mr = NEG_INF, lr = 0.f;
    if (lane < splits) {
      mr = cluster.map_shared_rank(m_s, lane)[w];
      lr = cluster.map_shared_rank(l_s, lane)[w];
    }
    float2 a[MAX_SPLITS][PPL];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float* ar = cluster.map_shared_rank(acc_s, r < splits ? r : 0) + w * HD;
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const int pi = lane + 32 * j;
        a[r][j] = (r < splits && pi < NPAIR) ? *reinterpret_cast<const float2*>(ar + 2 * pi)
                                             : make_float2(0.f, 0.f);
      }
    }
    const float m_star = warp_max(mr);
    const float m_safe = m_star <= NEG_INF * 0.5f ? 0.f : m_star;
    const float wr = lane < splits ? expf((mr <= NEG_INF * 0.5f ? NEG_INF : mr) - m_safe) : 0.f;
    const float den = fmaxf(warp_sum(wr * lr), 1e-30f);
    float2 out[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) out[j] = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float wv = __shfl_sync(FULL, wr, r);  // 0 past the last rank
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        out[j].x = fmaf(wv, a[r][j].x, out[j].x);
        out[j].y = fmaf(wv, a[r][j].y, out[j].y);
      }
    }
    T* ob = o + ((static_cast<long long>(s) * hkv + h) * g + w) * HD;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int pi = lane + 32 * j;
      if (pi < NPAIR) {
        ob[2 * pi] = from_f<T>(out[j].x / den);
        ob[2 * pi + 1] = from_f<T>(out[j].y / den);
      }
    }
  }
  cluster.sync();  // no block leaves while rank 0 may still read its shared memory
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lengths, void* o, int s, int hkv, int g, int page,
                   int n_pages, int splits, int pps, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(g, page, pps);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<T, HD>;
  // Once per instantiation (the attribute persists for the process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, hkv, s);
  cfg.blockDim = dim3(32 * g);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(o), hkv, g, page, n_pages,
      pps, window, 1.0f / sqrtf(static_cast<float>(HD)));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const int* table, const int* lengths, void* o, int s, int hkv,
                        int g, int page, int n_pages, int splits, int pps, int window,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, splits, pps, window, st);
    case 32: return launch<T, 32>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, splits, pps, window, st);
    case 64: return launch<T, 64>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, splits, pps, window, st);
    case 128: return launch<T, 128>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, splits, pps, window, st);
    case 256: return launch<T, 256>(q, kp, vp, table, lengths, o, s, hkv, g, page, n_pages, splits, pps, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (S, Hkv, g, hd), pools (P, page, Hkv, hd), out like q, all contiguous
// and 16-byte aligned; page_table (S, n_pages) and lengths (S,) int32.
// dtype: 0 = float32, 1 = bfloat16. Needs 1 <= page <= 32, 1 <= g <= 32
// and the split plan 1 <= splits <= 8, splits·pps >= n_pages. Returns
// the launch's error, or cudaGetLastError() after it.
extern "C" int fedfog_paged_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, const void* page_table,
                                          const void* lengths, void* o, int dtype,
                                          int s, int hkv, int g, int hd, int page,
                                          int n_pages, int splits, int pps, int window,
                                          void* stream) {
  if (s <= 0 || hkv <= 0 || g < 1 || g > 32 || page < 1 || page > 32 || n_pages < 1 ||
      splits < 1 || splits > MAX_SPLITS || pps < 1 ||
      static_cast<long long>(splits) * pps < n_pages)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, tab, len, o, s, hkv, g, page, n_pages, splits, pps, window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, tab, len, o, s, hkv, g, page, n_pages, splits, pps, window, st);
  return cudaErrorInvalidValue;
}
