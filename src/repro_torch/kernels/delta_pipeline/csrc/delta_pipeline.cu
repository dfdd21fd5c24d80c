// The fused FedFog delta pipeline, hand-written for Hopper (sm_90a).
//
// Three entry points, bound to Python through a plain C interface (ctypes):
//
//   fedfog_delta_sq_norms  replaces the Pallas kernel `_sq_norms_kernel`
//       (src/repro/kernels/delta_pipeline/delta_pipeline.py, pallas_call of
//       `delta_sq_norms`): per-client sum of squares over the fused (C, P)
//       delta buffer, the reduction behind the clip gate.
//   fedfog_delta_pipeline  replaces `_make_pipeline_kernel` with
//       `_transform_tile`, `_select_aggregate` and `_bitonic_sort` (same
//       file, pallas_call of `delta_pipeline_apply`): clip pre-scale ->
//       int8 or top-k emulation from the (C, L) table -> Eq. 6 weighted sum
//       (weights row built outside) or masked median / trimmed mean -> + DP
//       noise -> FedAvgM / FedAdam momentum -> base + lr * step.
//   fedfog_delta_pipeline_partial  replaces `_make_partial_kernel` (same
//       file, pallas_call of `delta_pipeline_partial`): the fog aggregator's
//       pass over its own (C_local, P) block, clip pre-scale -> int8 or top-k
//       emulation from the fog-local (C_local, L) table -> the UNnormalized
//       weighted sum out[p] = sum_i dm[i] * x[i, p]. No normalisation, noise
//       or apply: the cloud combines the fogs' partials (fl/fog.py). It is
//       `fedavg_kernel` instantiated with kPartial, so its transform, client
//       order and FMA are K3's and the family's arithmetic stays one.
//   fedfog_fedavg_apply  replaces the Pallas kernel `_fedavg_kernel`
//       (src/repro/kernels/fedavg/fedavg.py:68, pallas_call of
//       `fedavg_apply`, K1): out = base + sum_i wn[i] * upd[i, :] with the
//       weight row lr * m * w / (sum m * w + 1e-12) built outside, float32
//       or bfloat16 updates, base and out. It is `fedavg_kernel` with every
//       gate off, lr = 1 and the element type T = the updates' dtype: K3's
//       client order and FMAs, its apply as one FMA, a single rounding to T.
//
// What bounds them on an H100: device-memory bytes (K4 reads its C_local*P*4
// bytes once and writes P*4). The pipeline reads the
// C*P*4 bytes of the delta buffer once, plus 1-2 (P,) vectors (base, and
// noise / momentum / segment ids when their gates are on), and writes one or
// two (P,) vectors; it does ~2*C*P flops, far below the card's rate. The
// design therefore only has to stream the buffer once with coalesced loads:
// one thread owns 4 columns spaced a block apart, so a warp reads 32
// neighbouring floats of each client row per load, and the client loop loads
// 8 client rows ahead of their FMAs (32 loads in flight per thread). The sum
// over clients runs in a fixed order with one FMA per client (no atomics), so
// a run replays bitwise; the order and the FMA are those of XLA's CPU dot,
// which the JAX package's reference uses. The ragged tail (P = 112,766 is no multiple of a tile) is
// masked in the kernel, no padded copy is made.
//
// What a later change would do about the bound: read the rows with 16-byte
// vector loads (rows are only 8-byte aligned when P % 4 == 2, so this needs a
// per-row alignment prologue), stage client tiles through shared memory with
// TMA so more bytes are in flight per SM, and split K2's rows over several
// blocks (it runs one block per client, 64 blocks on 132 SMs). The median /
// trimmed path sorts each column in a thread-local array (insertion sort over
// the selected clients, C <= 256), which spills to local memory; a
// warp-cooperative sorting network would keep it in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNormThreads = 1024;
constexpr int kNormUnroll = 8;
constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kBatch = 8;  // client rows loaded ahead of their FMAs

enum Compression { kNone = 0, kInt8 = 1, kTopk = 2 };
enum Aggregator { kFedavg = 0, kMedian = 1, kTrimmed = 2 };
enum Optimizer { kPlain = 0, kFedavgm = 1, kFedadam = 2 };

// Reads and writes of the (C, P) deltas, the base and the output in their
// element type T (float for K2-K4, float or bfloat16 for K1); all
// arithmetic is float32.
__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
struct Args {
  const T* upd;        // (C, P)
  const T* base;       // (P,)
  const float* wn;     // (C,) Eq. 6 weights, or the 0/1 mask (robust)
  const int* cnt;      // (2,) [num_sel, k_trim], robust only
  const float* pre;    // (C,) clip scales or null
  const int* seg;      // (P,) leaf ids or null
  const float* tab;    // (C, L) int8 scales / top-k thresholds or null
  const float* noise;  // (P,) DP noise or null
  const float* mu;     // (P,) server momentum or null
  T* out;              // (P,)
  float* new_mu;       // (P,) or null
  long long P;
  int C;
  int L;
  float lr;
  float server_momentum;
  int compression;
  int optimizer;
};
using PipelineArgs = Args<float>;

__global__ void __launch_bounds__(kNormThreads)
sq_norms_kernel(const float* __restrict__ upd, float* __restrict__ out,
                long long P) {
  __shared__ float part[kNormThreads];
  const float* row = upd + static_cast<long long>(blockIdx.x) * P;
  float acc[kNormUnroll];
#pragma unroll
  for (int u = 0; u < kNormUnroll; ++u) acc[u] = 0.f;
  const long long stride = static_cast<long long>(kNormThreads) * kNormUnroll;
  for (long long p0 = threadIdx.x; p0 < P; p0 += stride) {
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const long long p = p0 + static_cast<long long>(u) * kNormThreads;
      if (p < P) {
        const float x = __ldg(row + p);
        acc[u] = fmaf(x, x, acc[u]);
      }
    }
  }
  // Fixed-order tree reduction: the result does not depend on scheduling.
  part[threadIdx.x] =
      ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  __syncthreads();
  for (int s = kNormThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

// Clip pre-scale, then compression emulation with the client's table entry
// for this column's leaf (the Pallas kernel's L-way select chain).
template <typename T>
__device__ __forceinline__ float transform(float x, int c, int sg,
                                           const Args<T>& a,
                                           const float* s_pre) {
  if (a.pre != nullptr) x = __fmul_rn(x, s_pre[c]);
  if (a.compression != kNone) {
    const float col = __ldg(a.tab + c * a.L + sg);
    if (a.compression == kInt8) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(x, col)), -127.f), 127.f);
      x = __fmul_rn(q, col);
    } else {
      x = __fmul_rn(x, fabsf(x) >= col ? 1.f : 0.f);
    }
  }
  return x;
}

// + DP noise, server momentum, apply. The plain path is one FMA like the
// reference's fused `base + lr * agg`; the momentum paths round each op
// separately, as the plain PyTorch version does.
template <typename T>
__device__ __forceinline__ void epilogue(float agg, long long p,
                                         const Args<T>& a) {
  if (a.noise != nullptr) agg = __fadd_rn(agg, __ldg(a.noise + p));
  const float base = load_f(a.base + p);
  if (a.mu != nullptr) {
    const float mu2 = __fadd_rn(__fmul_rn(a.server_momentum, __ldg(a.mu + p)), agg);
    a.new_mu[p] = mu2;
    float step = __fmul_rn(a.lr, mu2);
    if (a.optimizer == kFedadam) {
      step = __fdiv_rn(step, __fadd_rn(sqrtf(__fmul_rn(agg, agg)), 1e-3f));
    }
    store_f(a.out + p, __fadd_rn(base, step));
  } else {
    store_f(a.out + p, fmaf(a.lr, agg, base));
  }
}

template <typename T>
__device__ __forceinline__ void stage_rows(const Args<T>& a, float* s_wn,
                                           float* s_pre) {
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    s_wn[c] = a.wn[c];
    if (a.pre != nullptr) s_pre[c] = a.pre[c];
  }
  __syncthreads();
}

// kPartial: write the raw weighted sum (K4) instead of running the epilogue.
// T: the element type of the deltas, the base and the output.
template <bool kPartial, typename T = float>
__global__ void __launch_bounds__(kThreads) fedavg_kernel(Args<T> a) {
  extern __shared__ float smem[];
  float* s_wn = smem;
  float* s_pre = smem + a.C;
  stage_rows(a, s_wn, s_pre);

  const long long p0 =
      static_cast<long long>(blockIdx.x) * (kThreads * kCols) + threadIdx.x;
  float acc[kCols];
  int sg[kCols];
  bool ok[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const long long p = p0 + j * kThreads;
    ok[j] = p < a.P;
    acc[j] = 0.f;
    sg[j] = (ok[j] && a.seg != nullptr) ? __ldg(a.seg + p) : 0;
  }
  // kBatch client rows are loaded before any of their FMAs, so a thread
  // keeps kBatch * kCols loads in flight; the FMAs still run in client
  // order.
  for (int c0 = 0; c0 < a.C; c0 += kBatch) {
    float x[kBatch][kCols];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b;
      const T* row = a.upd + static_cast<long long>(c) * a.P + p0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        x[b][j] = (c < a.C && ok[j]) ? load_f(row + j * kThreads) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b;
      if (c < a.C) {
        const float w = s_wn[c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc[j] = fmaf(w, transform(x[b][j], c, sg[j], a, s_pre), acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (!ok[j]) continue;
    if constexpr (kPartial) {
      store_f(a.out + p0 + j * kThreads, acc[j]);
    } else {
      epilogue(acc[j], p0 + j * kThreads, a);
    }
  }
}

// Masked coordinate-wise median / trimmed mean. Unselected clients are the
// +inf sentinels of the reference: they sort after every selected value, so
// only the selected values are kept (sorted ascending) and any index at or
// beyond their count reads +inf. Index arithmetic is the reference's,
// including num_sel == 0 (median +inf, trimmed mean 0).
template <int CAP>
__global__ void __launch_bounds__(kThreads) robust_kernel(PipelineArgs a,
                                                          int trimmed) {
  extern __shared__ float smem[];
  float* s_wn = smem;
  float* s_pre = smem + a.C;
  stage_rows(a, s_wn, s_pre);
  const int num_sel = a.cnt[0];
  const int k_trim = a.cnt[1];

  const long long p0 =
      static_cast<long long>(blockIdx.x) * (kThreads * kCols) + threadIdx.x;
  for (int j = 0; j < kCols; ++j) {
    const long long p = p0 + j * kThreads;
    if (p >= a.P) break;
    const int sg = a.seg != nullptr ? __ldg(a.seg + p) : 0;
    float v[CAP];
    int n = 0;
    for (int c = 0; c < a.C; ++c) {
      if (!(s_wn[c] > 0.f)) continue;
      const float x = transform(__ldg(a.upd + static_cast<long long>(c) * a.P + p),
                                c, sg, a, s_pre);
      int i = n++;
      while (i > 0 && v[i - 1] > x) {
        v[i] = v[i - 1];
        --i;
      }
      v[i] = x;
    }
    float agg;
    if (!trimmed) {
      const int lo = max((num_sel - 1) / 2, 0);
      const int hi = num_sel / 2;
      const float vlo = lo < n ? v[lo] : INFINITY;
      const float vhi = hi < n ? v[hi] : INFINITY;
      agg = __fmul_rn(0.5f, __fadd_rn(vlo, vhi));
    } else {
      float total = 0.f;
      for (int i = k_trim; i < num_sel - k_trim; ++i) {
        total = __fadd_rn(total, i < n ? v[i] : INFINITY);
      }
      agg = __fdiv_rn(total, static_cast<float>(max(num_sel - 2 * k_trim, 1)));
    }
    epilogue(agg, p, a);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for
// arguments the kernel does not take.
int fedfog_delta_sq_norms(const float* upd, float* out, int C, long long P,
                          void* stream) {
  if (C <= 0 || P <= 0) return -1;
  sq_norms_kernel<<<C, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      upd, out, P);
  return static_cast<int>(cudaGetLastError());
}

int fedfog_delta_pipeline(const float* upd, const float* base, const float* wn,
                          const int* cnt, const float* pre, const int* seg,
                          const float* tab, const float* noise, const float* mu,
                          float* out, float* new_mu, int C, int L, long long P,
                          float lr, float server_momentum, int compression,
                          int aggregator, int optimizer, void* stream) {
  if (C <= 0 || P <= 0 || C > 4096) return -1;
  if (compression != kNone && (seg == nullptr || tab == nullptr || L <= 0)) return -1;
  if (aggregator != kFedavg && (cnt == nullptr || C > 256)) return -1;
  if ((mu == nullptr) != (new_mu == nullptr)) return -1;
  PipelineArgs a{upd, base, wn, cnt, pre, seg, tab, noise, mu, out, new_mu,
                 P, C, L, lr, server_momentum, compression, optimizer};
  const long long per_block = static_cast<long long>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((P + per_block - 1) / per_block));
  const size_t shmem = 2 * sizeof(float) * static_cast<size_t>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aggregator == kFedavg) {
    fedavg_kernel<false><<<grid, kThreads, shmem, s>>>(a);
  } else if (C <= 64) {
    robust_kernel<64><<<grid, kThreads, shmem, s>>>(a, aggregator == kTrimmed);
  } else {
    robust_kernel<256><<<grid, kThreads, shmem, s>>>(a, aggregator == kTrimmed);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: out (P,) = sum over the C fog-local clients of dm[i] * T(upd[i, :]).
int fedfog_delta_pipeline_partial(const float* upd, const float* dm,
                                  const float* pre, const int* seg,
                                  const float* tab, float* out, int C, int L,
                                  long long P, int compression, void* stream) {
  if (C <= 0 || P <= 0 || C > 4096) return -1;
  if (compression != kNone && (seg == nullptr || tab == nullptr || L <= 0)) return -1;
  PipelineArgs a{upd, nullptr, dm, nullptr, pre, seg, tab, nullptr, nullptr,
                 out, nullptr, P, C, L, 0.f, 0.f, compression, kPlain};
  const long long per_block = static_cast<long long>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((P + per_block - 1) / per_block));
  const size_t shmem = 2 * sizeof(float) * static_cast<size_t>(C);
  fedavg_kernel<true><<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K1: out (D,) = base + sum over the N clients of wn[i] * upd[i, :], wn the
// lr-scaled normalised weight row. dtype: 0 = float32, 1 = bfloat16, one
// type for upd, base and out.
int fedfog_fedavg_apply(const void* upd, const void* base, const float* wn,
                        void* out, int N, long long D, int dtype, void* stream) {
  if (N <= 0 || D <= 0 || N > 4096) return -1;
  const long long per_block = static_cast<long long>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((D + per_block - 1) / per_block));
  const size_t shmem = 2 * sizeof(float) * static_cast<size_t>(N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a{static_cast<const float*>(upd), static_cast<const float*>(base), wn,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  static_cast<float*>(out), nullptr, D, N, 0, 1.f, 0.f, kNone, kPlain};
    fedavg_kernel<false, float><<<grid, kThreads, shmem, s>>>(a);
  } else if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    Args<bf16> a{static_cast<const bf16*>(upd), static_cast<const bf16*>(base), wn,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 static_cast<bf16*>(out), nullptr, D, N, 0, 1.f, 0.f, kNone, kPlain};
    fedavg_kernel<false, bf16><<<grid, kThreads, shmem, s>>>(a);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
