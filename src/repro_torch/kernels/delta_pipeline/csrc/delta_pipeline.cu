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
// What bounds them on an H100: device-memory bytes. The weighted sum reads
// the C*P deltas once, plus one or two (P,) vectors, and writes one or two;
// it does 2 flops per delta, far below the card's rate. At the main path's
// (64, 112,766) float32 that is 29.8 MB, 8.9 us at 3.35 TB/s, so the kernel
// has to keep enough bytes in flight on every SM from its first row to its
// last, and give every SM the same share.
//
// `fedavg_kernel` is a streaming kernel:
//   * A balanced, persistent grid. The host's plan (`fedavg_plan` in
//     delta_pipeline.py, passed in as integers) launches one block per SM
//     (two per SM, each with half the shared memory, were slower) and each
//     block owns one contiguous range of columns. Ranges start and end on
//     16-byte granules (4 float32 or 8 bf16 columns) and differ by at most
//     one granule, so every SM streams the same bytes (213 or 214 granules
//     each at P = 112,766 on 132 SMs). A range wider than a tile (256
//     consumer threads x 4 columns) is walked tile by tile.
//   * A ring of stages in dynamic shared memory, filled by the Tensor Memory
//     Accelerator. A producer warp starts one 1-D bulk copy (cp.async.bulk
//     ... mbarrier::complete_tx) per client row and stage, a lane per row (a
//     single issuing thread, working out each row's span in turn, was slower
//     than the copies it started); a "full" mbarrier per stage counts the
//     bytes, an "empty" mbarrier per stage counts the 8 consumer warps that
//     have read it before the producer refills it. The producer starts at
//     once; the consumers stage the weight and clip rows meanwhile. At the
//     slice a stage holds 8 rows of a block's range and
//     the ring all 8 stages: every byte a block reads is requested at its
//     start (~219 KB in flight per SM instead of 16-32 KB in 8 serialised
//     trips). Every wait is try_wait.parity in a loop with an iteration cap
//     that traps, so a fault in the ring's phases ends the run with an error.
//   * Alignment with no byte read outside the tensor. A bulk copy needs
//     16-byte-aligned addresses and sizes, and a row starts at base + r*P*eb,
//     which is 8 mod 16 for every odd row at P = 112,766. Each (row, tile)
//     copy is widened to the 16-byte granules around it (the extra bytes are
//     the neighbouring columns of the same row) and lands at the same offset
//     mod 16 in shared memory, so a consumer reads row r at its own shift
//     (A_r mod 16) / eb. Only at the tensor's two ends would widening leave
//     the tensor: there the copy is clipped to the tensor's aligned interior
//     and the producer loads the (< 16-byte) fragment with ordinary loads
//     before it arrives on the stage's barrier.
//   * Few instructions per element. With the bytes in flight, what is left
//     is the consumers' instruction rate: 8 warps per SM read every
//     element from shared memory. They test the gates once per stage, not
//     per element, so with every gate off the inner loop is one
//     shared-memory load and one FMA per element, and a row's shift steps
//     by (P * eb) mod 16 from the row before. (Testing the gates per
//     element, as `transform` does, made the whole kernel ~1.6x slower at
//     the slice than this loop.)
//   * The arithmetic is the plain version's: each column's sum stays in one
//     consumer thread, clients run in order 0..C-1 with one fmaf(w,
//     transform(x), acc) each, no atomics, no split over clients; with every
//     gate off K1 (float32), K3 and K4 equal `ref.py` (whose _fma rounds
//     once) bit for bit. The epilogue runs per 16-byte granule of the output
//     from a shared-memory copy of the tile's sums, with 16-byte loads of
//     the base and 16-byte stores of the output (and new_mu) where the
//     pointers allow, scalar ones at the edges.
// The order and the FMA are those of XLA's CPU dot, which the JAX package's
// reference uses, so a run replays bitwise.
//
// `sq_norms_kernel` (K2) gives each block one client row's span of at most
// kNormCols columns: one block per client at the simulator's P (64 blocks),
// a grid of (ceil(P / kNormCols), C) at a model's P, whose per-span sums
// `sq_norms_combine_kernel` adds in a fixed order, one block per client.
// One block per row (the first design) had 4 blocks at the LM round's
// C = 4, P = 1.24e9: 4 of 132 SMs, and float32 sums of 1.5e5 terms per
// accumulator, 5e-5 from the plain version's.
//
// `robust_kernel` (K3's masked median / trimmed mean, C <= 256) is a
// register-resident sorting network, one column per thread:
//   * The grid covers P with one thread per column (881 blocks of 128 at
//     P = 112,766), neighbouring threads on neighbouring columns, so each
//     client row is one coalesced 128-byte access per warp.
//   * The column's N2 = next power of two >= C values (N2 a template
//     parameter) are loaded up front into `int v[N2]`, every load in
//     flight before the first compare: selected rows through `transform`,
//     unselected rows as the reference's +inf sentinel, the padding after
//     every value.
//     The 0/1 mask row is staged in shared memory, so its branch is
//     uniform across the warp.
//   * Each value is held as an integer sort key (`sort_key`) whose order is
//     torch.sort's, every NaN after +inf (and -0.0 before +0.0, which
//     torch.sort counts as equal). A compare-exchange is then an integer
//     min / max pair, which keeps both values, NaN included.
//   * Batcher's odd-even merge sort (543 compare-exchanges at N2 = 64) is
//     unrolled at compile time from template recursion, so every index
//     into `v` is a constant and the column never leaves registers. Any
//     sorting network under one total order gives the reference's sorted
//     values, which is what makes the median equal to it, NaN included.
//   * Selection reads no dynamic index: the median takes v[lo] and v[hi]
//     through a select chain over the constant indices, the trimmed mean
//     is a predicated ascending sum from +0.0f, as the reference adds.
//   * For N2 in {128, 256} the same network runs, its stages' loops not
//     unrolled, on the thread's column in dynamic shared memory, laid out
//     s[row * 128 + tid] (each thread touches only its own column: no bank
//     conflict). No path runs it.
// What bounds it: the network's 543 * 2 min / max per column (1.2e8 at the
// slice, ~7.3 us at 64 a clock per SM on 132 SMs) and the selected rows'
// deltas it reads (~6.3 us at 70 % of 64 clients selected).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNormThreads = 1024;
constexpr int kNormUnroll = 8;
constexpr long long kNormCols = 1LL << 20;  // columns per K2 block (a row's span)
// robust_kernel: threads per block, one column each; at most 255
// registers a thread, so the 64 keys and the addresses fit without a spill.
constexpr int kRobustThreads = 128;
constexpr int kRobustMaxC = 256;  // N2 <= 64 in registers, 128 and 256 in shared memory

// fedavg_kernel: one producer warp and kConsumers consumer threads, each
// owning kColsPerThread columns of a tile spaced kConsumers apart. The
// shared-memory layout (kept equal to delta_pipeline.py's `ring_offset`):
// [full | empty mbarriers, kMaxStages each][wn (C,)][pre (C,)][tile sums]
// [ring: stages x rows x row_stride], row_stride = tile_cols * eb + 16.
constexpr int kConsumers = 256;
constexpr int kColsPerThread = 4;
constexpr int kMaxTileCols = kConsumers * kColsPerThread;
constexpr int kFedThreads = kConsumers + 32;
constexpr int kMaxStages = 32;
constexpr int kBarBytes = 16 * kMaxStages;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr long long kSpinCap = 1LL << 24;

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
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// fedavg_kernel's plan from the host (`fedavg_plan`): columns per tile,
// client rows per stage, stages in the ring. The grid is the plan's block
// count; the dynamic shared bytes its smem_bytes.
struct Plan {
  int tile_cols;
  int rows;
  int stages;
};

__host__ __device__ inline long long align_up(long long x, long long a) {
  return (x + a - 1) / a * a;
}
__host__ __device__ inline long long acc_offset(int C) {
  return align_up(kBarBytes + 8LL * C, 16);
}
__host__ __device__ inline long long ring_offset(int C, int tile_cols) {
  return align_up(acc_offset(C) + 4LL * tile_cols, 128);
}

// Fixed-order tree reduction of the block's kNormThreads values in `part`:
// the result does not depend on scheduling. Thread 0 returns the sum.
__device__ __forceinline__ float block_sum(float* part) {
  __syncthreads();
  for (int s = kNormThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  return part[0];
}

// Block (s, c): the sum of squares of row c's columns [s * kNormCols,
// min((s + 1) * kNormCols, P)) -> out[c * gridDim.x + s].
__global__ void __launch_bounds__(kNormThreads)
sq_norms_kernel(const float* __restrict__ upd, float* __restrict__ out,
                long long P) {
  __shared__ float part[kNormThreads];
  const float* row = upd + static_cast<long long>(blockIdx.y) * P;
  const long long lo = static_cast<long long>(blockIdx.x) * kNormCols;
  const long long hi = lo + kNormCols < P ? lo + kNormCols : P;
  float acc[kNormUnroll];
#pragma unroll
  for (int u = 0; u < kNormUnroll; ++u) acc[u] = 0.f;
  const long long stride = static_cast<long long>(kNormThreads) * kNormUnroll;
  for (long long p0 = lo + threadIdx.x; p0 < hi; p0 += stride) {
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const long long p = p0 + static_cast<long long>(u) * kNormThreads;
      if (p < hi) {
        const float x = __ldg(row + p);
        acc[u] = fmaf(x, x, acc[u]);
      }
    }
  }
  part[threadIdx.x] =
      ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  const float total = block_sum(part);
  if (threadIdx.x == 0)
    out[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = total;
}

// Block c: row c's `spans` per-span sums, added in a fixed order.
__global__ void __launch_bounds__(kNormThreads)
sq_norms_combine_kernel(const float* __restrict__ spans_in, float* __restrict__ out,
                        int spans) {
  __shared__ float part[kNormThreads];
  const float* row = spans_in + static_cast<long long>(blockIdx.x) * spans;
  float acc = 0.f;
  for (int s = threadIdx.x; s < spans; s += kNormThreads) acc += row[s];
  part[threadIdx.x] = acc;
  const float total = block_sum(part);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
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
      // A clamp that keeps NaN, as torch.clamp and jnp.clip do (fminf /
      // fmaxf would turn it into -127).
      float q = rintf(__fdiv_rn(x, col));
      q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);
      x = __fmul_rn(q, col);
    } else {
      x = __fmul_rn(x, fabsf(x) >= col ? 1.f : 0.f);
    }
  }
  return x;
}

// + DP noise, server momentum, apply, for column p with base value `base`;
// returns the output and sets mu2 (the new momentum) when a.mu is given. The
// plain path is one FMA like the reference's fused `base + lr * agg`; the
// momentum paths round each op separately, as the plain PyTorch version does.
template <typename T>
__device__ __forceinline__ float finish(float agg, float base, long long p,
                                        const Args<T>& a, float& mu2) {
  if (a.noise != nullptr) agg = __fadd_rn(agg, __ldg(a.noise + p));
  if (a.mu != nullptr) {
    mu2 = __fadd_rn(__fmul_rn(a.server_momentum, __ldg(a.mu + p)), agg);
    float step = __fmul_rn(a.lr, mu2);
    if (a.optimizer == kFedadam) {
      step = __fdiv_rn(step, __fadd_rn(sqrtf(__fmul_rn(agg, agg)), 1e-3f));
    }
    return __fadd_rn(base, step);
  }
  return fmaf(a.lr, agg, base);
}

template <typename T>
__device__ __forceinline__ void epilogue(float agg, long long p,
                                         const Args<T>& a) {
  float mu2 = 0.f;
  const float o = finish(agg, load_f(a.base + p), p, a, mu2);
  if (a.mu != nullptr) a.new_mu[p] = mu2;
  a.out[p] = from_f<T>(o);
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

// ---- mbarrier and bulk-copy primitives (PTX) ----------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed; traps after
// kSpinCap polls (a legitimate wait is one memory round trip).
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == kSpinCap) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, unsigned long long src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The bytes of one client row's tile, [A, E), and the part a bulk copy
// reads: [a0, a1) is [A, E) widened to 16-byte granules, [lo, hi) that span
// clipped to the tensor's aligned interior [in0, in1).
struct Span {
  unsigned long long A, E, a0, lo, hi;
};

__device__ __forceinline__ Span row_span(unsigned long long A, unsigned long long E,
                                         unsigned long long in0,
                                         unsigned long long in1) {
  Span s;
  s.A = A;
  s.E = E;
  s.a0 = A & ~15ull;
  s.lo = s.a0 > in0 ? s.a0 : in0;
  const unsigned long long a1 = (E + 15) & ~15ull;
  s.hi = a1 < in1 ? a1 : in1;
  return s;
}

// Elements of [A, E) outside [lo, hi), which only the tensor's partial
// first or last granule has: loaded with ordinary loads into their place.
template <typename T>
__device__ __forceinline__ void load_fragments(const Span& s, unsigned char* drow) {
  const unsigned long long head_end = s.lo < s.E ? (s.lo > s.A ? s.lo : s.A) : s.E;
  const unsigned long long tail_start = s.hi > head_end ? s.hi : head_end;
  for (unsigned long long e = s.A; e < head_end; e += sizeof(T)) {
    *reinterpret_cast<T*>(drow + (e - s.a0)) = *reinterpret_cast<const T*>(e);
  }
  for (unsigned long long e = tail_start; e < s.E; e += sizeof(T)) {
    *reinterpret_cast<T*>(drow + (e - s.a0)) = *reinterpret_cast<const T*>(e);
  }
  // Order these generic-proxy writes before later bulk copies into the
  // same bytes; the stage's arrive releases them to the consumers.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The producer warp: for every tile of the block's range and every stage
// of R client rows, wait for the ring slot to be empty; each lane takes
// rows lane, lane + 32, ... of the stage, loads its tensor-end fragments
// (if any), and the stage's bytes are summed over the warp; lane 0 arrives
// on the slot's full barrier with that count, then each lane starts one
// bulk copy per row.
template <typename T>
__device__ void produce(const Args<T>& a, const Plan& pl, long long lo, long long hi,
                        uint64_t* bars, unsigned char* ring, int row_stride) {
  const int lane = threadIdx.x & 31;
  const unsigned long long T0 = reinterpret_cast<unsigned long long>(a.upd);
  const unsigned long long row_bytes = static_cast<unsigned long long>(a.P) * sizeof(T);
  const unsigned long long in0 = (T0 + 15) & ~15ull;
  const unsigned long long in1 = (T0 + a.C * row_bytes) & ~15ull;
  const int stage_bytes = pl.rows * row_stride;
  int stage = 0;
  for (long long t0 = lo; t0 < hi; t0 += pl.tile_cols) {
    const long long t1 = t0 + pl.tile_cols < hi ? t0 + pl.tile_cols : hi;
    const unsigned long long width = static_cast<unsigned long long>(t1 - t0) * sizeof(T);
    for (int r0 = 0; r0 < a.C; r0 += pl.rows, ++stage) {
      const int slot = stage % pl.stages;
      if (stage >= pl.stages) {
        bar_wait(smem_u32(bars + kMaxStages + slot), ((stage / pl.stages) - 1) & 1);
      }
      unsigned char* sbase = ring + slot * stage_bytes;
      const int nrows = min(pl.rows, a.C - r0);
      const unsigned long long first =
          T0 + static_cast<unsigned long long>(r0) * row_bytes + t0 * sizeof(T);
      uint32_t bytes = 0;
      for (int rr = lane; rr < nrows; rr += 32) {
        const unsigned long long A = first + rr * row_bytes;
        const Span s = row_span(A, A + width, in0, in1);
        if (s.hi > s.lo) bytes += static_cast<uint32_t>(s.hi - s.lo);
        if (s.lo > s.A || s.hi < s.E) load_fragments<T>(s, sbase + rr * row_stride);
      }
      bytes = __reduce_add_sync(0xffffffffu, bytes);
      __syncwarp();  // the lanes' fragment stores before lane 0's release
      const uint32_t full = smem_u32(bars + slot);
      if (lane == 0) bar_arrive_expect_tx(full, bytes);
      __syncwarp();
      for (int rr = lane; rr < nrows; rr += 32) {
        const unsigned long long A = first + rr * row_bytes;
        const Span s = row_span(A, A + width, in0, in1);
        if (s.hi > s.lo) {
          bulk_copy(smem_u32(sbase + rr * row_stride + (s.lo - s.a0)), s.lo,
                    static_cast<uint32_t>(s.hi - s.lo), full);
        }
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes of T as floats, and back (bf16: the high half of a float's bits,
// rounded to nearest even on the way back, as __float2bfloat16 does).
__device__ __forceinline__ void unpack(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[2 * q] = __uint_as_float(w[q] << 16);
    x[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}
__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(x[2 * q]))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(x[2 * q + 1])))
            << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The epilogue of one 16-byte granule of the output, columns [p0, p0 + n),
// from the tile's sums `sa` in shared memory; `base16` holds the granule's
// base when `have_base` (a 16-byte load made ahead).
template <bool kPartial, typename T>
__device__ __forceinline__ void finish_granule(const Args<T>& a, const float* sa,
                                               long long p0, int n, uint4 base16,
                                               bool have_base) {
  constexpr int kG = 16 / sizeof(T);
  const bool whole = n == kG;
  float v[kG];
#pragma unroll
  for (int q = 0; q < kG / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(sa)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
  float o[kG], m2[kG], b[kG];
  unpack(base16, b);
#pragma unroll
  for (int e = 0; e < kG; ++e) {
    m2[e] = 0.f;
    o[e] = v[e];
    if (!kPartial && e < n) {
      const float base = have_base ? b[e] : load_f(a.base + p0 + e);
      o[e] = finish(v[e], base, p0 + e, a, m2[e]);
    }
  }
  if (whole && aligned16(a.out + p0)) {
    *reinterpret_cast<uint4*>(a.out + p0) = pack(o);
  } else {
#pragma unroll
    for (int e = 0; e < kG; ++e) {
      if (e < n) a.out[p0 + e] = from_f<T>(o[e]);
    }
  }
  if (!kPartial && a.new_mu != nullptr) {
    if (whole && aligned16(a.new_mu + p0)) {
#pragma unroll
      for (int q = 0; q < kG / 4; ++q) {
        reinterpret_cast<float4*>(a.new_mu + p0)[q] =
            make_float4(m2[4 * q], m2[4 * q + 1], m2[4 * q + 2], m2[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kG; ++e) {
        if (e < n) a.new_mu[p0 + e] = m2[e];
      }
    }
  }
}

// One ring stage through the consumers: rows r0 .. r0 + nrows - 1 in order,
// one FMA each per owned column. Row r0's bytes start `shift` bytes into its
// buffer (its address mod 16) and each next row `step` bytes further, mod
// 16. kGated: the clip / compression transform (when either gate is on);
// without it the loop is a shared-memory load and an FMA per element.
template <bool kGated, typename T>
__device__ __forceinline__ void consume_stage(const Args<T>& a, const unsigned char* sbase,
                                              int row_stride, int r0, int nrows,
                                              unsigned shift, unsigned step, int t,
                                              const float* s_wn, const float* s_pre,
                                              const bool (&ok)[kColsPerThread],
                                              const int (&sg)[kColsPerThread],
                                              float (&acc)[kColsPerThread]) {
#pragma unroll 4
  for (int rr = 0; rr < nrows; ++rr) {
    const int c = r0 + rr;
    const T* srow = reinterpret_cast<const T*>(sbase + rr * row_stride + shift) + t;
    const float w = s_wn[c];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      if (ok[j]) {
        float x = to_f(srow[j * kConsumers]);
        if constexpr (kGated) x = transform(x, c, sg[j], a, s_pre);
        acc[j] = fmaf(w, x, acc[j]);
      }
    }
    shift = (shift + step) & 15u;
  }
}

// kPartial: write the raw weighted sum (K4) instead of running the epilogue.
// T: the element type of the deltas, the base and the output.
template <bool kPartial, typename T>
__global__ void __launch_bounds__(kFedThreads) fedavg_kernel(Args<T> a, Plan pl) {
  constexpr int kG = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char fed_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(fed_smem);
  float* s_wn = reinterpret_cast<float*>(fed_smem + kBarBytes);
  float* s_pre = s_wn + a.C;
  float* s_acc = reinterpret_cast<float*>(fed_smem + acc_offset(a.C));
  unsigned char* ring = fed_smem + ring_offset(a.C, pl.tile_cols);
  const int row_stride = pl.tile_cols * static_cast<int>(sizeof(T)) + 16;

  // The block's range [lo, hi): granules split as evenly as they go.
  const long long granules = (a.P + kG - 1) / kG;
  const long long nb = gridDim.x, b = blockIdx.x;
  const long long per = granules / nb, extra = granules % nb;
  const long long g_lo = b * per + (b < extra ? b : extra);
  const long long lo = g_lo * kG;
  const long long hi_g = (g_lo + per + (b < extra ? 1 : 0)) * kG;
  const long long hi = hi_g < a.P ? hi_g : a.P;

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      bar_init(smem_u32(bars + s), 1);
      bar_init(smem_u32(bars + kMaxStages + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Warp 0 starts the copies at once; the consumers stage the weight and
  // clip rows meanwhile.
  if (threadIdx.x < 32) {
    produce<T>(a, pl, lo, hi, bars, ring, row_stride);
    return;
  }
  const int t = threadIdx.x - 32;
  for (int c = t; c < a.C; c += kConsumers) {
    s_wn[c] = a.wn[c];
    if (a.pre != nullptr) s_pre[c] = a.pre[c];
  }
  consumers_sync();

  const int lane = threadIdx.x & 31;
  const unsigned base_lo = static_cast<unsigned>(reinterpret_cast<uintptr_t>(a.upd));
  const unsigned step = static_cast<unsigned>(a.P * static_cast<long long>(sizeof(T))) & 15u;
  const bool gated = a.pre != nullptr || a.compression != kNone;
  const int stage_bytes = pl.rows * row_stride;
  int stage = 0;
  for (long long t0 = lo; t0 < hi; t0 += pl.tile_cols) {
    const long long t1 = t0 + pl.tile_cols < hi ? t0 + pl.tile_cols : hi;
    const int n_gran = static_cast<int>((t1 - t0 + kG - 1) / kG);
    // The base of this thread's first output granule, loaded ahead.
    uint4 base16 = make_uint4(0u, 0u, 0u, 0u);
    const long long pb = t0 + static_cast<long long>(t) * kG;
    const bool have_base = !kPartial && t < n_gran && pb + kG <= t1 &&
                           aligned16(a.base + pb);
    if (have_base) base16 = __ldg(reinterpret_cast<const uint4*>(a.base + pb));
    float acc[kColsPerThread];
    int sg[kColsPerThread];
    bool ok[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const long long p = t0 + t + j * kConsumers;
      ok[j] = p < t1;
      acc[j] = 0.f;
      sg[j] = (ok[j] && a.seg != nullptr) ? __ldg(a.seg + p) : 0;
    }
    for (int r0 = 0; r0 < a.C; r0 += pl.rows, ++stage) {
      const int slot = stage % pl.stages;
      bar_wait(smem_u32(bars + slot), (stage / pl.stages) & 1);
      const unsigned char* sbase = ring + slot * stage_bytes;
      const int nrows = min(pl.rows, a.C - r0);
      // Row r0's shift in its buffer: its first column's address mod 16.
      const unsigned shift =
          (base_lo + (static_cast<unsigned>(r0) * static_cast<unsigned>(a.P) +
                      static_cast<unsigned>(t0)) *
                         static_cast<unsigned>(sizeof(T))) &
          15u;
      if (gated) {
        consume_stage<true>(a, sbase, row_stride, r0, nrows, shift, step, t, s_wn, s_pre,
                            ok, sg, acc);
      } else {
        consume_stage<false>(a, sbase, row_stride, r0, nrows, shift, step, t, s_wn, s_pre,
                             ok, sg, acc);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(smem_u32(bars + kMaxStages + slot));
    }
    // The tile's sums go through shared memory so that each thread finishes
    // one 16-byte granule of the output.
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      if (ok[j]) s_acc[t + j * kConsumers] = acc[j];
    }
    consumers_sync();
    for (int gi = t; gi < n_gran; gi += kConsumers) {
      const long long p0 = t0 + static_cast<long long>(gi) * kG;
      const int n = static_cast<int>(t1 - p0 < kG ? t1 - p0 : kG);
      finish_granule<kPartial, T>(a, s_acc + gi * kG, p0, n, base16,
                                  have_base && gi == t);
    }
    if (t1 < hi) consumers_sync();  // before the next tile reuses s_acc
  }
}

// ---- robust_kernel: masked median / trimmed mean by a sorting network --- //

// Stage (P, K) of Batcher's odd-even merge sort over N2 entries compares a
// with a + K when j0 = K mod P <= a, (a - j0) / K is even, a + K < N2 and
// a, a + K lie in the same 2P-block (the stage's pairs are disjoint).
template <int N2, int P, int K, typename Col>
__device__ __forceinline__ void compare_exchange(Col& v, int a) {
  constexpr int j0 = K % P;
  if (a >= j0 && ((a - j0) / K) % 2 == 0 && a + K < N2 &&
      a / (2 * P) == (a + K) / (2 * P)) {
    const int x = v[a];
    const int y = v[a + K];
    v[a] = min(x, y);
    v[a + K] = max(x, y);
  }
}

// The network sorts integer keys in torch.sort's order of the floats (which
// counts -0.0 and +0.0 as equal): every NaN made one quiet NaN, then the
// sign-magnitude bits mapped to two's complement, so -inf < ... < -0.0 <
// +0.0 < ... < +inf < NaN. A compare-exchange is then an integer min / max
// pair that keeps both values (a float fminf / fmaxf pair would drop a NaN
// and duplicate its partner). The map is its own inverse.
__device__ __forceinline__ int sort_key(float x) {
  const int b = x != x ? 0x7fffffff : __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// One stage, a ascending. For a column in registers (an int[N2]) the loop
// and its condition unroll to a fixed list of min / max pairs on constant
// indices; for one in shared memory (SharedCol) it stays a loop,
// which keeps the 128- and 256-row instantiations small.
// tests/_robust_network.py lists the same pairs in the same order.
template <int N2, int P, int K, typename Col>
__device__ __forceinline__ void merge_stage(Col& v) {
  if constexpr (std::is_array<Col>::value) {
#pragma unroll
    for (int a = 0; a < N2; ++a) compare_exchange<N2, P, K>(v, a);
  } else {
#pragma unroll 1
    for (int a = 0; a < N2; ++a) compare_exchange<N2, P, K>(v, a);
  }
}

template <int N2, int P, int K, typename Col>
__device__ __forceinline__ void merge_steps(Col& v) {
  merge_stage<N2, P, K>(v);
  if constexpr (K > 1) merge_steps<N2, P, K / 2>(v);
}

// Sorts v[0..N2) ascending: P = 1, 2, ..., N2/2, and for each P the steps
// K = P, P/2, ..., 1. 543 compare-exchanges at N2 = 64.
template <int N2, int P = 1, typename Col>
__device__ __forceinline__ void sort_network(Col& v) {
  if constexpr (P < N2) {
    merge_steps<N2, P, P>(v);
    sort_network<N2, 2 * P>(v);
  }
}

// A thread's column in dynamic shared memory, row r at s[r * kRobustThreads]
// (a constant offset from the thread's first row once the network unrolls).
// Volatile, so that each compare-exchange reads and writes its two rows
// rather than the compiler holding the column in registers, which spilled.
struct SharedCol {
  volatile int* s;
  __device__ __forceinline__ volatile int& operator[](int r) const {
    return s[r * kRobustThreads];
  }
};

// Loads column p of the N2 rows into v (every load in flight before the
// network reads any of them), applies the clip / compression transform to
// the selected rows in a loop of its own, so that its uniform tests stay
// out of the load loop, maps the values to sort keys, sorts them and
// selects. Unselected clients are the reference's +inf sentinels: they sort
// after every selected value but a NaN, as in the reference's torch.sort
// over its C rows. The padding rows (c >= C) are NaN, whose key is the
// largest, so the first C sorted rows are the reference's and no index the
// selection reads (< C) reaches them. Index arithmetic is the reference's,
// including num_sel == 0 (median +inf, trimmed mean 0).
template <int N2, typename Col>
__device__ __forceinline__ float robust_column(const PipelineArgs& a, long long p,
                                               const float* s_wn, const float* s_pre,
                                               int trimmed, Col& v) {
  constexpr int kInfKey = 0x7f800000;  // +inf: its bits and its key
  constexpr int kNanBits = 0x7fffffff;  // a quiet NaN, key the largest
#pragma unroll
  for (int c = 0; c < N2; ++c) {
    int b = c < a.C ? kInfKey : kNanBits;
    if (c < a.C && s_wn[c] > 0.f) {
      b = __float_as_int(__ldg(a.upd + static_cast<long long>(c) * a.P + p));
    }
    v[c] = b;
  }
  if (a.pre != nullptr || a.compression != kNone) {
    const int sg = a.seg != nullptr ? __ldg(a.seg + p) : 0;
#pragma unroll
    for (int c = 0; c < N2; ++c) {
      if (c < a.C && s_wn[c] > 0.f) {
        v[c] = __float_as_int(transform(__int_as_float(v[c]), c, sg, a, s_pre));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < N2; ++c) v[c] = sort_key(__int_as_float(v[c]));
  sort_network<N2>(v);
  const int num_sel = __ldg(a.cnt);
  if (!trimmed) {
    const int lo = max((num_sel - 1) / 2, 0);
    const int hi = num_sel / 2;
    int klo = kInfKey, khi = kInfKey;
#pragma unroll
    for (int i = 0; i < N2; ++i) {
      klo = i == lo ? v[i] : klo;
      khi = i == hi ? v[i] : khi;
    }
    return __fmul_rn(0.5f, __fadd_rn(key_value(klo), key_value(khi)));
  }
  const int k_trim = __ldg(a.cnt + 1);
  const int end = num_sel - k_trim;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < N2; ++i) {
    if (i >= k_trim && i < end) total = __fadd_rn(total, key_value(v[i]));
  }
  return __fdiv_rn(total, static_cast<float>(max(num_sel - 2 * k_trim, 1)));
}

// Dynamic shared memory: the (C,) mask and clip rows, then (kShared) the
// block's columns, N2 rows of kRobustThreads keys.
__host__ __device__ inline long long robust_cols_offset(int C) {
  return align_up(8LL * C, 16);
}

// kShared = false: the column in registers (N2 <= 64); kShared = true: in
// shared memory (N2 in {128, 256}). `transform` tests its gates itself.
template <int N2, bool kShared>
__global__ void __launch_bounds__(kRobustThreads) robust_kernel(PipelineArgs a,
                                                                int trimmed) {
  extern __shared__ __align__(16) unsigned char robust_smem[];
  float* s_wn = reinterpret_cast<float*>(robust_smem);
  float* s_pre = s_wn + a.C;
  stage_rows(a, s_wn, s_pre);
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  float agg;
  if constexpr (kShared) {
    SharedCol v{reinterpret_cast<int*>(robust_smem + robust_cols_offset(a.C)) +
                threadIdx.x};
    agg = robust_column<N2>(a, p, s_wn, s_pre, trimmed, v);
  } else {
    int v[N2];
    agg = robust_column<N2>(a, p, s_wn, s_pre, trimmed, v);
  }
  epilogue(agg, p, a);
}

template <int N2, bool kShared>
int launch_robust_n2(const PipelineArgs& a, int trimmed, cudaStream_t s) {
  const long long blocks = (a.P + kRobustThreads - 1) / kRobustThreads;
  const long long smem =
      kShared ? robust_cols_offset(a.C) + 4LL * N2 * kRobustThreads : 8LL * a.C;
  if (blocks > 0x7fffffffLL || smem > kMaxSmem) return -1;
  if constexpr (kShared) {
    // Above 48 KB only after raising the attribute, once per instantiation
    // and device.
    constexpr int kMaxDevices = 64;
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= kMaxDevices) return -1;
    if (!raised[dev]) {
      e = cudaFuncSetAttribute(robust_kernel<N2, kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised[dev] = true;
    }
  }
  robust_kernel<N2, kShared><<<static_cast<unsigned>(blocks), kRobustThreads,
                               static_cast<size_t>(smem), s>>>(a, trimmed);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for N2 = the next power of two >= C.
int launch_robust(const PipelineArgs& a, int trimmed, cudaStream_t s) {
  int n2 = 1;
  while (n2 < a.C) n2 <<= 1;
  switch (n2) {
    case 1: return launch_robust_n2<1, false>(a, trimmed, s);
    case 2: return launch_robust_n2<2, false>(a, trimmed, s);
    case 4: return launch_robust_n2<4, false>(a, trimmed, s);
    case 8: return launch_robust_n2<8, false>(a, trimmed, s);
    case 16: return launch_robust_n2<16, false>(a, trimmed, s);
    case 32: return launch_robust_n2<32, false>(a, trimmed, s);
    case 64: return launch_robust_n2<64, false>(a, trimmed, s);
    case 128: return launch_robust_n2<128, true>(a, trimmed, s);
    case 256: return launch_robust_n2<256, true>(a, trimmed, s);
    default: return -1;
  }
}

// Checks the host's plan against the kernel's layout and launches
// fedavg_kernel; 0, a cudaError_t, or -1 for a plan it does not take.
template <bool kPartial, typename T>
int launch_streaming(const Args<T>& a, int blocks, int tile_cols, int rows, int stages,
                     int smem_bytes, cudaStream_t s) {
  constexpr int kG = 16 / sizeof(T);
  if (blocks <= 0 || tile_cols <= 0 || tile_cols > kMaxTileCols || tile_cols % kG != 0 ||
      rows <= 0 || stages <= 0 || stages > kMaxStages) {
    return -1;
  }
  const long long row_stride = static_cast<long long>(tile_cols) * sizeof(T) + 16;
  const long long need = ring_offset(a.C, tile_cols) +
                         static_cast<long long>(stages) * rows * row_stride;
  if (smem_bytes < need || smem_bytes > kMaxSmem) return -1;
  if (reinterpret_cast<uintptr_t>(a.upd) % sizeof(T) != 0) return -1;
  // Allow the kernel the most shared memory a block may have, once per
  // instantiation and device (the attribute is per device).
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(fedavg_kernel<kPartial, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  fedavg_kernel<kPartial, T><<<blocks, kFedThreads, smem_bytes, s>>>(
      a, Plan{tile_cols, rows, stages});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// robust_kernel launches the card accepted, counted where they are made.
static long long g_robust_launches = 0;

extern "C" {

// Returns 0 on success, a cudaError_t after a refused launch, or -1 for
// arguments the kernel does not take. The trailing plan arguments of the
// weighted-sum entries (blocks, tile_cols, rows, stages, smem_bytes) come
// from `fedavg_plan` in delta_pipeline.py.
// `spans` (C * ceil(P / kNormCols) floats) takes the per-span sums; with
// one span a row the first kernel writes `out` itself and `spans` may be
// null.
int fedfog_delta_sq_norms(const float* upd, float* out, float* spans, int C,
                          long long P, void* stream) {
  if (C <= 0 || C > 65535 || P <= 0) return -1;
  const long long n_spans = (P + kNormCols - 1) / kNormCols;
  if (n_spans > 2147483647LL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_spans), static_cast<unsigned>(C));
  if (n_spans == 1) {
    sq_norms_kernel<<<grid, kNormThreads, 0, s>>>(upd, out, P);
    return static_cast<int>(cudaGetLastError());
  }
  if (spans == nullptr) return -1;
  sq_norms_kernel<<<grid, kNormThreads, 0, s>>>(upd, spans, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sq_norms_combine_kernel<<<C, kNormThreads, 0, s>>>(spans, out,
                                                     static_cast<int>(n_spans));
  return static_cast<int>(cudaGetLastError());
}

int fedfog_delta_pipeline(const float* upd, const float* base, const float* wn,
                          const int* cnt, const float* pre, const int* seg,
                          const float* tab, const float* noise, const float* mu,
                          float* out, float* new_mu, int C, int L, long long P,
                          float lr, float server_momentum, int compression,
                          int aggregator, int optimizer, int blocks, int tile_cols,
                          int rows, int stages, int smem_bytes, void* stream) {
  if (C <= 0 || P <= 0 || C > 4096) return -1;
  if (compression != kNone && (seg == nullptr || tab == nullptr || L <= 0)) return -1;
  if (aggregator != kFedavg && (cnt == nullptr || C > kRobustMaxC)) return -1;
  if ((mu == nullptr) != (new_mu == nullptr)) return -1;
  PipelineArgs a{upd, base, wn, cnt, pre, seg, tab, noise, mu, out, new_mu,
                 P, C, L, lr, server_momentum, compression, optimizer};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aggregator == kFedavg) {
    return launch_streaming<false, float>(a, blocks, tile_cols, rows, stages, smem_bytes, s);
  }
  const int e = launch_robust(a, aggregator == kTrimmed, s);
  if (e == 0) ++g_robust_launches;
  return e;
}

long long fedfog_robust_launches() { return g_robust_launches; }

// K4: out (P,) = sum over the C fog-local clients of dm[i] * T(upd[i, :]).
int fedfog_delta_pipeline_partial(const float* upd, const float* dm,
                                  const float* pre, const int* seg,
                                  const float* tab, float* out, int C, int L,
                                  long long P, int compression, int blocks,
                                  int tile_cols, int rows, int stages,
                                  int smem_bytes, void* stream) {
  if (C <= 0 || P <= 0 || C > 4096) return -1;
  if (compression != kNone && (seg == nullptr || tab == nullptr || L <= 0)) return -1;
  PipelineArgs a{upd, nullptr, dm, nullptr, pre, seg, tab, nullptr, nullptr,
                 out, nullptr, P, C, L, 0.f, 0.f, compression, kPlain};
  return launch_streaming<true, float>(a, blocks, tile_cols, rows, stages, smem_bytes,
                                       static_cast<cudaStream_t>(stream));
}

// K1: out (D,) = base + sum over the N clients of wn[i] * upd[i, :], wn the
// lr-scaled normalised weight row. dtype: 0 = float32, 1 = bfloat16, one
// type for upd, base and out.
int fedfog_fedavg_apply(const void* upd, const void* base, const float* wn,
                        void* out, int N, long long D, int dtype, int blocks,
                        int tile_cols, int rows, int stages, int smem_bytes,
                        void* stream) {
  if (N <= 0 || D <= 0 || N > 4096) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a{static_cast<const float*>(upd), static_cast<const float*>(base), wn,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  static_cast<float*>(out), nullptr, D, N, 0, 1.f, 0.f, kNone, kPlain};
    return launch_streaming<false, float>(a, blocks, tile_cols, rows, stages, smem_bytes, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    Args<bf16> a{static_cast<const bf16*>(upd), static_cast<const bf16*>(base), wn,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 static_cast<bf16*>(out), nullptr, D, N, 0, 1.f, 0.f, kNone, kPlain};
    return launch_streaming<false, bf16>(a, blocks, tile_cols, rows, stages, smem_bytes, s);
  }
  return -1;
}

}  // extern "C"
