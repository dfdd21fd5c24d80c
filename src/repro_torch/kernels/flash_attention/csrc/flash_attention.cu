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
// The first design (f32 products on CUDA cores, K/V converted to
// f32 through 2-byte loads, two barriers per tile and no overlap) took
// 0.039 ms there, 1 % of that bound; this one 0.0066 ms, 6 %, beside
// 0.0070 ms for SDPA (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
//
// Two routes, chosen by the input dtype, both held against the plain
// version (ref.py):
//
// bfloat16 (the serving path): tensor cores, latency first.
//   * one warp owns 16 query rows of one head: S = Q·K^T and O += P·V are
//     `mma.sync.m16n8k16` with bf16 operands and f32 accumulators (wgmma
//     wants 64-row tiles: too few blocks at 128-token prompts); the
//     scores are exact bf16 x bf16 products summed in f32, the scale is
//     applied in f32 after the product, together with log2(e), so the
//     online softmax runs in base 2 (one ex2 per weight, without expf's
//     range reduction);
//   * a block holds the query heads of one kv head (up to TC_HEADS warps,
//     more heads take more blocks) over the same 16 rows, so each K/V tile
//     is read once per group: grid (ceil(Sq / 16), Hkv * head blocks, B),
//     64 blocks of 4 warps at the serving shape;
//   * K and V tiles of TC_BKV = 64 keys (32 at hd 256) stay bf16 in shared memory, filled
//     by 16-byte `cp.async.cg` copies (keys past Sk zero-filled) into rows
//     padded by 16 bytes, so `ldmatrix` (K) and `ldmatrix.trans` (V) read
//     without bank conflicts; two stages, so tile t+1 is in flight while
//     tile t is multiplied (the serving shape's <= 2 tiles per block are
//     both requested before the first product);
//   * q fragments come straight from device memory into registers; at
//     hd 256 (gemma3-12b) they would not fit beside the 128 accumulator
//     registers, so the warp's 16 q rows are copied into shared memory
//     with the first tile and read one k-step at a time, and K/V tiles
//     hold 32 keys (64 spilled 136 bytes at 255 registers; 32 keys use 243
//     and none; 0.314 ms at 2,048 tokens with the 1,024 window, 8 % of
//     its tensor-core bound, chip_smoke.py on the same card);
//   * softmax weights P stay f32 for the row sums; for P·V each is split
//     into hi = bf16(P) and lo = bf16(P - hi), two mma per tile, so P keeps
//     ~16 bits where the reference keeps it in f32 (plain bf16 P would
//     round it to 8);
//   * the reference's guards: m_safe for a row with nothing live yet,
//     max(l, 1e-30) at the end; masks are taken per element only in the
//     tiles that straddle the causal diagonal, the window edge or Sk.
// What bounds it now is a fixed cost per block: at one key tile per block
// it takes ~5.3 us against ~1.9 us for a one-element kernel, and a second
// tile adds ~1.4 us (tools/time_attention.py, same card). Two warps per
// head on alternate tiles (same SM), and a cluster splitting a row tile's
// keys across SMs with a merge through distributed shared memory, were
// both measured slower (PERF.md).
//
// float32: `flash_fwd_f32_kernel`, the first design, on CUDA cores (bf16
// tensor cores would keep ~3 digits of float32 inputs, far from the
// float32 tolerance of 1e-5): one block of 128 threads per (q tile of 32
// rows, head, batch), 4 threads per query row, kv tiles of 32 keys staged
// in shared memory as f32, q scaled by hd^-0.5 before the product.
//
// Both read the inputs through element strides (head_dim contiguous), so
// the model layout (B, S, H, hd) needs no transposed copy; the bf16 route
// needs 16-byte aligned rows (strides in multiples of 8 elements), which
// the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // element strides; head_dim is contiguous
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 16;    // query rows per warp (one m16 tile)
// Keys per K/V tile: 64, and 32 past hd 128, where a tile's 64 scores a
// thread would push the 128 accumulator registers of hd 256 into spills.
template <int HD>
__host__ __device__ constexpr int tc_bkv() { return HD > 128 ? 32 : 64; }
constexpr int TC_HEADS = 4;  // query heads (warps) per block at most
constexpr int TC_STAGES = 2;

template <int HD>
__host__ __device__ constexpr int tc_ld() { return HD + 8; }  // padded row, in bf16
// Past hd 128 a warp's q fragments (HD / 4 registers a thread) would not
// fit beside its output accumulators (HD / 2) under the 255-register
// limit: they stay in shared memory and are read per k-step.
template <int HD>
__host__ __device__ constexpr bool tc_q_smem() { return HD > 128; }
template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (TC_STAGES * 2 * tc_bkv<HD>() * tc_ld<HD>() +
          (tc_q_smem<HD>() ? TC_HEADS * TC_BQ * tc_ld<HD>() : 0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x - hi.x, y - hi.y); x in the low half.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

template <int HD>
__global__ void __launch_bounds__(32 * TC_HEADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      Strides qs, Strides ks, Strides vs, Strides os, int sq, int sk,
                      int groups, int head_blocks, int window, int bidirectional,
                      float scale_log2) {
  constexpr int LD = tc_ld<HD>();
  constexpr int TC_BKV = tc_bkv<HD>();
  constexpr int TILE = TC_BKV * LD;  // bf16 per K or V tile
  constexpr int KSTEPS = HD / 16;    // k-steps of Q·K^T
  constexpr int NB_S = TC_BKV / 8;   // 8-key column blocks of S
  constexpr int NB_O = HD / 8;       // 8-dim column blocks of O
  constexpr int CHUNKS = HD / 8;     // 16-byte chunks per row
  constexpr bool Q_SMEM = tc_q_smem<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][K|V][BKV][LD]
  // Q_SMEM: [warp][BQ][LD] after the K/V stages
  __nv_bfloat16* q_s = kv_s + TC_STAGES * 2 * TILE + (threadIdx.x >> 5) * TC_BQ * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthr = blockDim.x;
  const int kvh = blockIdx.y / head_blocks;
  const int gi = (blockIdx.y % head_blocks) * (nthr >> 5) + warp;  // head within the group
  const bool active = gi < groups;
  const int h = kvh * groups + (active ? gi : 0);
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TC_BQ;
  const int off = sk - sq;
  const int r0 = lane >> 2;  // this thread's rows: r0 and r0 + 8
  const int c2 = (lane & 3) * 2;

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  // Keys any row of this tile can see: [kv_lo, kv_hi).
  const int first_q = q0 + off;
  const int last_q = min(q0 + TC_BQ, sq) - 1 + off;
  int kv_lo = 0, kv_hi = sk;
  if (!bidirectional) {
    kv_hi = min(sk, last_q + 1);
    if (window > 0) kv_lo = max(0, first_q - window + 1);
  }
  const int t_lo = kv_lo / TC_BKV;
  const int t_hi = kv_hi > 0 ? (kv_hi + TC_BKV - 1) / TC_BKV : 0;

  auto load_tile = [&](int t, int stage) {
    const int k0 = t * TC_BKV;
    __nv_bfloat16* kt = kv_s + stage * 2 * TILE;
    __nv_bfloat16* vt = kt + TILE;
    for (int i = tid; i < TC_BKV * CHUNKS; i += nthr) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int kj = k0 + r;
      const bool in = kj < sk;
      const long long row = in ? kj : 0;  // a valid address; the copy zero-fills
      cp_async16(smem_addr(kt + r * LD + c), kb + row * ks.s + c, in ? 16 : 0);
      cp_async16(smem_addr(vt + r * LD + c), vb + row * vs.s + c, in ? 16 : 0);
    }
  };

  const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
  if constexpr (Q_SMEM) {
    // The warp's 16 query rows, in the first copy group with tile t_lo
    // (rows past sq and inactive warps zero-filled).
    for (int i = lane; i < TC_BQ * CHUNKS; i += 32) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int qi = q0 + r;
      const bool in = active && qi < sq;
      cp_async16(smem_addr(q_s + r * LD + c), qh + (in ? qi : 0) * qs.s + c, in ? 16 : 0);
    }
  }
  if (t_lo < t_hi) load_tile(t_lo, 0);
  cp_async_commit();

  // q fragments (A operand of Q·K^T), straight from device memory, or
  // (Q_SMEM) a k-step's worth at a time from shared memory.
  uint32_t qa[Q_SMEM ? 1 : KSTEPS][4];
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + (j & 1) * 8;
      const int col = kk * 16 + c2 + (j >> 1) * 8;
      if constexpr (Q_SMEM) {
        a[j] = *reinterpret_cast<const uint32_t*>(q_s + r * LD + col);
      } else {
        const int qi = q0 + r;
        a[j] = (active && qi < sq)
                   ? *reinterpret_cast<const uint32_t*>(qh + qi * qs.s + col)
                   : 0u;
      }
    }
  };
  if constexpr (!Q_SMEM) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) q_frag(kk, qa[kk]);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NB_O][4];
#pragma unroll
  for (int nb = 0; nb < NB_O; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_tile(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // ... and every other thread's
    if (active) {
      const __nv_bfloat16* kt = kv_s + stage * 2 * TILE;
      const __nv_bfloat16* vt = kt + TILE;
      const int k0 = t * TC_BKV;

      // S = Q·K^T (16 x 64) in f32.
      float s[NB_S][4];
#pragma unroll
      for (int nb = 0; nb < NB_S; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if constexpr (Q_SMEM) q_frag(kk, qa[0]);
        const uint32_t(&a)[4] = qa[Q_SMEM ? 0 : kk];
#pragma unroll
        for (int nb = 0; nb < NB_S; nb += 2) {
          const int row = nb * 8 + (lane & 7) + (lane >> 4) * 8;
          const int col = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(smem_addr(kt + row * LD + col), b0, b1, b2, b3);
          mma_bf16(s[nb], a, b0, b1);
          mma_bf16(s[nb + 1], a, b2, b3);
        }
      }

      // Scale in f32, by hd^-0.5·log2(e): the softmax runs in base 2 (one
      // ex2 per weight); mask per element only where the tile straddles
      // an edge.
      bool edge = k0 + TC_BKV > sk;
      if (!bidirectional) {
        edge = edge || k0 + TC_BKV - 1 > first_q;
        if (window > 0) edge = edge || last_q - k0 >= window;
      }
      float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nb = 0; nb < NB_S; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nb][e] * scale_log2;
          if (edge) {
            const int kp = k0 + nb * 8 + c2 + (e & 1);
            const int qp = first_q + r0 + (e >> 1) * 8;
            bool vis = kp < sk;
            if (!bidirectional) {
              vis = vis && kp <= qp;
              if (window > 0) vis = vis && (qp - kp) < window;
            }
            x = vis ? x : NEG_INF;
          }
          s[nb][e] = x;
          mc[e >> 1] = fmaxf(mc[e >> 1], x);
        }

      // Online softmax; the 4 lanes of a row hold its 64 scores.
      float corr[2], m_safe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
        mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
        const float m_new = fmaxf(m[i], mc[i]);
        m_safe[i] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        corr[i] = exp2f((m[i] <= NEG_INF * 0.5f ? NEG_INF : m[i]) - m_safe[i]);
        m[i] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < NB_S; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nb][e] - m_safe[e >> 1]);
          s[nb][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
        l[i] = l[i] * corr[i] + psum[i];
      }
#pragma unroll
      for (int nb = 0; nb < NB_O; ++nb) {
        acc[nb][0] *= corr[0];
        acc[nb][1] *= corr[0];
        acc[nb][2] *= corr[1];
        acc[nb][3] *= corr[1];
      }

      // O += P·V with P = hi + lo, two bf16 products per k-step.
#pragma unroll
      for (int kk = 0; kk < TC_BKV / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);          // row r0
        split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);          // row r0 + 8
        split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);  // row r0, keys + 8
        split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int nb = 0; nb < NB_O; nb += 2) {
          const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = nb * 8 + (lane >> 4) * 8;
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(smem_addr(vt + row * LD + col), b0, b1, b2, b3);
          mma_bf16(acc[nb], hi, b0, b1);
          mma_bf16(acc[nb], lo, b0, b1);
          mma_bf16(acc[nb + 1], hi, b2, b3);
          mma_bf16(acc[nb + 1], lo, b2, b3);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

  if (!active) return;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + i * 8;
    if (qi >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + qi * os.s + c2;
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * i] / den, acc[nb][2 * i + 1] / den);
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int h,
                        int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs,
                        Strides os, int window, int bidirectional, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kern = flash_fwd_bf16_kernel<HD>;
  // Once per instantiation (the attribute persists for the process).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int groups = h / hkv;
  const int warps = groups < TC_HEADS ? groups : TC_HEADS;
  const int head_blocks = (groups + warps - 1) / warps;
  const dim3 grid((sq + TC_BQ - 1) / TC_BQ, hkv * head_blocks, b);
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), qs, ks, vs, os,
      sq, sk, groups, head_blocks, window, bidirectional,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int THREADS = 128;  // 4 threads per query row

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides qs,
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    q_s[r * HDP + d] = qi < sq ? qb[qi * qs.s + d] * scale : 0.f;
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
      k_s[c * HDP + d] = in ? kb[kj * ks.s + d] : 0.f;
      v_s[c * HD + d] = in ? vb[kj * vs.s + d] : 0.f;
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
    float* ob = o + b * os.b + h * os.h + qi * os.s;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[sub + 4 * j] = acc[j] / den;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int h,
                       int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs,
                       Strides os, int window, int bidirectional, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kern = flash_fwd_f32_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), qs, ks, vs, os, sq, sk, h / hkv, window, bidirectional,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, int b,
                   int h, int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs,
                   Strides os, int window, int bidirectional, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route).
// Strides in elements, per (batch, head, sequence); head_dim contiguous;
// bfloat16 needs 16-byte aligned rows. Returns cudaGetLastError() of the
// launch.
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
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 32: return launch<32>(dtype, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 64: return launch<64>(dtype, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 128: return launch<128>(dtype, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    case 256: return launch<256>(dtype, q, k, v, o, b, h, hkv, sq, sk, qs, ks, vs, os, window, bidirectional, st);
    default: return cudaErrorInvalidValue;
  }
}
