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
// function moves 3.15 MB (0.94 us at 3.35 TB/s); the stepwise recurrence
// needs 5*K*V + 3*K + 2*V operations per step and head, 85.2 MFLOP (1.27 us
// at 67 TFLOP/s in float32), so it is bound by operations. A kernel that
// walks the T steps one after another is bound by their latency instead.
//
// Design: a chunk-parallel float32 recurrence whose decay factors are all
// running products of clamped w <= 1. Within a chunk [c0, c1) of C = 16
// steps:
//
//     a_t = prod_{c0<=m<t} w_m      e_s = prod_{s<m<c1} w_m      g = a_{c1-1} w_{c1-1}
//     D_{t,s} = prod_{s<m<t} w_m    (D_{s+1,s} = 1, D_{t+1,s} = D_{t,s} w_t)
//     y_t   = (r_t * a_t) . S_in + sum_{c0<=s<t} (sum_k r_t k_s D_{t,s}) v_s
//             + (sum_k r_t u k_t) v_t
//     S_out = diag(g) S_in + sum_s (k_s * e_s)^T v_s
//
// The TPU kernel's closed form divides by the in-chunk decay product,
// which leaves float32's range once the decay passes e^-88 (five steps at
// the clamp). Here nothing is divided and nothing is exponentiated: a
// factor that underflows to 0 is one whose true value is below float32's
// range, as in the stepwise product. Only the carry between chunks is
// sequential:
//   * one block of 8 warps per (16 state columns, head, batch), B*H*4
//     blocks (128 at the prefill's shape, one per SM); column v of S and y
//     needs only column v of v, so the blocks of a head share nothing but
//     the V-independent scores, which each computes for itself (sharing
//     them across a cluster of the 4 blocks was slower, and so were 16
//     warps a block);
//   * the block stages a window of up to TW = 128 steps of r, k, w
//     (clamped) and its 16 columns of v in shared memory as float32, every
//     load requested before the first is used (16-byte loads where every
//     row is 16-byte aligned, element loads otherwise, as on a view that
//     starts mid-vector); the window's last chunk is padded with w = 1 and
//     r = k = v = 0, which leaves y and the state unchanged, as the JAX
//     wrapper's padding does;
//   * phase A, every chunk at once, one warp per chunk: the scores, each
//     lane carrying k_s * D_{t,s} for 4 of the chunk's s and 8 values of K
//     along t by running products (so a row of r or w is read once per
//     step for 4 s), the diagonal the bonus r_s . (u * k_s), the lanes'
//     parts summed at the end of the walk; then, lanes over K, the prefix
//     products a (r * a in place of r, and g), the suffix products e and
//     the chunk's own state term U_c = sum_s (k_s * e_s)^T v_s, all on CUDA
//     cores in float32;
//   * phase B, the carry: S_c = diag(g_c) S_{c-1} + U_c, T/C steps of one
//     FMA per state element, each thread keeping 4 elements of a row in
//     registers from window to window and leaving the state entering each
//     chunk in place of U_c;
//   * phase C, every chunk at once, a warp per 16 steps: y, the scores
//     times v plus (r * a) times the state entering the chunk, on the
//     tensor cores in 3xTF32 (each float32 operand split into two tf32
//     parts and the three larger products kept, about 2^-20 of each
//     product, far inside the 1e-5 that y is held to; the state never
//     passes through them), written in the input dtype.
// The sequential depth is C steps of running products plus T/C carries,
// against T dependent steps of the stepwise form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;                // K = V = 64: the repo's only head size
constexpr int VT = 16;                // state columns per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TW = 128;               // steps staged per window
constexpr int RS = HD + 4;            // row stride of r, k, w in shared memory (floats)
constexpr int VS = VT + 4;            // row stride of the per-chunk states (floats)
constexpr int VVS = VT + 8;           // row stride of the v tile (floats)
constexpr int C = 16;                 // steps per chunk: phase A's lanes take 4 s
                                      // each, phase C's tensor-core tiles 16 steps
constexpr int NC = TW / C;            // chunks per window

static_assert(TW == 16 * WARPS, "phase C: each warp owns 16 steps of the window");

// Shared memory of one block, in floats.
struct Smem {
  float r[TW * RS];             // r, then r * a
  float k[TW * RS];
  float w[TW * RS];             // clamped
  float v[TW * VVS];            // the block's columns of v
  float sc[NC * C * (C + 4)];   // per chunk [t][s]: the score of (t, s); 0 for s > t
  float st[NC * HD * VS];       // per chunk [k][v]: U_c, then the state entering chunk c
  float g[NC * HD];             // per chunk: its decay g
  float u[HD];
};
static_assert(sizeof(Smem) <= 232448, "shared memory of one block");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of T as floats.
__device__ __forceinline__ void unpack(const uint4& q, float* f, float) {
  f[0] = __uint_as_float(q.x); f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z); f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float* f, __nv_bfloat16) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// x as a tf32 pair (integer rounding, as cvt.rna would round, at full
// ALU rate): hi = x rounded to tf32's 10 mantissa bits, lo = x - hi exactly,
// which the tensor core reads to 10 bits, so hi_a*hi_b + hi_a*lo_b +
// lo_a*hi_b carries a*b to about 2^-20 of |a*b| (3xTF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b on the tensor cores: a 16x8 row-major, b 8x8 column-major.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D (16 x 16) += A (16 x K, rows lda apart) B (K x 16, rows ldb apart) in
// 3xTF32, fragments of lane (g, q) = (lane / 4, lane % 4).
// The small products (lo terms) go to their own sums dl, so no MMA waits
// on the one before it for long.
template <int K>
__device__ __forceinline__ void mma_3xtf32(float (&d)[2][4], float (&dl)[2][4], const float* a,
                                           int lda, const float* b, int ldb, int g, int q) {
#pragma unroll
  for (int kb = 0; kb < K; kb += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a[g * lda + kb + q], ah[0], al[0]);
    split_tf32(a[(g + 8) * lda + kb + q], ah[1], al[1]);
    split_tf32(a[g * lda + kb + q + 4], ah[2], al[2]);
    split_tf32(a[(g + 8) * lda + kb + q + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(b[(kb + q) * ldb + 8 * nt + g], bh[0], bl[0]);
      split_tf32(b[(kb + q + 4) * ldb + 8 * nt + g], bh[1], bl[1]);
      mma_tf32(dl[nt], al, bh);
      mma_tf32(dl[nt], ah, bl);
      mma_tf32(d[nt], ah, bh);
    }
  }
}

template <typename T> __device__ __forceinline__ void store_y2(T* p, float x, float y);
template <> __device__ __forceinline__ void store_y2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <> __device__ __forceinline__ void store_y2<__nv_bfloat16>(__nv_bfloat16* p, float x,
                                                                    float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

struct Strides {
  long long b, t, h;  // element strides; the last dim (K or V) is contiguous
};

struct Args {
  const void *r, *k, *v, *w;
  const float* u;
  void* y;
  float* s_out;
  Strides rs, ks, vs, ws;
  int t_len, heads;
  float w_min;
};

// Stage rows [0, n) of the window starting at t0; rows [n, TW) get the
// padding (w = 1, r = k = v = 0). VEC: 16-byte loads, all requested first,
// each thread reading the same 16 bytes of every RPP-th row of r, k and w.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(Smem& sm, const T* rb, const T* kb, const T* wb,
                                      const T* vb, const Args& a, int t0, int n, int v0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);   // elements per 16 bytes
    constexpr int VPR = HD / E;         // vectors per row of r, k, w
    constexpr int RPP = THREADS / VPR;  // rows per pass
    constexpr int PASSES = TW / RPP;
    constexpr int VPV = VT / E;         // vectors per row of the v tile
    constexpr int PV = TW * VPV / THREADS;
    static_assert(THREADS % VPR == 0 && TW % RPP == 0 && PV * THREADS == TW * VPV, "staging");
    const int t = tid / VPR, c = (tid % VPR) * E;
    const T* src[3] = {rb + (t0 + t) * a.rs.t + c, kb + (t0 + t) * a.ks.t + c,
                       wb + (t0 + t) * a.ws.t + c};
    const long long step[3] = {RPP * a.rs.t, RPP * a.ks.t, RPP * a.ws.t};
    uint4 q[3][PASSES], qv[PV];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        if (t + RPP * j < n) q[x][j] = __ldg(reinterpret_cast<const uint4*>(src[x] + j * step[x]));
      }
    }
#pragma unroll
    for (int j = 0; j < PV; ++j) {
      const int tv = (tid + j * THREADS) / VPV, cv = (tid % VPV) * E;
      if (tv < n) qv[j] = __ldg(reinterpret_cast<const uint4*>(vb + (t0 + tv) * a.vs.t + v0 + cv));
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      float* dst = (x == 0 ? sm.r : x == 1 ? sm.k : sm.w) + t * RS + c;
#pragma unroll
      for (int j = 0; j < PASSES; ++j) {
        float f[E];
        if (t + RPP * j < n) {
          unpack(q[x][j], f, T());
          if (x == 2) {
#pragma unroll
            for (int e = 0; e < E; ++e) f[e] = fmaxf(f[e], a.w_min);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) f[e] = x == 2 ? 1.f : 0.f;
        }
#pragma unroll
        for (int e = 0; e < E; e += 4) st4(dst + RPP * j * RS + e, f + e);
      }
    }
#pragma unroll
    for (int j = 0; j < PV; ++j) {
      const int tv = (tid + j * THREADS) / VPV, cv = (tid % VPV) * E;
      float f[E];
      if (tv < n) {
        unpack(qv[j], f, T());
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; e += 4) st4(sm.v + tv * VVS + cv + e, f + e);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < TW * HD; i += THREADS) {
      const int t = i / HD, c = i % HD;
      float x = 0.f, y = 0.f, z = 1.f;
      if (t < n) {
        x = to_f(rb[(t0 + t) * a.rs.t + c]);
        y = to_f(kb[(t0 + t) * a.ks.t + c]);
        z = fmaxf(to_f(wb[(t0 + t) * a.ws.t + c]), a.w_min);
      }
      sm.r[t * RS + c] = x;
      sm.k[t * RS + c] = y;
      sm.w[t * RS + c] = z;
    }
    for (int i = tid; i < TW * VT; i += THREADS) {
      const int t = i / VT, c = i % VT;
      sm.v[t * VVS + c] = t < n ? to_f(vb[(t0 + t) * a.vs.t + v0 + c]) : 0.f;
    }
  }
}

// One exchange of a halving sum over lanes: the lane with `hi` keeps the
// upper M of its 2M values, its partner (lane ^ off) the lower M, each
// adding the other's.
template <int M>
__device__ __forceinline__ void halve(float* v, bool hi, int off) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float keep = hi ? v[i + M] : v[i];
    const float send = hi ? v[i] : v[i + M];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Phase A, the scores of chunk c, one warp.
// Lane (sg, p): steps s = 4*j + sg of the chunk (j < C/4) and 8 values of
// K, k = 4*(8*i + p) + e (i < 2), so a step's row of r or w is two 16-byte
// loads that the warp's lanes share. At step t (unrolled) the lane
// carries kq_j = k_s * D_{t,s} for each of its s: its dot with r_t is the
// score of (t, s) for s < t (0 for s > t, where kq is still 0); the lane
// with s = t adds its part of the bonus r_s . (u * k_s), computed before
// the walk, and then resets kq to k_t (D_{t+1,t} = 1), its own rows k_s
// being held from the start; every other kq is multiplied by w_t.
__device__ __forceinline__ void scores(Smem& sm, int c) {
  constexpr int SG = 4;            // lanes' groups of s
  constexpr int NJ = C / SG;       // steps s per lane
  const int lane = threadIdx.x & 31;
  const int sg = lane >> 3, p = lane & 7;
  const float* rc = sm.r + c * C * RS;
  const float* kc = sm.k + c * C * RS;
  const float* wc = sm.w + c * C * RS;
  float* out = sm.sc + c * C * (C + 4);  // out[t * (C + 4) + s]: score of (t, s)

  float ks[NJ][8], kq[NJ][8], bonus[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) bonus[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = 4 * (8 * i + p);
    const float4 u4 = ld4(sm.u + kk);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 k4 = ld4(kc + (SG * j + sg) * RS + kk), r4 = ld4(rc + (SG * j + sg) * RS + kk);
      ks[j][4 * i] = k4.x;
      ks[j][4 * i + 1] = k4.y;
      ks[j][4 * i + 2] = k4.z;
      ks[j][4 * i + 3] = k4.w;
      bonus[j] = fmaf(r4.x, u4.x * k4.x, bonus[j]);
      bonus[j] = fmaf(r4.y, u4.y * k4.y, bonus[j]);
      bonus[j] = fmaf(r4.z, u4.z * k4.z, bonus[j]);
      bonus[j] = fmaf(r4.w, u4.w * k4.w, bonus[j]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) kq[j][e] = 0.f;
  }

  // The C/4 parts of each step (64 per lane) are summed over the 8 lanes
  // of an sg after the walk: three halving exchanges, each lane keeping 8
  // sums, instead of a chain of exchanges at every step.
  static_assert(C * NJ == 64, "64 parts per lane");
  float part[C * NJ];  // [t][j]
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int jt = t / SG;              // the lanes' j whose s may equal t
    const bool own = sg == t % SG;      // this lane's s_jt is t
    float r8[8], w8[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = 4 * (8 * i + p);
      const float4 r4 = ld4(rc + t * RS + kk), w4 = ld4(wc + t * RS + kk);
      r8[4 * i] = r4.x; r8[4 * i + 1] = r4.y; r8[4 * i + 2] = r4.z; r8[4 * i + 3] = r4.w;
      w8[4 * i] = w4.x; w8[4 * i + 1] = w4.y; w8[4 * i + 2] = w4.z; w8[4 * i + 3] = w4.w;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float x0 = 0.f, x1 = 0.f;  // two sums, so no FMA waits on the last
      if (j <= jt) {
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          x0 = fmaf(r8[e], kq[j][e], x0);
          x1 = fmaf(r8[e + 1], kq[j][e + 1], x1);
        }
      }
      part[t * NJ + j] = (j == jt && own) ? x0 + x1 + bonus[j] : x0 + x1;
    }
    // D_{t+1,s} = D_{t,s} w_t; the lane with s = t starts its kq at k_t.
#pragma unroll
    for (int j = 0; j <= jt; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) kq[j][e] = (j == jt && own) ? ks[j][e] : kq[j][e] * w8[e];
    }
  }
  // Sum over the 8 lanes of the sg: lane p keeps the sums [8p, 8p + 8).
  halve<32>(part, p & 4, 4);
  halve<16>(part, p & 2, 2);
  halve<8>(part, p & 1, 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = 8 * p + i, t = f / NJ, j = f % NJ;
    out[t * (C + 4) + SG * j + sg] = part[i];
  }
}

// Phase A, the rest of chunk c, one warp, lanes over K (k = 2*lane,
// 2*lane + 1): the prefix products a by a running product forward, r * a
// in place of r (after the chunk's scores), and g; the suffix products e
// by a running product backward; then U_c = sum_s (k_s * e_s)^T v_s into
// st[c].
__device__ __forceinline__ void state_term(Smem& sm, int c) {
  const int k0 = 2 * (threadIdx.x & 31);
  float* rc = sm.r + c * C * RS + k0;
  const float* kc = sm.k + c * C * RS + k0;
  const float* wc = sm.w + c * C * RS + k0;
  float2 ak = make_float2(1.f, 1.f), wk[C];
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const float2 w2 = wk[t] = *reinterpret_cast<const float2*>(wc + t * RS);
    const float2 r2 = *reinterpret_cast<const float2*>(rc + t * RS);
    *reinterpret_cast<float2*>(rc + t * RS) = make_float2(r2.x * ak.x, r2.y * ak.y);
    ak.x *= w2.x;
    ak.y *= w2.y;
  }
  *reinterpret_cast<float2*>(sm.g + c * HD + k0) = ak;
  float ke0[C], ke1[C];
  float e0 = 1.f, e1 = 1.f;
#pragma unroll
  for (int s = C - 1; s >= 0; --s) {
    const float2 k2 = *reinterpret_cast<const float2*>(kc + s * RS);
    ke0[s] = k2.x * e0;
    ke1[s] = k2.y * e1;
    e0 *= wk[s].x;
    e1 *= wk[s].y;
  }
  float u0[VT], u1[VT];
#pragma unroll
  for (int j = 0; j < VT; ++j) u0[j] = u1[j] = 0.f;
  const float* vc = sm.v + c * C * VVS;
#pragma unroll
  for (int s = 0; s < C; ++s) {
#pragma unroll
    for (int j = 0; j < VT; j += 4) {
      const float4 v4 = ld4(vc + s * VVS + j);
      u0[j] = fmaf(ke0[s], v4.x, u0[j]);
      u0[j + 1] = fmaf(ke0[s], v4.y, u0[j + 1]);
      u0[j + 2] = fmaf(ke0[s], v4.z, u0[j + 2]);
      u0[j + 3] = fmaf(ke0[s], v4.w, u0[j + 3]);
      u1[j] = fmaf(ke1[s], v4.x, u1[j]);
      u1[j + 1] = fmaf(ke1[s], v4.y, u1[j + 1]);
      u1[j + 2] = fmaf(ke1[s], v4.z, u1[j + 2]);
      u1[j + 3] = fmaf(ke1[s], v4.w, u1[j + 3]);
    }
  }
  float* st = sm.st + c * HD * VS + k0 * VS;
#pragma unroll
  for (int j = 0; j < VT; j += 4) {
    st4(st + j, u0 + j);
    st4(st + VS + j, u1 + j);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) wkv6_chunked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * VT, h = blockIdx.y, b = blockIdx.z;
  const T* rb = static_cast<const T*>(a.r) + b * a.rs.b + h * a.rs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const T* wb = static_cast<const T*>(a.w) + b * a.ws.b + h * a.ws.h;
  if (tid < HD) sm.u[tid] = a.u[h * HD + tid];

  // Phase B: row bk of the state, columns bv..bv + 3.
  const int bk = lane + 32 * (warp & 1), bv = 4 * (warp >> 1);
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < a.t_len; t0 += TW) {
    const int n = min(TW, a.t_len - t0);
    const int nc = (n + C - 1) / C;
    stage<T, VEC>(sm, rb, kb, wb, vb, a, t0, n, v0);
    __syncthreads();

    // Phase A: every chunk's scores, then its state term (r * a over r).
    for (int c = warp; c < nc; c += WARPS) {
      scores(sm, c);
      __syncwarp();
      state_term(sm, c);
    }
    __syncthreads();

    // Phase B: the carry over the window's chunks.
    {
      float4 x[NC];
      float g[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          x[c] = ld4(sm.st + c * HD * VS + bk * VS + bv);
          g[c] = sm.g[c * HD + bk];
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc) {
          *reinterpret_cast<float4*>(sm.st + c * HD * VS + bk * VS + bv) = sk;
          sk.x = fmaf(g[c], sk.x, x[c].x);
          sk.y = fmaf(g[c], sk.y, x[c].y);
          sk.z = fmaf(g[c], sk.z, x[c].z);
          sk.w = fmaf(g[c], sk.w, x[c].w);
        }
      }
    }
    __syncthreads();

    // Phase C: y for steps [16*warp, 16*warp + 16) of the window, of chunk c,
    // on the tensor cores: the scores times v, then (r * a) times the state
    // entering the chunk.
    if (16 * warp < n) {
      const int m0 = 16 * warp, c = m0 / C;
      float d[2][4] = {}, dl[2][4] = {};
      mma_3xtf32<C>(d, dl, sm.sc + m0 * (C + 4), C + 4, sm.v + c * C * VVS, VVS, lane >> 2,
                    lane & 3);
      mma_3xtf32<HD>(d, dl, sm.r + m0 * RS, RS, sm.st + c * HD * VS, VS, lane >> 2, lane & 3);
      T* yb = static_cast<T*>(a.y) + v0 + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = m0 + (lane >> 2) + 8 * half;
        if (t < n) {
          const long long row = (static_cast<long long>(b) * a.t_len + t0 + t) * a.heads + h;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            store_y2<T>(yb + row * HD + 8 * nt, d[nt][2 * half] + dl[nt][2 * half],
                        d[nt][2 * half + 1] + dl[nt][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // the window's stage is consumed
  }

  float* so = a.s_out + (static_cast<long long>(b) * a.heads + h) * HD * HD + v0 + bv;
  *reinterpret_cast<float4*>(so + bk * HD) = sk;
}

template <typename T, bool VEC>
cudaError_t launch(const Args& a, int b, int h, cudaStream_t stream) {
  auto kern = wkv6_chunked_kernel<T, VEC>;
  constexpr int smem = static_cast<int>(sizeof(Smem));
  // Once per instantiation (the attribute persists for the process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(HD / VT, h, b), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, long long sb, long long st, long long sh, int elem) {
  const long long unit = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % unit == 0 && st % unit == 0 &&
         sh % unit == 0;
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
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const Args a{r, k, v, w, u, y, s_out, {rsb, rst, rsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
               {wsb, wst, wsh}, t, h, w_min};
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = aligned16(r, rsb, rst, rsh, elem) && aligned16(k, ksb, kst, ksh, elem) &&
                   aligned16(v, vsb, vst, vsh, elem) && aligned16(w, wsb, wst, wsh, elem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float, true>(a, b, h, st) : launch<float, false>(a, b, h, st);
  return vec ? launch<__nv_bfloat16, true>(a, b, h, st)
             : launch<__nv_bfloat16, false>(a, b, h, st);
}

// The launch plan, for reports: {chunk, window, threads, grid x, grid y,
// grid z, dynamic shared memory bytes} for a (B, H) problem.
extern "C" void fedfog_wkv6_plan(int b, int h, int* out) {
  out[0] = C;
  out[1] = TW;
  out[2] = THREADS;
  out[3] = HD / VT;
  out[4] = h;
  out[5] = b;
  out[6] = static_cast<int>(sizeof(Smem));
}
