// Kernel-mixture log-density denominator for Hopper (sm_90a).
//
//   out[i] = logsumexp_j( log_w[j] - 0.5 * sum_p (a[i,p] - b[j,p])^2 )
//
// a: [n, p] scaled query particles, b: [m, p] scaled mixture centers (the
// previous generation's survivors), log_w: [m] log mixture weights; all f32.
// This is the O(N * M * P) weight denominator of the reference's
// src/AbcUtil.cpp:563-578 loop.
//
// Replaces abcsmc_tpu/ops/pallas_kernels.py::mixture_logsumexp (the
// wrapper's clamp, max_lw bound and augmentation), ::_mixture_kernel_static,
// ::_mixture_kernel_online and ::_dot_logits, launched there by
// ::_pallas_logsumexp. The TPU wrapper's `precision` chooses how
// _dot_logits forms the logits; here it chooses one of three programs
// (`scheme`, a template parameter of the partial kernel):
//
// - HIGH (3xTF32; "high", the config default): the Hopper form of the
//   TPU's packed split-bf16. The operands are augmented as the TPU wrapper
//   does, a_aug = [a, log2(e) (-|a|^2/2 - max_lw) + 64, 1] and
//   b_aug = [log2(e) b, 1, log2(e) (lw - |b|^2/2)], so one dot is the
//   whole logit in log2 units, and the two large folded terms meet an
//   exact 1 (~2^-23 relative error each). K = p+2 is padded to a multiple
//   of 8 and looped over, so any p runs. Each operand is split into a TF32
//   hi part and the TF32-rounded residual; hi.hi + hi.lo + lo.hi
//   accumulate in FP32 with mma.sync.m16n8k8 (~2^-21 relative per product
//   term; see hi_step for the order).
// - BF16 (one pass; "default"): the TPU's one plain bf16 pass. The
//   operands are the TPU wrapper's in natural units, a_aug = [a, -|a|^2/2
//   - max_lw, 1] and b_aug = [b, 1, lw - |b|^2/2], each rounded to bf16
//   (round to nearest even) from its float32 value, as the MXU rounds
//   them; the squared norms are summed in FP64 and rounded once to FP32,
//   so the plain version (ops/kernels.py) rounds the same values. One
//   mma.sync.m16n8k16 per 16 columns of K (padded to 16) forms the logit
//   minus max_lw in FP32; log2(e) and the headroom are applied to the
//   accumulator (one FFMA per logit), not folded into the operands, where
//   a bf16 column near 64 would carry an ulp of 0.5.
// - FFMA (full FP32; "highest"): the TPU's 6-pass full-f32 product
//   (_dot_logits "highest", Mosaic's six bf16 passes), here FP32 FMAs on
//   the CUDA cores in log2 units, unsplit; a kernel of its own, laid out
//   as an SGEMM (see "The FFMA program" below).
//
// What bounds it: one exponential per logit. At 50,000 x 50,000 that is
// 2.5e9 ex2 on the special-function units, 16 per SM per clock: 132 SMs x
// 16 x 1.98 GHz = 4.18e12/s, 0.60 ms. The dot is 3 x 8 ceil((p+2)/8) TF32
// FMAs per logit for HIGH (1,024 per SM per clock), 16 ceil((p+2)/16)
// BF16 FMAs for BF16 (2,048) and p+2 FFMAs for FFMA (128); the inputs are
// 2.4 MB (~1 us at 3.35 TB/s). So the design keeps every other pipe below
// the SFU where it can (FFMA at p+2 > 8 cannot):
//
// - ex2.approx.ftz on the pre-scaled logits (one MUFU op, no range
//   reduction); the log is finished as log2 x ln 2.
// - STATIC sums ex2(logit + 64) with the a-priori bound max_lw =
//   max_j log_w[j] folded in (the logit is then <= 0), so a row whose sum
//   underflows comes out -inf as on the TPU (see kHeadroom).
// - ONLINE keeps a running max per thread and row, but moves it lazily:
//   only when a pair of new logits exceeds it by more than kTau (2^8),
//   tested once per 8-center tile with a warp vote; every term is then
//   <= 2^kTau and the rescale is off the per-logit path. The four threads
//   that share a row merge by shuffles.
// - AUTO runs STATIC, whose merge raises a device flag on any non-finite
//   row, then launches ONLINE, which returns at once unless the flag is
//   up: the TPU wrapper's lax.cond rerun, with no host sync.
// - The query operands stay in registers for the whole kernel when K is
//   small (HIGH K <= 32, BF16 K <= 32; FFMA stages them in shared memory);
//   the b_aug tiles are written once, in the scheme's order, by the
//   prologue and stream through shared memory with cp.async, double
//   buffered, so tile t+1 loads while tile t multiplies and
//   exponentiates. For larger K both operands come through L1 instead.
// - The center axis is split across blockIdx.y (at keep 2,048 there are only
//   16 query blocks for 132 SMs); the last block of each query block to
//   finish merges the splits' partials (an arrival counter, no extra pass).
//
// One call is two launches (three in AUTO): the prologue (the -1e30 clamp,
// per-block maxima of the live log-weights, b_aug; the clamp and the max_lw
// rule are the TPU wrapper's, pallas_kernels.py:209-215) and the partial
// kernel(s). The prologue builds b_aug a stage at a time, one float4
// (HIGH), uint2 (BF16) or column slot (FFMA) a thread (build_stage), so
// its stores coalesce; a block takes spb stages (the plan's
// prologue_blocks: 4 from 16,385 centers, 1 below, where a call is short
// and the prologue's parallelism is what its time is).
//
// The FFMA program. Its dot is p+2 FP32 operations a logit against the
// SFU's one ex2: at 128 FP32 operations and 16 ex2 per SM and clock the
// two pipes tie at p = 6, and the FP32 pipe bounds it above. Each logit
// also issues its ex2 and the FADD of its row sum, so the SM's issue
// slots (4 warp-instructions a clock) hold it to about (p+2)/(p+4) of the
// bound. The design gives the issue slots to those instructions alone:
// - SGEMM form: each thread owns an 8-row x 8-center micro-tile of the
//   block's 128 rows x 64-center stage, 64 independent accumulators. Per
//   column k, two LDS.128 of a (rows 4rg.. and 64+4rg.. of row group rg:
//   one address per row group, a broadcast) and two of b (centers 4cg..
//   and 32+4cg..: the eight center groups of a quarter warp on distinct
//   banks) feed 64 FFMAs.
// - No column of ones: a stage holds b's p columns (times log2(e)) and
//   the column constant cb = log2(e) (lw - |b|^2/2) (for a dead center
//   the sentinel log2(e) x -1e30, exact FP32); each accumulator starts at
//   ca_i + cb_j, ca = log2(e) (-|a|^2/2 - max_lw) + 64, and adds the p
//   products in column order. Rounding order: fl(ca + cb), then one
//   fused multiply-add for each column k = 0 .. p-1. A logit is p FFMAs
//   and one FADD, and with its row sum's FADD exactly the p+2 FP32
//   operations the bound counts.
// - a is staged once per block in shared memory, [column][row], for
//   p < 24 (at most 11.5 KB); b's stages stream through two cp.async
//   buffers. For p >= 24 the KS = 0 instance streams a's and b's columns
//   through shared memory in chunks of 16, so any p runs without a global
//   load per logit.
// - Per stage, the epilogue takes ex2 of the 64 logits and sums them per
//   row; ONLINE keeps HIGH's lazy max (kTau) with one vote per micro-tile.
//   The eight threads that share a row group are eight lanes of one warp
//   and merge by shuffles; the split merge is the other schemes'.
// On an H100 this reaches about half the bound at p = 6 and 62 % at
// p = 13 (PERF.md): with its ex2s taken out the same FFMA and FADD stream
// runs at 69-77 % of the FP32 pipe's peak, and the ex2s, which share the
// warps' issue slots, overlap it only in part. Variants that kept a or b
// in registers, interleaved one row half's ex2s with the other half's
// FFMAs, or ran 8 x 4 tiles at higher occupancy were all slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kMT = 2;             // m16 tiles per warp: 32 query rows
constexpr int kRows = 4 * 16 * kMT;  // query rows per block
constexpr int kStageTiles = 8;     // n8 tiles per stage
constexpr int kStageCenters = 8 * kStageTiles;
constexpr int kPrologueThreads = 256;
constexpr int kMicro = 8;          // FFMA: rows and centers of a thread's tile
constexpr int kChunk = 16;         // FFMA KS = 0: columns per shared chunk
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF sentinel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kTau = 8.f;        // lazy-max slack, log2 units
// Headroom folded into every live logit (log2 units): STATIC sums terms of
// up to 2^64 (m < 2^31 of them stay below 2^128), and a term reaches the
// flush-to-zero floor of ex2.approx.ftz (2^-126) only 190 below max_lw
// rather than 126, which is past the 2^-149 floor of an FP32 exp.
constexpr float kHeadroom = 64.f;
constexpr unsigned kFull = 0xffffffffu;

enum Scheme { kHigh = 0, kBf16 = 1, kFfma = 2 };

// The largest KS whose query operands a scheme keeps on chip for the whole
// kernel (HIGH and BF16: in registers, k-steps of 8 and 16; FFMA: in
// shared memory, KS = ceil((p+1)/8)). Above it the KS = 0 instance reads
// them through L1 (HIGH, BF16) or in chunks of kChunk columns (FFMA).
__host__ __device__ constexpr int max_reg_ks(int scheme) {
  return scheme == kHigh ? 4 : scheme == kBf16 ? 2 : 3;
}

// float4s of shared memory in one stage buffer of the KS > 0 instance: a
// stage of 64 centers' b_aug at up to its register k-steps (FFMA: up to 8
// KS rows, b's p columns and cb). The stage's own size (stage_f4) comes
// from the launch plan (ops/kernels.py); a larger one is refused.
__host__ __device__ constexpr int stage_capacity_f4(int scheme, int ks) {
  return kStageTiles * ks * (scheme == kHigh ? 32 : 16);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint16_t to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// {lo, hi} as one bf16x2 register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)to_bf16(lo) | ((uint32_t)to_bf16(hi) << 16);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column `col` of row `r` of a_aug = [a, ca, 1, 0...] (ca in the scheme's
// units: log2 with headroom for HIGH, natural for BF16).
__device__ __forceinline__ float a_aug(const float* __restrict__ a, int r,
                                       int col, int n, int p, float ca) {
  if (col < p) return r < n ? a[(size_t)r * p + col] : 0.f;
  if (col == p) return ca;
  return col == p + 1 ? 1.f : 0.f;
}


// Per-thread, per-row logsumexp state over the logits it has seen (log2
// units): the running max mx, its move threshold th = mx + kTau and the sum
// sm. STATIC keeps the sum only (the max is the a-priori 0).
template <bool ONLINE>
__device__ __forceinline__ void accumulate(const float (&d)[4],
                                           float (&mx)[2], float (&th)[2],
                                           float (&sm)[2]) {
  if (ONLINE) {
    const float c0 = fmaxf(d[0], d[1]);
    const float c1 = fmaxf(d[2], d[3]);
    if (__any_sync(kFull, c0 > th[0] || c1 > th[1])) {
      if (c0 > th[0]) {
        sm[0] *= ex2(mx[0] - c0);
        mx[0] = c0;
        th[0] = c0 + kTau;
      }
      if (c1 > th[1]) {
        sm[1] *= ex2(mx[1] - c1);
        mx[1] = c1;
        th[1] = c1 + kTau;
      }
    }
    sm[0] += ex2(d[0] - mx[0]) + ex2(d[1] - mx[0]);
    sm[1] += ex2(d[2] - mx[1]) + ex2(d[3] - mx[1]);
  } else {
    sm[0] += ex2(d[0]) + ex2(d[1]);
    sm[1] += ex2(d[2]) + ex2(d[3]);
  }
}

struct PartialArgs {
  const float* a;
  const float4* bfrag;
  const float* lwmax;  // per-prologue-block maxima of the live log-weights
  int n_lwmax, n, p, ks, n_stages, stages_per_split, n_split;
  int stage_f4;        // float4s of one stage (the launch plan's)
  float* part_max;     // [n_split, n] (ONLINE only)
  float* part_sum;     // [n_split, n]
  int* arrivals;       // [q_blocks], 0 on entry and on exit
  int* flag_out;       // static pass of auto: set to 1 on a non-finite row
  const int* gate;     // online pass of auto: return at once if *gate == 0
  float* out;          // [n]
};

// max_lw: the largest live log-weight, 0 when there is none (warp 0 of the
// block writes it to *dst)
__device__ __forceinline__ void block_max_lw(const PartialArgs& A, int lane,
                                             float* dst) {
  float mx = -INFINITY;
  for (int i = lane; i < A.n_lwmax; i += 32) mx = fmaxf(mx, A.lwmax[i]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if (lane == 0) *dst = isfinite(mx) ? mx : 0.f;
}

// sum_k b_k^2 of a center's row in column order
__device__ __forceinline__ float row_bsq(const float* bc, int p) {
  float bsq = 0.f;
  for (int k = 0; k < p; ++k) bsq = fmaf(bc[k], bc[k], bsq);
  return bsq;
}

// One stage of b_aug (centers j0 .. j0 + 63) into global memory, in the
// scheme's order, one float4 (HIGH), uint2 (BF16) or column slot (FFMA) a
// thread at a time (threads tid of nthreads). Dead centers (sentinel
// weight or padding) are all zero but for the weight column, which holds
// the sentinel (exact in TF32 and bf16), so their logit is exactly that
// sentinel and its exponential exactly 0. log_w is read only for a
// center below m, its row of b only for a live one.
// - HIGH: mma B-fragment order: for n8 tile nt and k-step s, lane
//   (g = center % 8, t) holds float4 {b0 hi, b1 hi, b0 lo, b1 lo} with
//   b0 = B[k = 8s + t][g] and b1 = B[k = 8s + t + 4][g]; log2 units.
// - BF16: m16n8k16 B-fragment order: lane (g, t) of k-step s holds
//   {B[16s + 2t][g], B[16s + 2t + 1][g]} and {B[16s + 2t + 8][g],
//   B[16s + 2t + 9][g]} as two bf16x2; natural units.
// - FFMA: center c of a stage holds B[k][c] at k * 64 + c for ks = p + 1
//   rows: log2(e) b in rows k < p, cb = log2(e) (lw - |b|^2/2) in row p
//   (no row of ones: see the FFMA program); a dead center's row p is the
//   FP32 sentinel log2(e) x -1e30.
// Stage st (centers 64 st ..) starts stage_f4 float4s after stage st - 1;
// the orders above are those within a stage (nt: the n8 tile in it).
template <int SCHEME>
__device__ __forceinline__ void build_stage(float4* stage, const float* b,
                                            const float* log_w, int j0,
                                            int m, int p, int ks, int tid,
                                            int nthreads) {
  auto row = [&](int c) { return b + (size_t)(j0 + c) * p; };
  auto clamped_lw = [&](int c) {
    return j0 + c < m ? fmaxf(log_w[j0 + c], kNegInf) : kNegInf;
  };
  if constexpr (SCHEME == kHigh) {
    const float sentinel = __uint_as_float(to_tf32(kNegInf * kLog2e));
    for (int q = tid; q < kStageTiles * ks * 32; q += nthreads) {
      const int tile = q >> 5, lane = q & 31;
      const int nt = tile / ks, s = tile - nt * ks;
      const int c = nt * 8 + (lane >> 2);
      const float lw = clamped_lw(c);
      const bool live = lw > 0.5f * kNegInf;
      uint32_t hi[2], lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * s + (lane & 3) + 4 * h;
        float v;
        if (!live) {
          v = k == p + 1 ? sentinel : 0.f;
        } else if (k < p) {
          v = kLog2e * row(c)[k];
        } else if (k == p) {
          v = 1.f;
        } else {
          v = k == p + 1 ? kLog2e * fmaf(-0.5f, row_bsq(row(c), p), lw)
                         : 0.f;
        }
        split_tf32(v, hi[h], lo[h]);
      }
      stage[q] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                             __uint_as_float(lo[0]), __uint_as_float(lo[1]));
    }
  } else if constexpr (SCHEME == kBf16) {
    uint2* st2 = reinterpret_cast<uint2*>(stage);
    for (int q = tid; q < kStageTiles * ks * 32; q += nthreads) {
      const int tile = q >> 5, lane = q & 31;
      const int nt = tile / ks, s = tile - nt * ks;
      const int c = nt * 8 + (lane >> 2);
      const float lw = clamped_lw(c);
      const bool live = lw > 0.5f * kNegInf;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * s + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
        if (k == p + 1) {
          double bsq = 0.0;
          if (live) {
            const float* bc = row(c);
            for (int cc = 0; cc < p; ++cc) {
              const double x = bc[cc];
              bsq = fma(x, x, bsq);
            }
          }
          v[i] = live ? fmaf(-0.5f, (float)bsq, lw) : kNegInf;
        } else if (live && k < p) {
          v[i] = row(c)[k];
        } else {
          v[i] = live && k == p ? 1.f : 0.f;
        }
      }
      st2[q] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  } else {
    float* col = reinterpret_cast<float*>(stage);
    for (int i = tid; i < p * kStageCenters; i += nthreads) {
      const int k = i >> 6, c = i & (kStageCenters - 1);
      const bool live = clamped_lw(c) > 0.5f * kNegInf;
      col[i] = live ? kLog2e * row(c)[k] : 0.f;
    }
    for (int c = tid; c < kStageCenters; c += nthreads) {
      const float lw = clamped_lw(c);
      col[p * kStageCenters + c] =
          lw > 0.5f * kNegInf
              ? kLog2e * fmaf(-0.5f, row_bsq(row(c), p), lw)
              : kNegInf * kLog2e;
    }
  }
}

// The -1e30 clamp, the per-block maxima of the live log-weights (block bx
// takes the centers of stages [bx spb, (bx + 1) spb)), the arrival
// counters and the flag zeroed, and b_aug built once per call: each block
// builds its spb stages (build_stage). The clamp and the max_lw rule are
// the TPU wrapper's, pallas_kernels.py:209-215.
__global__ void __launch_bounds__(kPrologueThreads)
prologue_kernel(const float* __restrict__ b, const float* __restrict__ log_w,
                int m, int p, int ks, int stage_f4, int scheme, int n_stages,
                int spb, float* __restrict__ bfrag,
                float* __restrict__ part_lwmax, int* __restrict__ arrivals,
                int q_blocks, int* __restrict__ flag) {
  __shared__ float red[kPrologueThreads / 32];
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kPrologueThreads + tid;
  for (int i = j; i < q_blocks; i += gridDim.x * kPrologueThreads)
    arrivals[i] = 0;
  if (j == 0) *flag = 0;

  const int c0 = blockIdx.x * spb * kStageCenters;
  const int c1 = min(m, c0 + spb * kStageCenters);
  float mx = -INFINITY;
  for (int c = c0 + tid; c < c1; c += kPrologueThreads) {
    const float lw = fmaxf(log_w[c], kNegInf);
    if (lw > 0.5f * kNegInf) mx = fmaxf(mx, lw);
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kPrologueThreads / 32; ++w) mx = fmaxf(mx, red[w]);
    part_lwmax[blockIdx.x] = mx;
  }

  for (int st = blockIdx.x * spb; st < min(n_stages, (blockIdx.x + 1) * spb);
       ++st) {
    float4* stage = reinterpret_cast<float4*>(bfrag) + (size_t)st * stage_f4;
    const int j0 = st * kStageCenters;
    if (scheme == kHigh)
      build_stage<kHigh>(stage, b, log_w, j0, m, p, ks, tid,
                         kPrologueThreads);
    else if (scheme == kBf16)
      build_stage<kBf16>(stage, b, log_w, j0, m, p, ks, tid,
                         kPrologueThreads);
    else
      build_stage<kFfma>(stage, b, log_w, j0, m, p, ks, tid,
                         kPrologueThreads);
  }
}

// Once each block has written its partial (max, sum) per row: the last of
// the n_split blocks of query block blockIdx.x to arrive merges them and
// writes out[] (no separate combine launch), one row per thread.
template <bool ONLINE>
__device__ __forceinline__ void merge_splits(const PartialArgs& A,
                                             float max_lw, bool* s_last) {
  const int n = A.n;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(&A.arrivals[blockIdx.x], 1) == A.n_split - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (threadIdx.x == 0) A.arrivals[blockIdx.x] = 0;  // for the next pass
  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= n) return;
  float m = 0.f;  // STATIC: the max is the a-priori bound, 0 after shift
  if (ONLINE) {
    m = -INFINITY;
    for (int k = 0; k < A.n_split; ++k)
      m = fmaxf(m, __ldcg(A.part_max + (size_t)k * n + row));
  }
  float s = 0.f;
  for (int k = 0; k < A.n_split; ++k) {
    const size_t o = (size_t)k * n + row;
    s += ONLINE ? __ldcg(A.part_sum + o) * ex2(__ldcg(A.part_max + o) - m)
                : __ldcg(A.part_sum + o);
  }
  const float v = (m - kHeadroom + log2f(s)) * kLn2 + max_lw;
  A.out[row] = v;
  if (A.flag_out != nullptr && !isfinite(v)) *A.flag_out = 1;
}

// One hi.hi product of k-step s on top of d: into d itself for the first
// k-step (d then holds only the small terms), else into a fresh accumulator
// added in FP32. The tensor cores align each sum to its largest term and
// truncate, so an accumulator that carries the large partial logit from
// k-step to k-step loses ~1 ulp of it per mma; this keeps it to one.
__device__ __forceinline__ void hi_step(float (&d)[4], const uint32_t (&hi)[4],
                                        const float4& bv, bool first) {
  const uint32_t b0 = __float_as_uint(bv.x), b1 = __float_as_uint(bv.y);
  if (first) {
    mma_tf32(d, hi, b0, b1);
  } else {
    float e[4] = {};
    mma_tf32(e, hi, b0, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += e[i];
  }
}

// HIGH and BF16. KS > 0: the query operands in registers (HIGH: K = 8 KS;
// BF16: K <= 16 KS), b_aug stages through shared memory (cp.async, two
// buffers). KS == 0: any K, both operands read through L1. Each block
// writes its partial (max, sum) per row, then merge_splits.
template <int SCHEME, int KS, bool ONLINE>
__global__ void __launch_bounds__(kThreads)
mixture_partial_kernel(const PartialArgs A) {
  static_assert(kRows == kThreads, "the merge takes one row per thread");
  static_assert(SCHEME != kFfma, "FFMA is ffma_partial_kernel");
  static_assert(KS <= max_reg_ks(SCHEME), "KS beyond the register path");
  constexpr int kStage = KS == 0 ? 1 : stage_capacity_f4(SCHEME, KS);
  __shared__ __align__(16) float4 sb[KS > 0 ? 2 : 1][kStage];
  __shared__ float s_max_lw;
  __shared__ bool s_last;

  if (A.gate != nullptr && *A.gate == 0) return;  // auto: nothing to rerun
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n = A.n, p = A.p;

  if (warp == 0) block_max_lw(A, lane, &s_max_lw);

  const int st_begin = blockIdx.y * A.stages_per_split;
  const int st_end = min(A.n_stages, st_begin + A.stages_per_split);
  auto issue = [&](int st, int buf) {
    if constexpr (KS > 0) {
      const float4* src = A.bfrag + (size_t)st * A.stage_f4;
      for (int i = threadIdx.x; i < A.stage_f4; i += kThreads) {
        const uint32_t dst =
            static_cast<uint32_t>(__cvta_generic_to_shared(&sb[buf][i]));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                     "l"(src + i));
      }
      asm volatile("cp.async.commit_group;");
    }
  };
  issue(st_begin, 0);
  __syncthreads();  // s_max_lw
  const float max_lw = s_max_lw;

  // rows of this thread: r[mt][h] = base + 16 mt + g + 8 h; ca is the row
  // constant column of a_aug in the scheme's units. BF16 sums |a|^2 in
  // FP64 and keeps it rounded to FP32, all that ca takes of it.
  int r[kMT][2];
  float ca[kMT][2];
  using Sq = std::conditional_t<SCHEME == kBf16, double, float>;
  float sqs[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r[mt][h] = blockIdx.x * kRows + warp * 16 * kMT + 16 * mt + g + 8 * h;
      Sq sq = 0;
      if (r[mt][h] < n)
        for (int c = t; c < p; c += 4) {
          const Sq v = A.a[(size_t)r[mt][h] * p + c];
          if constexpr (SCHEME == kBf16)
            sq = fma(v, v, sq);
          else
            sq = fmaf(v, v, sq);
        }
      sq += __shfl_xor_sync(kFull, sq, 1);
      sq += __shfl_xor_sync(kFull, sq, 2);
      sqs[mt][h] = static_cast<float>(sq);
    }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (SCHEME == kBf16)
        ca[mt][h] = fmaf(-0.5f, sqs[mt][h], -max_lw);
      else
        ca[mt][h] = fmaf(kLog2e, fmaf(-0.5f, sqs[mt][h], -max_lw), kHeadroom);
    }

  auto a_frag = [&](int s, int mt, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int c0 = 8 * s + t;
    split_tf32(a_aug(A.a, r[mt][0], c0, n, p, ca[mt][0]), hi[0], lo[0]);
    split_tf32(a_aug(A.a, r[mt][1], c0, n, p, ca[mt][1]), hi[1], lo[1]);
    split_tf32(a_aug(A.a, r[mt][0], c0 + 4, n, p, ca[mt][0]), hi[2], lo[2]);
    split_tf32(a_aug(A.a, r[mt][1], c0 + 4, n, p, ca[mt][1]), hi[3], lo[3]);
  };
  // m16n8k16 A fragment: rows g, g+8 x columns 2t, 2t+1 (+8), bf16x2
  auto a_frag_bf16 = [&](int s, int mt, uint32_t (&f)[4]) {
    const int c0 = 16 * s + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, c = c0 + 8 * (i >> 1);
      f[i] = pack_bf16(a_aug(A.a, r[mt][h], c, n, p, ca[mt][h]),
                       a_aug(A.a, r[mt][h], c + 1, n, p, ca[mt][h]));
    }
  };
  constexpr int kRegHigh = SCHEME == kHigh && KS > 0 ? KS : 1;
  constexpr int kRegBf16 = SCHEME == kBf16 && KS > 0 ? KS : 1;
  uint32_t ahi[kRegHigh][kMT][4], alo[kRegHigh][kMT][4];
  uint32_t abf[kRegBf16][kMT][4];
  if constexpr (KS > 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if constexpr (SCHEME == kHigh) {
#pragma unroll
        for (int s = 0; s < KS; ++s) a_frag(s, mt, ahi[s][mt], alo[s][mt]);
      } else {
#pragma unroll
        for (int s = 0; s < KS; ++s) a_frag_bf16(s, mt, abf[s][mt]);
      }
    }
  }

  float mx[kMT][2], th[kMT][2], sm[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[mt][h] = th[mt][h] = -INFINITY;
      sm[mt][h] = 0.f;
    }

  for (int st = st_begin, it = 0; st < st_end; ++st, ++it) {
    const float4* tile;
    if constexpr (KS > 0) {
      if (st + 1 < st_end) {
        issue(st + 1, (it + 1) & 1);
        asm volatile("cp.async.wait_group 1;");
      } else {
        asm volatile("cp.async.wait_group 0;");
      }
      __syncthreads();
      tile = sb[it & 1];
    } else {
      tile = A.bfrag + (size_t)st * A.stage_f4;
    }
#pragma unroll 2
    for (int nt = 0; nt < kStageTiles; ++nt) {
      float d[kMT][4] = {};
      if constexpr (SCHEME == kHigh && KS > 0) {
        float4 bv[KS];
#pragma unroll
        for (int s = 0; s < KS; ++s) {  // small terms first
          bv[s] = tile[(nt * KS + s) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_tf32(d[mt], alo[s][mt], __float_as_uint(bv[s].x),
                     __float_as_uint(bv[s].y));
            mma_tf32(d[mt], ahi[s][mt], __float_as_uint(bv[s].z),
                     __float_as_uint(bv[s].w));
          }
        }
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            hi_step(d[mt], ahi[s][mt], bv[s], s == 0);
      } else if constexpr (SCHEME == kHigh) {
        float dl[kMT][4] = {};
        for (int s = 0; s < A.ks; ++s) {
          const float4 bv = tile[(nt * A.ks + s) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t hi[4], lo[4];
            a_frag(s, mt, hi, lo);
            mma_tf32(dl[mt], lo, __float_as_uint(bv.x), __float_as_uint(bv.y));
            mma_tf32(dl[mt], hi, __float_as_uint(bv.z), __float_as_uint(bv.w));
            hi_step(d[mt], hi, bv, false);
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[mt][i] += dl[mt][i];
      } else {  // BF16
        const uint2* tile2 = reinterpret_cast<const uint2*>(tile);
        if constexpr (KS > 0) {
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const uint2 bv = tile2[(nt * KS + s) * 32 + lane];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_bf16(d[mt], abf[s][mt], bv.x, bv.y);
          }
        } else {
          for (int s = 0; s < A.ks; ++s) {
            const uint2 bv = tile2[(nt * A.ks + s) * 32 + lane];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              uint32_t f[4];
              a_frag_bf16(s, mt, f);
              mma_bf16(d[mt], f, bv.x, bv.y);
            }
          }
        }
        // natural units -> log2 units with the headroom
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            d[mt][i] = fmaf(d[mt][i], kLog2e, kHeadroom);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        accumulate<ONLINE>(d[mt], mx[mt], th[mt], sm[mt]);
    }
    if constexpr (KS > 0)
      __syncthreads();  // this buffer is refilled next
  }

  // merge the four threads of each row, then one partial per (split, row)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m0 = mx[mt][h], s0 = sm[mt][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float m1 = __shfl_xor_sync(kFull, m0, o);
        const float s1 = __shfl_xor_sync(kFull, s0, o);
        if (ONLINE) {
          const float mn = fmaxf(m0, m1);
          s0 = s0 * ex2(m0 - mn) + s1 * ex2(m1 - mn);
          m0 = mn;
        } else {
          s0 += s1;
        }
      }
      const int row = r[mt][h];
      if (t == 0 && row < n) {
        const size_t o = (size_t)blockIdx.y * n + row;
        A.part_sum[o] = s0;
        if (ONLINE) A.part_max[o] = m0;
      }
    }
  merge_splits<ONLINE>(A, max_lw, &s_last);
}

// FFMA micro-tile coordinates of a thread: row group rg = 4 warp + lane / 8
// owns rows 4 rg + i and 64 + 4 rg + i (i < 4) of the block, center group
// cg = lane % 8 centers 4 cg + j and 32 + 4 cg + j (j < 4) of a stage.
__device__ __forceinline__ int micro_row(int rg, int i) {
  return (i < 4 ? 0 : 64 - 4) + 4 * rg + i;
}

// One column k of the micro-tile: the 8 rows of a (sa_k = a's column k,
// [row]) times the 8 centers of b (sb_k = b's column k, [center]).
__device__ __forceinline__ void ffma_column(float (&d)[kMicro][kMicro],
                                            const float* sa_k,
                                            const float* sb_k, int rg,
                                            int cg) {
  const float4 a0 = *reinterpret_cast<const float4*>(sa_k + 4 * rg);
  const float4 a1 = *reinterpret_cast<const float4*>(sa_k + 64 + 4 * rg);
  const float4 b0 = *reinterpret_cast<const float4*>(sb_k + 4 * cg);
  const float4 b1 = *reinterpret_cast<const float4*>(sb_k + 32 + 4 * cg);
  const float av[kMicro] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[kMicro] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
}

// The micro-tile's logits into the per-thread, per-row state (accumulate's,
// one vote per tile).
template <bool ONLINE>
__device__ __forceinline__ void ffma_epilogue(const float (&d)[kMicro][kMicro],
                                              float (&mx)[kMicro],
                                              float (&th)[kMicro],
                                              float (&sm)[kMicro]) {
  if (ONLINE) {
    float top[kMicro];
    bool up = false;
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      top[i] = fmaxf(fmaxf(fmaxf(d[i][0], d[i][1]), fmaxf(d[i][2], d[i][3])),
                     fmaxf(fmaxf(d[i][4], d[i][5]), fmaxf(d[i][6], d[i][7])));
      up |= top[i] > th[i];
    }
    if (__any_sync(kFull, up)) {
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        if (top[i] > th[i]) {
          sm[i] *= ex2(mx[i] - top[i]);
          mx[i] = top[i];
          th[i] = top[i] + kTau;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float e[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j)
      e[j] = ex2(ONLINE ? d[i][j] - mx[i] : d[i][j]);
    sm[i] += ((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7]));
  }
}

// FFMA ("highest"; see the FFMA program). KS > 0: a's p < 8 KS columns
// staged in shared memory for the whole block, b's stages through two
// cp.async buffers. KS == 0: any p, a's and b's columns through shared
// memory in chunks of kChunk. Each block writes its partial (max, sum)
// per row, then merge_splits.
template <int KS, bool ONLINE>
__global__ void __launch_bounds__(kThreads)
ffma_partial_kernel(const PartialArgs A) {
  static_assert(kRows == kThreads, "the merge and ca take one row a thread");
  static_assert(kRows == 16 * kMicro && kStageCenters == 8 * kMicro,
                "16 row groups x 8 center groups of 8 x 8");
  static_assert(KS <= max_reg_ks(kFfma), "KS beyond the staged path");
  static_assert(stage_capacity_f4(kFfma, 1) == kThreads,
                "a stage is at most KS float4s a thread");
  constexpr int kACols = KS > 0 ? 8 * KS - 1 : kChunk;
  constexpr int kStage =
      KS > 0 ? stage_capacity_f4(kFfma, KS) : kChunk * kStageCenters / 4;
  __shared__ __align__(16) float sa[kACols * kRows];
  __shared__ __align__(16) float4 sb[KS > 0 ? 2 : 1][kStage];
  __shared__ __align__(16) float s_ca[kRows];
  __shared__ float s_max_lw;
  __shared__ bool s_last;

  if (A.gate != nullptr && *A.gate == 0) return;  // auto: nothing to rerun
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = 4 * warp + (lane >> 3), cg = lane & 7;
  const int n = A.n, p = A.p, base = blockIdx.x * kRows;

  if (warp == 0) block_max_lw(A, lane, &s_max_lw);
  const int st_begin = blockIdx.y * A.stages_per_split;
  const int st_end = min(A.n_stages, st_begin + A.stages_per_split);
  auto issue = [&](int st, int buf) {
    if constexpr (KS > 0) {  // a stage is at most KS float4s a thread
      const float4* src = A.bfrag + (size_t)st * A.stage_f4;
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        const int i = tid + r * kThreads;
        if (i >= A.stage_f4) break;
        const uint32_t dst =
            static_cast<uint32_t>(__cvta_generic_to_shared(&sb[buf][i]));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                     "l"(src + i));
      }
      asm volatile("cp.async.commit_group;");
    }
  };
  issue(st_begin, 0);
  if constexpr (KS > 0) {  // a's rows, [column][row]; rows past n are 0
    const float* src = A.a + (size_t)base * p;
    for (int i = tid; i < kRows * p; i += kThreads) {
      const int r = i / p;
      sa[(i - r * p) * kRows + r] = base + r < n ? src[i] : 0.f;
    }
  }
  __syncthreads();  // s_max_lw, sa
  const float max_lw = s_max_lw;
  {  // ca of row tid, its squares summed in column order
    float sq = 0.f;
    if (base + tid < n)
      for (int k = 0; k < p; ++k) {
        const float v = KS > 0 ? sa[k * kRows + tid]
                               : A.a[(size_t)(base + tid) * p + k];
        sq = fmaf(v, v, sq);
      }
    s_ca[tid] = fmaf(kLog2e, fmaf(-0.5f, sq, -max_lw), kHeadroom);
  }
  __syncthreads();
  float ca[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) ca[i] = s_ca[micro_row(rg, i)];

  float mx[kMicro], th[kMicro], sm[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    mx[i] = th[i] = -INFINITY;
    sm[i] = 0.f;
  }

  for (int st = st_begin, it = 0; st < st_end; ++st, ++it) {
    const float* tile;
    if constexpr (KS > 0) {
      if (st + 1 < st_end) {
        issue(st + 1, (it + 1) & 1);
        asm volatile("cp.async.wait_group 1;");
      } else {
        asm volatile("cp.async.wait_group 0;");
      }
      __syncthreads();
      tile = reinterpret_cast<const float*>(sb[it & 1]);
    } else {
      tile = reinterpret_cast<const float*>(A.bfrag + (size_t)st * A.stage_f4);
    }
    // d = fl(ca + cb), then one FMA per column in column order
    float d[kMicro][kMicro];
    {
      const float4 c0 =
          *reinterpret_cast<const float4*>(tile + p * kStageCenters + 4 * cg);
      const float4 c1 = *reinterpret_cast<const float4*>(
          tile + p * kStageCenters + 32 + 4 * cg);
      const float cb[kMicro] = {c0.x, c0.y, c0.z, c0.w,
                                c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) d[i][j] = ca[i] + cb[j];
    }
    if constexpr (KS > 0) {
#pragma unroll
      for (int k = 0; k < kACols; ++k) {
        if (k == p) break;
        ffma_column(d, sa + k * kRows, tile + k * kStageCenters, rg, cg);
      }
    } else {
      float* const sbf = reinterpret_cast<float*>(sb[0]);
      for (int c0 = 0; c0 < p; c0 += kChunk) {
        const int kc = min(kChunk, p - c0);
        __syncthreads();  // the last chunk is consumed
        for (int i = tid; i < kc * kRows; i += kThreads) {
          const int r = i / kc, k = i - r * kc;
          sa[k * kRows + r] =
              base + r < n ? A.a[(size_t)(base + r) * p + c0 + k] : 0.f;
        }
        for (int i = tid; i < kc * kStageCenters; i += kThreads)
          sbf[i] = tile[c0 * kStageCenters + i];
        __syncthreads();
        for (int k = 0; k < kc; ++k)
          ffma_column(d, sa + k * kRows, sbf + k * kStageCenters, rg, cg);
      }
    }
    ffma_epilogue<ONLINE>(d, mx, th, sm);
    if constexpr (KS > 0)
      __syncthreads();  // this buffer is refilled next
  }

  // merge the eight threads of each row (lanes 8 (lane / 8) ..), then one
  // partial per (split, row)
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float m0 = mx[i], s0 = sm[i];
#pragma unroll
    for (int o = 1; o <= 4; o <<= 1) {
      const float m1 = __shfl_xor_sync(kFull, m0, o);
      const float s1 = __shfl_xor_sync(kFull, s0, o);
      if (ONLINE) {
        const float mn = fmaxf(m0, m1);
        s0 = s0 * ex2(m0 - mn) + s1 * ex2(m1 - mn);
        m0 = mn;
      } else {
        s0 += s1;
      }
    }
    const int row = base + micro_row(rg, i);
    if (cg == 0 && row < n) {
      const size_t o = (size_t)blockIdx.y * n + row;
      A.part_sum[o] = s0;
      if (ONLINE) A.part_max[o] = m0;
    }
  }
  merge_splits<ONLINE>(A, max_lw, &s_last);
}

template <int SCHEME, int KS, bool ONLINE>
void start_partial(dim3 grid, cudaStream_t s, const PartialArgs& A) {
  if constexpr (SCHEME == kFfma)
    ffma_partial_kernel<KS, ONLINE><<<grid, kThreads, 0, s>>>(A);
  else
    mixture_partial_kernel<SCHEME, KS, ONLINE><<<grid, kThreads, 0, s>>>(A);
}

// The instance for kreg (the scheme's register k-steps, FFMA's staged
// 8-row groups): KS = kreg where the scheme keeps the query operands on
// chip, else KS = 0.
template <int SCHEME, bool ONLINE, int KS = 1>
cudaError_t launch_partial(int kreg, dim3 grid, cudaStream_t s,
                           const PartialArgs& A) {
  if constexpr (KS <= max_reg_ks(SCHEME)) {
    if (kreg == KS) {
      if (A.stage_f4 > stage_capacity_f4(SCHEME, KS))
        return cudaErrorInvalidValue;
      start_partial<SCHEME, KS, ONLINE>(grid, s, A);
      return cudaGetLastError();
    }
    return launch_partial<SCHEME, ONLINE, KS + 1>(kreg, grid, s, A);
  } else {
    start_partial<SCHEME, 0, ONLINE>(grid, s, A);
    return cudaGetLastError();
  }
}

template <bool ONLINE>
cudaError_t launch_scheme(int scheme, dim3 grid, cudaStream_t s,
                          const PartialArgs& A) {
  switch (scheme) {
    case kHigh: return launch_partial<kHigh, ONLINE>(A.ks, grid, s, A);
    case kBf16: return launch_partial<kBf16, ONLINE>(A.ks, grid, s, A);
    default:
      return launch_partial<kFfma, ONLINE>((A.ks + 7) / 8, grid, s, A);
  }
}

// Kernel launches the C entry has made that the runtime accepted: the
// prologue's and each pass's (mixture_logsumexp_launch_count).
std::atomic<unsigned long long> g_launches{0};

cudaError_t counted(cudaError_t err) {
  if (err == cudaSuccess) g_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

// The static and/or online pass (mode as the C entry's)
cudaError_t launch_passes(int mode, int scheme, dim3 grid, cudaStream_t s,
                          PartialArgs A, int* flag) {
  if (mode != 1) {
    A.flag_out = mode == 2 ? flag : nullptr;
    const cudaError_t err = counted(launch_scheme<false>(scheme, grid, s, A));
    if (err != cudaSuccess || mode == 0) return err;
    A.flag_out = nullptr;
    A.gate = flag;
  }
  return counted(launch_scheme<true>(scheme, grid, s, A));
}

}  // namespace

// C entry bound with ctypes. Pointers are device pointers, `stream` the
// caller's cudaStream_t; the workspace segments are sized by the wrapper's
// launch plan (ops/kernels.py::launch_plan): bfrag [n_stages * stage_f4
// float4s], lwmax [prologue_blocks], part_max and part_sum [n_split, n],
// arrivals [q_blocks] and flag [1] (int32); a prologue block builds
// ceil(n_stages / prologue_blocks) stages, and prologue_blocks must be at
// least 1. ks counts the scheme's k-steps: of 8 columns (HIGH), 16 (BF16),
// or FFMA's rows of a stage, which must be p+1 (b's p columns and cb);
// stage_f4 is the plan's size of one stage of 64 centers' b_aug, in
// float4s.
// mode: 0 static, 1 online, 2 auto (static pass that flags a non-finite
// row, then an online pass that runs only if flagged: the TPU wrapper's
// lax.cond, on the device). scheme: 0 HIGH (3xTF32), 1 BF16, 2 FFMA.
// Returns the first cudaGetLastError() that is not 0 (0 = success); the
// kernels run asynchronously on `stream` and nothing waits for them.
extern "C" int mixture_logsumexp_f32(
    const float* a, const float* b, const float* log_w, float* bfrag,
    float* lwmax, float* part_max, float* part_sum, int* arrivals, int* flag,
    float* out, int n, int m, int p, int ks, int stage_f4, int n_stages,
    int stages_per_split, int n_split, int prologue_blocks, int mode,
    int scheme, void* stream) {
  if (scheme < kHigh || scheme > kFfma || stage_f4 < 1 ||
      prologue_blocks < 1 || (scheme == kFfma && ks != p + 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_blocks = (n + kRows - 1) / kRows;
  const dim3 grid(q_blocks, n_split);
  const int spb = (n_stages + prologue_blocks - 1) / prologue_blocks;
  prologue_kernel<<<prologue_blocks, kPrologueThreads, 0, s>>>(
      b, log_w, m, p, ks, stage_f4, scheme, n_stages, spb, bfrag, lwmax,
      arrivals, q_blocks, flag);
  const cudaError_t err = counted(cudaGetLastError());
  if (err != cudaSuccess) return err;
  PartialArgs A{a, reinterpret_cast<const float4*>(bfrag), lwmax,
                prologue_blocks, n, p, ks, n_stages, stages_per_split,
                n_split, stage_f4, part_max, part_sum,
                arrivals, nullptr, nullptr, out};
  return launch_passes(mode, scheme, grid, s, A, flag);
}

// Kernels the C entry has launched in this process, the prologue counted
// (each launch the runtime accepted, whatever stream or graph capture it
// went to). A caller reads it around one call to count that call's
// launches.
extern "C" unsigned long long mixture_logsumexp_launch_count() {
  return g_launches.load(std::memory_order_relaxed);
}
