// Kernel-mixture log-density denominator for Hopper (sm_90a).
//
//   out[i] = logsumexp_j( log_w[j] - 0.5 * sum_p (a[i,p] - b[j,p])^2 )
//
// a: [n, p] scaled query particles, b: [m, p] scaled mixture centers (the
// previous generation's survivors), log_w: [m] log mixture weights; all f32.
// This is the O(N * M * P) weight denominator of the reference's
// src/AbcUtil.cpp:563-578 loop.
//
// Replaces abcsmc_tpu/ops/pallas_kernels.py::_mixture_kernel_static and
// ::_mixture_kernel_online (launched by _pallas_logsumexp). It computes what
// they compute, not block by block:
//
// - Both modes live in one templated kernel. STATIC sums exp(logit - max_lw)
//   with the a-priori bound max_lw = max_j log_w[j] (logit <= max_lw because
//   the distance term is <= 0), so it needs no running max; ONLINE keeps a
//   flash-style running max and is sound for any input. The wrapper
//   (ops/kernels.py) clamps -inf weights to -1e30, computes max_lw on the
//   device and passes log_w - max_lw, so the -1e30 clamp, the max_lw rule
//   and the final + max_lw are exactly the TPU wrapper's.
// - The logit is -0.5 * sum_p (a - b)^2 + lw on CUDA cores in exact FP32
//   FMA. The TPU kernel folded the affine terms into an augmented (p+2)-wide
//   MXU dot only to keep its vector unit idle; a contraction of 8 or 18
//   terms is far too narrow for tensor cores to matter, and the direct
//   difference form does not cancel. All three `precision` values of the
//   JAX wrapper map to this FP32 path (3xTF32 / wgmma is later work).
// - Layout: one query row per thread, held in registers; tiles of centers
//   (b, lw) stream through shared memory and are read as warp broadcasts.
//   At keep = 2,048 there are too few query blocks to fill 132 SMs, so the
//   center axis is split across blockIdx.y: each block writes a partial
//   (max, sum) pair per row and a second small kernel combines them. No
//   result carries between blocks.
// - Accuracy: expf/logf (the full-precision CUDA math library functions,
//   max error 2 ulp), never the unchecked __expf intrinsic; no fast-math.
//
// Bound: exp throughput plus FP32 FMA, not memory. At 50,000 x 50,000 x 6
// there are 2.5e9 logits, each p FMAs + one expf, against 2 x 50,000 x 6
// floats of input.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // query rows per block (one per thread)
constexpr int kTile = 128;     // centers per shared-memory tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF sentinel

template <int P, bool ONLINE>
__global__ void __launch_bounds__(kThreads)
mixture_partial_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ lw_shift,
                       int n, int m, int p, int centers_per_split,
                       float* __restrict__ part_max,
                       float* __restrict__ part_sum) {
  __shared__ float sb[kTile][P];
  __shared__ float slw[kTile];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int split = blockIdx.y;
  const int j_begin = split * centers_per_split;
  const int j_end = min(m, j_begin + centers_per_split);

  float q[P];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    q[c] = (row < n && c < p) ? a[(size_t)row * p + c] : 0.f;
  }

  float run_max = kNegInf;
  float run_sum = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    const int cnt = min(kTile, j_end - j0);
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = threadIdx.x; idx < kTile * P; idx += kThreads) {
      const int r = idx / P;
      const int c = idx - r * P;
      sb[r][c] = (r < cnt && c < p) ? b[(size_t)(j0 + r) * p + c] : 0.f;
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      slw[r] = (r < cnt) ? lw_shift[j0 + r] : kNegInf;
    }
    __syncthreads();

    for (int r = 0; r < cnt; ++r) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float t = q[c] - sb[r][c];
        d = fmaf(t, t, d);
      }
      const float logit = fmaf(-0.5f, d, slw[r]);
      if (ONLINE) {
        if (logit > run_max) {
          run_sum = fmaf(run_sum, expf(run_max - logit), 1.f);
          run_max = logit;
        } else {
          run_sum += expf(logit - run_max);
        }
      } else {
        run_sum += expf(logit);
      }
    }
  }

  if (row < n) {
    const size_t o = (size_t)split * n + row;
    part_sum[o] = run_sum;
    if (ONLINE) part_max[o] = run_max;
  }
}

template <bool ONLINE>
__global__ void mixture_combine_kernel(const float* __restrict__ part_max,
                                       const float* __restrict__ part_sum,
                                       const float* __restrict__ max_lw,
                                       int n, int n_split,
                                       float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  if (ONLINE) {
    float mx = kNegInf;
    for (int k = 0; k < n_split; ++k) mx = fmaxf(mx, part_max[(size_t)k * n + row]);
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) {
      const size_t o = (size_t)k * n + row;
      s += part_sum[o] * expf(part_max[o] - mx);
    }
    out[row] = mx + logf(s) + max_lw[0];
  } else {
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += part_sum[(size_t)k * n + row];
    out[row] = logf(s) + max_lw[0];
  }
}

template <int P>
cudaError_t launch(const float* a, const float* b, const float* lw_shift,
                   const float* max_lw, float* part_max, float* part_sum,
                   float* out, int n, int m, int p, int n_split,
                   int centers_per_split, bool online, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, n_split);
  if (online) {
    mixture_partial_kernel<P, true><<<grid, kThreads, 0, stream>>>(
        a, b, lw_shift, n, m, p, centers_per_split, part_max, part_sum);
  } else {
    mixture_partial_kernel<P, false><<<grid, kThreads, 0, stream>>>(
        a, b, lw_shift, n, m, p, centers_per_split, part_max, part_sum);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cb = 256;
  if (online) {
    mixture_combine_kernel<true><<<(n + cb - 1) / cb, cb, 0, stream>>>(
        part_max, part_sum, max_lw, n, n_split, out);
  } else {
    mixture_combine_kernel<false><<<(n + cb - 1) / cb, cb, 0, stream>>>(
        part_max, part_sum, max_lw, n, n_split, out);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launches
// (0 = success); the kernels run asynchronously on `stream`.
extern "C" int mixture_logsumexp_f32(const float* a, const float* b,
                                     const float* lw_shift,
                                     const float* max_lw, float* part_max,
                                     float* part_sum, float* out, int n,
                                     int m, int p, int n_split,
                                     int centers_per_split, int online,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool on = online != 0;
  if (p <= 8)
    return launch<8>(a, b, lw_shift, max_lw, part_max, part_sum, out, n, m, p,
                     n_split, centers_per_split, on, s);
  if (p <= 16)
    return launch<16>(a, b, lw_shift, max_lw, part_max, part_sum, out, n, m, p,
                      n_split, centers_per_split, on, s);
  if (p <= 32)
    return launch<32>(a, b, lw_shift, max_lw, part_max, part_sum, out, n, m, p,
                      n_split, centers_per_split, on, s);
  if (p <= 64)
    return launch<64>(a, b, lw_shift, max_lw, part_max, part_sum, out, n, m, p,
                      n_split, centers_per_split, on, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Largest p the templates cover (the wrapper raises above it).
extern "C" int mixture_logsumexp_max_p(void) { return 64; }
