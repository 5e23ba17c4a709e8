// The builtin `ricker` simulator's whole time loop in one kernel (sm_90a).
//
// models/simulators.py::make_ricker_simulator steps Wood's Ricker map with
// Poisson observations over N particles. Written as PyTorch ops, a step is
// some 120 launches over [N] and [N, 24] tensors (the counter hash of six
// 32-bit words held in int64, a float64 Box-Muller for two normals, the
// map, and the inverse CDF of the Poisson draw on a 24-point grid with its
// running sum by torch.cumsum), ~17,700 launches for the published 50
// burn-in and 100 observed steps, each reading and writing its operands in
// device memory. It replaces no TPU kernel: the JAX package runs the same
// loop as a `lax.scan` that XLA fuses; this is the fused form for the card.
//
// One thread a row runs all steps with the population, the grid and the
// two counts in registers, in float32 or float64 (the chain's dtype), and
// writes the observed series [n, t_steps] and the counts [2, n]; the row
// statistics stay PyTorch ops after it. What bounds it: issue. Each step
// draws a normal, a float64 log, sqrt and cos (libdevice), and an observed
// step either a second normal (a mean above 10) or the grid's 24 exp and
// its running sum (a mean of at most 10); the series, 4 bytes a row-step in
// float32, is far below the card's bandwidth. A draw the chain computes and
// then discards (the burn-in's Poisson draw, the branch torch.where does not
// keep) is not computed.
//
// The contract is the chain's bits (tests/test_torch_gpu.py holds them
// equal on every metric and both counts, in both dtypes). So every
// operation rounds where a PyTorch CUDA op rounds, in the same order, by
// the rules of counter_hash.cuh (the draws and the arithmetic it shares
// with csrc/sir_loop.cu), and besides:
// - the uniform is the float64 word over 2^32 rounded to the dtype, then
//   held below 1 (clamp_max(1 - eps / 2));
// - the grid's log-factorials are the wrapper's, torch.lgamma on the card;
// - the grid's running sum adds in torch.cumsum's order for a row of 24 on
//   the card: tensor_kernel_scan_innermost_dim (ATen's ScanUtils.cuh) keeps
//   at least 16 x-threads, so a row is one chunk of 32 or more, its first
//   entry plus 0 (exact), then a Sklansky scan: level m = 0, 1, ... adds
//   x[((i >> m) << m) - 1] to every x[i] with bit m set. An entry below 24
//   reads only entries below it, so the zero pads never enter, and the
//   levels past 4 leave it as it is. (A batch of one row is a scan of 24
//   values alone, which torch.cumsum hands to CUB: there the kernel gives
//   the row's bits in any larger batch.)
// - the draw is the first grid point whose running sum reaches u (24 where
//   none does), 23 where u lies past the last sum; the grid is taken where
//   the chain's torch.where keeps it, !(mean > 10), so a NaN mean takes it.

#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 24;                        // the Poisson grid's points

// The Poisson draw of mean lam from the 24-point grid with uniform u;
// `past` is whether u lies past the grid's last running sum
template <typename T>
DEV T grid_draw(T lam, T u, const T* log_fact, bool& past) {
  const T lam_s = clamp_max(lam, T(20));
  const T log_lam = logarithm(clamp_min(lam_s, T(1e-9)));
  T c[kGrid];
#pragma unroll
  for (int k = 0; k < kGrid; ++k)
    c[k] = expo(sub(sub(mul(T(k), log_lam), lam_s), log_fact[k]));
  // torch.cumsum's Sklansky levels (this file's header)
#pragma unroll
  for (int m = 0; (1 << m) < kGrid; ++m) {
#pragma unroll
    for (int i = 0; i < kGrid; ++i)
      if (i >> m & 1) c[i] = add(c[i], c[((i >> m) << m) - 1]);
  }
  int first = kGrid;
#pragma unroll
  for (int k = kGrid - 1; k >= 0; --k)
    if (c[k] >= u) first = k;
  past = u > c[kGrid - 1];
  return past ? T(kGrid - 1) : static_cast<T>(first);
}

// params [n, 3] (log r, sigma, phi), seeds [n] and the grid's
// log-factorials [24] in; out the observed series ys [n, t_steps] and the
// counts [2, n] (observed steps drawn from the normal, grid draws past the
// grid), all but the counts in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ricker_loop_kernel(const T* __restrict__ params,
                       const long long* __restrict__ seeds,
                       const T* __restrict__ log_fact_in,
                       T* __restrict__ ys, int* __restrict__ counts, int n,
                       int t_steps, int burn_in, T n0) {
  __shared__ T log_fact[kGrid];
  if (threadIdx.x < kGrid) log_fact[threadIdx.x] = log_fact_in[threadIdx.x];
  __syncthreads();
  const int r_idx = blockIdx.x * kThreads + threadIdx.x;
  if (r_idx >= n) return;
  const size_t r3 = 3 * static_cast<size_t>(r_idx);
  const T r = expo(clamp(params[r3], T(0), T(6)));
  const T sigma = clamp(magnitude(params[r3 + 1]), T(1e-3), T(2));
  const T phi = clamp(magnitude(params[r3 + 2]), T(1e-2), T(50));
  const uint32_t seed = static_cast<uint32_t>(seeds[r_idx]);
  const uint32_t base = fmix32(seed ^ kSeedSalt);
  const uint32_t ubase = fmix32(seed ^ kUniformSalt);

  T* row = ys + static_cast<size_t>(r_idx) * t_steps;
  T pop = n0;
  int on_normal = 0, clamped = 0;
  const int steps = burn_in + t_steps;
  for (int t = 0; t < steps; ++t) {
    // step t reads normals 2t and 2t + 1 (hash words 4t .. 4t + 3) and
    // uniform t
    const uint32_t w = 4u * static_cast<uint32_t>(t);
    const T z = normal<T>(base, w);
    pop = clamp(mul(mul(r, pop), expo(add(-pop, mul(sigma, z)))), T(1e-9),
                T(1e6));
    if (t < burn_in) continue;
    const T lam = mul(phi, pop);
    T y;
    if (lam > T(10)) {
      const T g = normal<T>(base, w + 2u);
      y = clamp_min(nearest(add(lam, mul(root(lam), g))), T(0));
      ++on_normal;
    } else {
      bool past;
      y = grid_draw(lam, uniform<T>(ubase, static_cast<uint32_t>(t)),
                    log_fact, past);
      clamped += past;
    }
    row[t - burn_in] = y;
  }
  counts[r_idx] = on_normal;
  counts[static_cast<size_t>(n) + r_idx] = clamped;
}

template <typename T>
int launch(const T* params, const long long* seeds, const T* log_fact,
           T* ys, int* counts, int n, int t_steps, int burn_in, T n0,
           void* stream) {
  // 4 t + 3, the last step's last hash word, has to fit 32 bits
  if (n < 1 || t_steps < 0 || burn_in < 0 ||
      t_steps + static_cast<long long>(burn_in) >= (1 << 30))
    return cudaErrorInvalidValue;
  const int blocks = (n - 1) / kThreads + 1;
  ricker_loop_kernel<T><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      params, seeds, log_fact, ys, counts, n, t_steps, burn_in, n0);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`, no synchronisation: 0 on success, else the
// launch's cudaError (cudaErrorInvalidValue for sizes it does not take).
// n0 is the starting population rounded to the dtype.
extern "C" int ricker_loop_f32(const float* params, const long long* seeds,
                               const float* log_fact, float* ys,
                               int* counts, int n, int t_steps, int burn_in,
                               float n0, void* stream) {
  return launch(params, seeds, log_fact, ys, counts, n, t_steps, burn_in, n0,
                stream);
}

extern "C" int ricker_loop_f64(const double* params, const long long* seeds,
                               const double* log_fact, double* ys,
                               int* counts, int n, int t_steps, int burn_in,
                               double n0, void* stream) {
  return launch(params, seeds, log_fact, ys, counts, n, t_steps, burn_in, n0,
                stream);
}
