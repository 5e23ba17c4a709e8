// The builtin `sir` simulator's whole time loop in one kernel (sm_90a).
//
// models/simulators.py::make_sir_simulator steps a chain-binomial SIR
// epidemic day by day over N particles. Written as PyTorch ops, a day is
// some 40 elementwise launches over [N] and [N, 2] tensors (the counter
// hash of four 32-bit words held in int64, a float64 Box-Muller for two
// normals, the binomials and state updates), ~6,400 launches for the
// published 160 days, each reading and writing its operands in device
// memory. It replaces no TPU kernel: the JAX package runs the same loop
// as a `lax.scan` that XLA fuses; this is the fused form for the card.
//
// One thread a row runs all days with the state (S, I, R, the peak and its
// day, the days infected, the incidence total and its day sum) in
// registers, in float32 or float64 (the chain's dtype). What bounds it:
// issue. Each day draws two normals, each a float64 log, sqrt and cos
// (libdevice); the hash and the day's arithmetic are INT32 and FP32 (or
// FP64) work, and the bytes (params, seeds and metrics once) are far below
// the card's bandwidth.
//
// The half-time (the days whose running incidence is still below half the
// final total) needs the total first. No [t_steps, N] series is kept: the
// days are cut into at most kChunks chunks, and at each chunk's start the
// thread keeps (S, I) and the running incidence, and over the chunk the
// least and largest running value. At the end a chunk wholly below the
// half counts all its days, a chunk wholly at or above it none, and a
// chunk that straddles it (one, where the running incidence ascends) is
// run again from its start, the normals being a pure function of (seed,
// day), to count its days one by one. Any number of days fits, and a row
// runs some t_steps / kChunks days twice.
//
// The contract is the chain's bits (tests/test_torch_gpu.py holds them
// equal on all six metrics, in both dtypes). So every operation rounds
// where a PyTorch CUDA op rounds, in the same order, by the rules of
// counter_hash.cuh (the draws and the arithmetic it shares with
// csrc/ricker_loop.cu), and besides:
// - a tensor divided by a Python scalar is PyTorch's CUDA multiply by
//   the scalar's reciprocal, taken in float64 and rounded to the dtype:
//   `-beta * i / population` is ((-beta) * i) * inv_pop with inv_pop
//   from the wrapper, and `total / 2` is total * 0.5;
// - the peak takes a strict `>` from -inf: the first maximum wins;
// - every running sum adds day by day from 0, as the chain's sums and
//   its cumsum over days (a sequential scan for the outer dimension) do.

#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
// the most chunks the days are cut into (the checkpoints a thread keeps)
constexpr int kChunks = 32;

// simulators._binomial_normal: round(n p + sqrt(n p (1 - p)) z), half to
// even, clipped to [0, n]
template <typename T>
DEV T binomial(T n, T p, T z) {
  const T mean = mul(n, p);
  const T sd = root(clamp_min(mul(mean, sub(T(1), p)), T(0)));
  const T x = nearest(add(mean, mul(sd, z)));
  return minimum(clamp_min(x, T(0)), n);
}

// A row's draws and rates
template <typename T>
struct Row {
  uint32_t base;  // the seed's hash word
  T neg_beta;     // -|beta|
  T p_rec;        // 1 - exp(-clamp(|gamma|, 1e-6, 1))
  T inv_pop;
};

// Day t of a row: moves (s, i) on and returns (new infections, new
// recoveries). Day t reads normals 2t (infections) and 2t + 1
// (recoveries), i.e. hash words 4t .. 4t + 3.
template <typename T>
DEV void day(const Row<T>& row, int t, T& s, T& i, T& new_inf,
             T& new_rec) {
  const uint32_t w = 4u * static_cast<uint32_t>(t);
  const T z_inf = normal<T>(row.base, w);
  const T z_rec = normal<T>(row.base, w + 2u);
  const T p_inf =
      sub(T(1), expo(mul(mul(row.neg_beta, i), row.inv_pop)));
  new_inf = binomial(s, p_inf, z_inf);
  new_rec = binomial(i, row.p_rec, z_rec);
  s = sub(s, new_inf);
  i = sub(add(i, new_inf), new_rec);
}

// params [n, 2] (beta, gamma) and seeds [n] in; out [n, 6] (final size,
// peak prevalence, peak day, days infected, mean infection day,
// half-time), all in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sir_loop_kernel(const T* __restrict__ params,
                    const long long* __restrict__ seeds,
                    T* __restrict__ out, int n, int t_steps, T s0, T i0,
                    T inv_pop) {
  const int r_idx = blockIdx.x * kThreads + threadIdx.x;
  if (r_idx >= n) return;
  const size_t r2 = 2 * static_cast<size_t>(r_idx);
  Row<T> row;
  row.neg_beta = -magnitude(params[r2]);
  const T gamma = clamp(magnitude(params[r2 + 1]), T(1e-6), T(1));
  row.p_rec = sub(T(1), expo(-gamma));
  row.inv_pop = inv_pop;
  row.base = fmix32(static_cast<uint32_t>(seeds[r_idx]) ^ kSeedSalt);

  T s = s0, i = i0, r = T(0), peak = -INFINITY, peak_day = T(0);
  T days = T(0), total = T(0), day_sum = T(0);
  // at each chunk's start: S, I and the running incidence; over the
  // chunk: the least and largest running incidence, and whether any was
  // NaN (bit c of nan_chunks)
  T at_s[kChunks], at_i[kChunks], at_total[kChunks];
  T lo[kChunks], hi[kChunks];
  uint32_t nan_chunks = 0;
  const int len = (t_steps + kChunks - 1) / kChunks;
  for (int c = 0, t0 = 0; t0 < t_steps; ++c, t0 += len) {
    at_s[c] = s;
    at_i[c] = i;
    at_total[c] = total;
    T low = INFINITY, high = -INFINITY;
    bool nan = false;
    const int t1 = min(t0 + len, t_steps);
    for (int t = t0; t < t1; ++t) {
      T new_inf, new_rec;
      day(row, t, s, i, new_inf, new_rec);
      r = add(r, new_rec);
      const T when = static_cast<T>(t);
      if (i > peak) {
        peak = i;
        peak_day = when;
      }
      days = add(days, i > T(0) ? T(1) : T(0));
      total = add(total, new_inf);
      day_sum = add(day_sum, mul(when, new_inf));
      nan |= total != total;
      low = least(low, total);
      high = most(high, total);
    }
    lo[c] = low;
    hi[c] = high;
    nan_chunks |= static_cast<uint32_t>(nan) << c;
  }

  // simulators._first_reaching_half: the days whose running incidence is
  // still below half the total. First the chunks that need no day run
  // again; then those that straddle the half, one at a time, so the
  // threads of a warp run their (usually one) straddling chunk together,
  // whichever chunk it is
  const T half = mul(total, T(0.5));
  int below = 0;
  uint32_t straddle = 0;
  for (int c = 0, t0 = 0; t0 < t_steps; ++c, t0 += len) {
    if (nan_chunks >> c & 1u || (hi[c] >= half && lo[c] < half))
      straddle |= 1u << c;
    else if (hi[c] < half)
      below += min(t0 + len, t_steps) - t0;
  }
  while (straddle) {
    const int c = __ffs(straddle) - 1;
    straddle &= straddle - 1;
    const int t0 = c * len, t1 = min(t0 + len, t_steps);
    T s_c = at_s[c], i_c = at_i[c], running = at_total[c];
    for (int t = t0; t < t1; ++t) {
      T new_inf, new_rec;
      day(row, t, s_c, i_c, new_inf, new_rec);
      running = add(running, new_inf);
      below += running < half;
    }
  }
  T* o = out + 6 * static_cast<size_t>(r_idx);
  o[0] = add(r, i);
  o[1] = peak;
  o[2] = peak_day;
  o[3] = days;
  o[4] = quot(day_sum, clamp_min(total, T(1)));
  o[5] = static_cast<T>(below);
}

template <typename T>
int launch(const T* params, const long long* seeds, T* out, int n,
           int t_steps, T s0, T i0, T inv_pop, void* stream) {
  // 4 t + 3, the day's last hash word, has to fit 32 bits
  if (n < 1 || t_steps < 0 || t_steps >= (1 << 30))
    return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  sir_loop_kernel<T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      params, seeds, out, n, t_steps, s0, i0, inv_pop);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`, no synchronisation: 0 on success, else the
// launch's cudaError (cudaErrorInvalidValue for sizes it does not take).
// s0 = population - i0, i0 and inv_pop = 1 / population (in float64)
// rounded to the dtype.
extern "C" int sir_loop_f32(const float* params, const long long* seeds,
                            float* out, int n, int t_steps, float s0,
                            float i0, float inv_pop, void* stream) {
  return launch(params, seeds, out, n, t_steps, s0, i0, inv_pop, stream);
}

extern "C" int sir_loop_f64(const double* params, const long long* seeds,
                            double* out, int n, int t_steps, double s0,
                            double i0, double inv_pop, void* stream) {
  return launch(params, seeds, out, n, t_steps, s0, i0, inv_pop, stream);
}
