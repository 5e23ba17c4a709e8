// The simulator loop kernels' shared draws and rounding rules (sm_90a).
//
// csrc/sir_loop.cu and csrc/ricker_loop.cu each run a PyTorch chain of
// models/simulators.py in one thread a row and give its bits. What both
// need is here, once: the counter hash of a row's seed (the normals and
// the uniforms of simulators.CounterNoise) and the arithmetic that rounds
// where a PyTorch CUDA op rounds:
// - each product, sum, difference and quotient is an _rn intrinsic, so
//   nvcc's default -fmad contracts none of them into an FMA (PyTorch runs
//   each op as its own kernel, rounding in between);
// - exp, log, cos and sqrt are the accurate math-library functions that
//   PyTorch's kernels call, never the intrinsics;
// - torch.round is nearbyint (half to even); clamp, clamp_min, clamp_max
//   and minimum keep PyTorch's NaN rule (a NaN operand is returned), and
//   their bounds are the caller's, rounded to the dtype.
// ops/_build.py digests this file with each source that includes it, so
// an edit here rebuilds both libraries.

#pragma once

#include <math.h>
#include <stdint.h>

#define DEV __device__ __forceinline__

namespace {

constexpr uint32_t kSeedSalt = 0x9E3779B9u;      // simulators._SEED_SALT
constexpr uint32_t kUniformSalt = 0x85EBCA6Bu;   // simulators._UNIFORM_SALT
constexpr double kTwoPi = 6.283185307179586;     // Python's 2.0 * math.pi
constexpr double kInv2p32 = 2.3283064365386963e-10;  // 1 / 2^32, exact

// one rounding each, in the dtype
DEV float add(float a, float b) { return __fadd_rn(a, b); }
DEV double add(double a, double b) { return __dadd_rn(a, b); }
DEV float sub(float a, float b) { return __fsub_rn(a, b); }
DEV double sub(double a, double b) { return __dsub_rn(a, b); }
DEV float mul(float a, float b) { return __fmul_rn(a, b); }
DEV double mul(double a, double b) { return __dmul_rn(a, b); }
DEV float quot(float a, float b) { return __fdiv_rn(a, b); }
DEV double quot(double a, double b) { return __ddiv_rn(a, b); }
DEV float root(float a) { return __fsqrt_rn(a); }
DEV double root(double a) { return __dsqrt_rn(a); }
DEV float expo(float a) { return expf(a); }
DEV double expo(double a) { return exp(a); }
DEV float logarithm(float a) { return logf(a); }
DEV double logarithm(double a) { return log(a); }
DEV float nearest(float a) { return nearbyintf(a); }
DEV double nearest(double a) { return nearbyint(a); }
DEV float least(float a, float b) { return fminf(a, b); }
DEV double least(double a, double b) { return fmin(a, b); }
DEV float most(float a, float b) { return fmaxf(a, b); }
DEV double most(double a, double b) { return fmax(a, b); }
DEV float magnitude(float a) { return fabsf(a); }
DEV double magnitude(double a) { return fabs(a); }
DEV float narrow(double a, float) { return __double2float_rn(a); }
DEV double narrow(double a, double) { return a; }

// torch.clamp, torch.clamp_min, torch.clamp_max and torch.minimum
template <typename T>
DEV T clamp(T v, T lo, T hi) {
  return v != v ? v : least(most(v, lo), hi);
}

template <typename T>
DEV T clamp_min(T v, T lo) {
  return v != v ? v : most(v, lo);
}

template <typename T>
DEV T clamp_max(T v, T hi) {
  return v != v ? v : least(v, hi);
}

template <typename T>
DEV T minimum(T a, T b) {
  return a != a ? a : b != b ? b : least(a, b);
}

// murmur3's 32-bit finalizer (ops/pls.py::_fmix32 on uint32 words)
DEV uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The standard normal of counter-hash words w and w + 1 of a row's seed
// word (simulators._box_muller): float64, then rounded to the dtype
template <typename T>
DEV T normal(uint32_t base, uint32_t w) {
  const double u1 = __dmul_rn(
      __dadd_rn(static_cast<double>(fmix32(base ^ w)), 1.0), kInv2p32);
  const double u2 =
      __dmul_rn(static_cast<double>(fmix32(base ^ (w + 1u))), kInv2p32);
  const double radius = __dsqrt_rn(__dmul_rn(-2.0, log(u1)));
  return narrow(__dmul_rn(radius, cos(__dmul_rn(kTwoPi, u2))), T());
}

// the largest value below 1, 1 - eps / 2 (CounterNoise.uniforms)
template <typename T> DEV T below_one();
template <> DEV float below_one<float>() { return 1.0f - 0x1p-24f; }
template <> DEV double below_one<double>() { return 1.0 - 0x1p-53; }

// The unit uniform of counter-hash word w of a row's uniform word
// (simulators.CounterNoise.uniforms): float64, rounded, held below 1
template <typename T>
DEV T uniform(uint32_t ubase, uint32_t w) {
  const T u = narrow(
      __dmul_rn(static_cast<double>(fmix32(ubase ^ w)), kInv2p32), T());
  return least(u, below_one<T>());
}

}  // namespace
