// NaN-propagating min/max for the slab tests of the traversal kernels
// (bvh8_walk.cu, bvh2_walk.cu).  Both forms return NaN when either operand
// is NaN, as torch.minimum/maximum do (fminf/fmaxf would drop a single NaN
// operand), so an empty child slot's NaN box fails every accept test.
//   min_ptx / max_ptx: one instruction each (PTX min.NaN.f32 /
//     max.NaN.f32, sm_80+).
//   min_nan / max_nan: compare, compare, or, fminf, select; the kernels'
//     first form, kept for the old walks of tools/ that time against it.
// The two may differ only in the sign of a zero result, and the kernels
// feed these values to comparisons only, where -0 and +0 are equal.

#pragma once

namespace {

__device__ __forceinline__ float min_ptx(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_ptx(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

}  // namespace
