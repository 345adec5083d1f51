// The diagonal cell's minimum image without a division, shared by the
// pair kernels (pair.cu) and the RDF kernels (rdf.cu).
//
// The plain versions and the JAX package take d - rint(fl(d / L)) L with
// an IEEE division.  fl(d / L) is monotone in d, so for |d| < t2 the shift
// is 1 from d >= t1 on, -1 from d <= -t1 on (fl(-d / L) = -fl(d / L)) and
// 0 between, where t1 is the least float with fl(t1 / L) > 0.5 (rint takes
// 0.5 to 0) and t2 the least with fl(t2 / L) >= 1.5 (ops/pair.py
// image_thresholds finds both once per cell).  d - L and d + L round
// once, as d - 1 * L does, so the bits equal the IEEE formula's.

#pragma once

#include <cuda_runtime.h>

// |d| < t2 only
__device__ __forceinline__ float image_exact(float d, float L, float t1) {
  return fabsf(d) >= t1 ? d - copysignf(L, d) : d;
}

// The IEEE formula with no contraction, as the plain version rounds it:
// taken only for |d| >= t2 (positions more than a box apart).
__device__ __forceinline__ float image_ieee(float d, float L) {
  return __fsub_rn(d, __fmul_rn(rintf(__fdiv_rn(d, L)), L));
}

struct Image {
  float lx, ly, lz;   // the cell
  float tx, ty, tz;   // t1 per axis
  float ux, uy, uz;   // t2 per axis
};

// Any d: the compares, or the IEEE formula past t2 (a NaN takes it too).
__device__ __forceinline__ float image_any(float d, float L, float t1,
                                           float t2) {
  return fabsf(d) < t2 ? image_exact(d, L, t1) : image_ieee(d, L);
}

// ((dx dx + dy dy) + dz dz) with no contraction, as the plain versions
// round it: a pair with r^2 exactly cutoff^2 stays out.
__device__ __forceinline__ float sum_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// x_a - x_b under the minimum image, per axis, and its sum_sq.  kFar:
// some |d| may reach t2 (positions not wrapped), so each axis checks for
// the IEEE formula; without it the compares alone, a select per axis.
template <bool kFar>
__device__ __forceinline__ float image_r2(const Image& im, float ax, float ay,
                                          float az, float bx, float by,
                                          float bz, float& dx, float& dy,
                                          float& dz) {
  if (kFar) {
    dx = image_any(ax - bx, im.lx, im.tx, im.ux);
    dy = image_any(ay - by, im.ly, im.ty, im.uy);
    dz = image_any(az - bz, im.lz, im.tz, im.uz);
  } else {
    dx = image_exact(ax - bx, im.lx, im.tx);
    dy = image_exact(ay - by, im.ly, im.ty);
    dz = image_exact(az - bz, im.lz, im.tz);
  }
  return sum_sq(dx, dy, dz);
}
