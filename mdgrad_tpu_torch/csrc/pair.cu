// Minimum-image Lennard-Jones-family pair energy, forces, the force's
// vector-Jacobian product and its parameter sums on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mdgrad_tpu/ops/pallas_pair.py, one
// mode of mdg_lj_pair each:
//   0 kEnergyForces <- lj_energy_forces     (_pair_kernel)        "K5"
//   1 kForce        <- make_lj_force.force  (_force_only_kernel)  "K6"
//   2 kForceVjp     <- make_lj_force force_bwd (_force_hvp_kernel) "K6b"
//   3 kForceParam   <- _force_param_kernel                       "K7"
// For u(r) = 4 eps ((s/r)^R - (s/r)^A) with integer powers R = rep, A =
// attr, g = u'/r and h = (u'' - u'/r) / r^2, over the valid ordered pairs
// (j != i, r_ij^2 < cutoff^2, both atoms real), d_ij = x_i - x_j under
// the diagonal-cell minimum image d - rint(d / L) L:
//   K5:  E = 1/2 sum u(r_ij),  F_i = -sum_j g d_ij
//   K6:  F_i only
//   K6b: given the cotangent W (N, 3) of F,
//        vjp_i = sum_j [h (W_ij . d_ij) d_ij + g W_ij],  W_ij = W_j - W_i,
//        d(W.F)/dsigma = -sum dg/dsigma (W_i . d_ij),
//        d(W.F)/deps   = -sum (g / eps) (W_i . d_ij)
//   K7:  F_i, dU/dsigma and U / eps (pairs counted half)
// sigma and eps are read from device memory (they are trainable
// parameters on the card: no host sync per force); the cell lengths, the
// cutoff and the powers are launch arguments.
//
// What bounds them on an H100: operations.  Every i < j pair needs its
// minimum image and r^2 (~15 operations, three IEEE divisions among them);
// only the pairs inside the cutoff (~55 neighbours per atom at the LJ
// liquid's density, about 1.4% of the pairs at N = 4000) need the LJ
// terms.  Bytes are 12 per atom in and out (24 with W).  The kernels walk
// ordered pairs, twice the i < j bound, so each row's sums stay in one
// thread's registers and no two blocks write one row.
// Design, shared by all four (one template):
//   * grid (column tile, row tile) of 128 x 128 tiles: ~1000 blocks at
//     N = 4000 for the 132 SMs (one thread per row alone would give 32);
//   * a block stages its column tile's positions (and W) in shared
//     memory; thread a owns row i0 + a and walks the tile's columns, every
//     thread reading the same shared word at once (a broadcast), keeping
//     the row's sums in registers and skipping the LJ terms of pairs
//     outside the cutoff;
//   * each block writes its rows' vector partials to a (column tiles, N,
//     3) scratch and its scalar partials (energy; dsigma, deps; dU/dsigma,
//     U/eps), summed over its rows by a fixed shared-memory tree, to a
//     (scalars, blocks) scratch;
//   * one second launch sums the vector partials over the column tiles in
//     tile order and the scalar partials over the blocks by a fixed tree.
// Every sum is taken in a fixed order, with no atomics, so the forces are
// the same bits on every call: the replay adjoint re-runs each step and
// needs the forward's forces exactly.  Ragged edges are masked by bounds;
// nothing is padded.  Integer powers go by repeated squaring, as JAX's
// integer_pow does.

#include <cuda_runtime.h>

namespace {

constexpr int kPairTile = 128;
constexpr int kReduceThreads = 256;

enum Mode { kEnergyForces = 0, kForce = 1, kForceVjp = 2, kForceParam = 3 };

template <int kMode>
struct ModeScalars {
  static constexpr int value = kMode == kForce ? 0
                               : kMode == kEnergyForces ? 1 : 2;
};

__device__ __forceinline__ float min_image(float d, float L) {
  return d - rintf(d / L) * L;
}

// x^p for p >= 0 by repeated squaring (lax.integer_pow's order)
__device__ __forceinline__ float ipow(float x, int p) {
  float acc = 1.f;
  while (p > 0) {
    if (p & 1) acc *= x;
    p >>= 1;
    if (p > 0) x *= x;
  }
  return acc;
}

// partial: (column tiles, n, 3); block_partial: (scalars, blocks).
template <int kMode>
__global__ void __launch_bounds__(kPairTile) lj_pair_partial_kernel(
    const float* __restrict__ xyz, const float* __restrict__ w, int n,
    float lx, float ly, float lz, float cut_sq,
    const float* __restrict__ sigma_p, const float* __restrict__ eps_p,
    int rep, int attr, float* __restrict__ partial,
    float* __restrict__ block_partial) {
  constexpr int kScalars = ModeScalars<kMode>::value;
  constexpr bool kUsesW = kMode == kForceVjp;
  __shared__ float cx[kPairTile], cy[kPairTile], cz[kPairTile];
  __shared__ float cwx[kUsesW ? kPairTile : 1], cwy[kUsesW ? kPairTile : 1],
      cwz[kUsesW ? kPairTile : 1];
  __shared__ float red[kScalars > 0 ? kScalars : 1][kPairTile];

  const int a = threadIdx.x;
  const int i = blockIdx.y * kPairTile + a;
  const int j0 = blockIdx.x * kPairTile;
  if (j0 + a < n) {
    const long long j3 = static_cast<long long>(j0 + a) * 3;
    cx[a] = xyz[j3];
    cy[a] = xyz[j3 + 1];
    cz[a] = xyz[j3 + 2];
    if constexpr (kUsesW) {
      cwx[a] = w[j3];
      cwy[a] = w[j3 + 1];
      cwz[a] = w[j3 + 2];
    }
  }
  __syncthreads();

  const float sigma = __ldg(sigma_p);
  const float eps = __ldg(eps_p);
  const float R = static_cast<float>(rep);
  const float A = static_cast<float>(attr);
  float v0 = 0.f, v1 = 0.f, v2 = 0.f;   // the row's vector sum
  float s0 = 0.f, s1 = 0.f;             // the row's scalar sums
  if (i < n) {
    const long long i3 = static_cast<long long>(i) * 3;
    const float xi = xyz[i3], yi = xyz[i3 + 1], zi = xyz[i3 + 2];
    float wix = 0.f, wiy = 0.f, wiz = 0.f;
    if constexpr (kUsesW) {
      wix = w[i3];
      wiy = w[i3 + 1];
      wiz = w[i3 + 2];
    }
    const int cols = min(kPairTile, n - j0);
    for (int b = 0; b < cols; ++b) {
      const float dx = min_image(xi - cx[b], lx);
      const float dy = min_image(yi - cy[b], ly);
      const float dz = min_image(zi - cz[b], lz);
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 < cut_sq) || j0 + b == i) continue;
      const float inv_r2 = 1.f / r2;
      const float sr = sigma * sqrtf(inv_r2);
      const float sr_a = ipow(sr, attr);
      const float sr_r = ipow(sr, rep);
      // g / eps = 4 (-R sr^R + A sr^A) / r^2
      const float g0 = 4.f * (-R * sr_r + A * sr_a) * inv_r2;
      const float g = eps * g0;
      if constexpr (kMode == kForceVjp) {
        const float h = 4.f * eps * (R * (R + 2.f) * sr_r -
                                     A * (A + 2.f) * sr_a) * inv_r2 * inv_r2;
        const float wx = cwx[b] - wix;
        const float wy = cwy[b] - wiy;
        const float wz = cwz[b] - wiz;
        const float hwd = h * (wx * dx + wy * dy + wz * dz);
        v0 += hwd * dx + g * wx;
        v1 += hwd * dy + g * wy;
        v2 += hwd * dz + g * wz;
        const float dgds = 4.f * eps * (-R * R * sr_r + A * A * sr_a) *
                           inv_r2 / sigma;
        const float wrd = wix * dx + wiy * dy + wiz * dz;
        s0 -= dgds * wrd;
        s1 -= g0 * wrd;
      } else {
        v0 -= g * dx;
        v1 -= g * dy;
        v2 -= g * dz;
        if constexpr (kMode == kEnergyForces) {
          s0 += 0.5f * (4.f * eps * (sr_r - sr_a));
        } else if constexpr (kMode == kForceParam) {
          s0 += 0.5f * (4.f * eps * (R * sr_r - A * sr_a) / sigma);
          s1 += 0.5f * (4.f * (sr_r - sr_a));
        }
      }
    }
    float* dst = partial + (static_cast<long long>(blockIdx.x) * n + i) * 3;
    dst[0] = v0;
    dst[1] = v1;
    dst[2] = v2;
  }

  if constexpr (kScalars > 0) {
    red[0][a] = s0;
    if constexpr (kScalars > 1) red[1][a] = s1;
    __syncthreads();
    for (int h = kPairTile / 2; h > 0; h >>= 1) {
      if (a < h) {
        red[0][a] += red[0][a + h];
        if constexpr (kScalars > 1) red[1][a] += red[1][a + h];
      }
      __syncthreads();
    }
    if (a == 0) {
      const int n_blocks = gridDim.x * gridDim.y;
      const int blk = blockIdx.y * gridDim.x + blockIdx.x;
      block_partial[blk] = red[0][0];
      if constexpr (kScalars > 1) block_partial[n_blocks + blk] = red[1][0];
    }
  }
}

// Blocks [0, vec_blocks) sum the vector partials over the column tiles in
// tile order into out_vec (n, 3); block vec_blocks + s sums scalar s over
// the blocks' partials by a fixed tree into out_scalars[s].
__global__ void lj_pair_reduce_kernel(const float* __restrict__ partial,
                                      int n, int tiles, int vec_blocks,
                                      const float* __restrict__ block_partial,
                                      int n_blocks, float* __restrict__ out_vec,
                                      float* __restrict__ out_scalars) {
  if (static_cast<int>(blockIdx.x) < vec_blocks) {
    const long long e = static_cast<long long>(blockIdx.x) * kReduceThreads +
                        threadIdx.x;
    const long long per_tile = static_cast<long long>(n) * 3;
    if (e >= per_tile) return;
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc += partial[t * per_tile + e];
    out_vec[e] = acc;
    return;
  }
  __shared__ float s[kReduceThreads];
  const int k = blockIdx.x - vec_blocks;
  const float* src = block_partial + static_cast<long long>(k) * n_blocks;
  float acc = 0.f;
  for (int p = threadIdx.x; p < n_blocks; p += kReduceThreads) acc += src[p];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (static_cast<int>(threadIdx.x) < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out_scalars[k] = s[0];
}

template <int kMode>
int launch_lj_pair(const float* xyz, const float* w, int n, float lx,
                   float ly, float lz, float cutoff, const float* sigma,
                   const float* eps, int rep, int attr, float* partial,
                   float* block_partial, float* out_vec, float* out_scalars,
                   void* stream) {
  if (n < 1 || rep < 0 || attr < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kPairTile - 1) / kPairTile;
  lj_pair_partial_kernel<kMode><<<dim3(tiles, tiles), kPairTile, 0, s>>>(
      xyz, w, n, lx, ly, lz, cutoff * cutoff, sigma, eps, rep, attr, partial,
      block_partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_blocks = (3 * n + kReduceThreads - 1) / kReduceThreads;
  const int n_scalars = ModeScalars<kMode>::value;
  lj_pair_reduce_kernel<<<vec_blocks + n_scalars, kReduceThreads, 0, s>>>(
      partial, n, tiles, vec_blocks, block_partial, tiles * tiles, out_vec,
      out_scalars);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile edge the caller sizes its scratch by (ops/pair.py PAIR_TILE).
int mdg_pair_tile() { return kPairTile; }

// One entry point for the four kernels; mode picks the kernel:
//   0 K5 energy and forces, 1 K6 force, 2 K6b force vjp, 3 K7 force and
//   parameter sums.
//   xyz (n, 3) f32; w (n, 3) f32, K6b's cotangent (null elsewhere);
//   lx, ly, lz the diagonal cell; sigma, eps device scalars (f32);
//   rep, attr the integer powers (>= 0);
//   partial: tiles * n * 3 f32 scratch, tiles = ceil(n / mdg_pair_tile());
//   block_partial: scalars * tiles^2 f32 scratch (null for K6);
//   out_vec (n, 3) f32; out_scalars: K5 (1,) energy, K6b (2,) dsigma and
//   deps, K7 (2,) dU/dsigma and U/eps, null for K6.
int mdg_lj_pair(int mode, const float* xyz, const float* w, int n, float lx,
                float ly, float lz, float cutoff, const float* sigma,
                const float* eps, int rep, int attr, float* partial,
                float* block_partial, float* out_vec, float* out_scalars,
                void* stream) {
  switch (mode) {
    case kEnergyForces:
      return launch_lj_pair<kEnergyForces>(
          xyz, w, n, lx, ly, lz, cutoff, sigma, eps, rep, attr, partial,
          block_partial, out_vec, out_scalars, stream);
    case kForce:
      return launch_lj_pair<kForce>(
          xyz, w, n, lx, ly, lz, cutoff, sigma, eps, rep, attr, partial,
          block_partial, out_vec, out_scalars, stream);
    case kForceVjp:
      if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return launch_lj_pair<kForceVjp>(
          xyz, w, n, lx, ly, lz, cutoff, sigma, eps, rep, attr, partial,
          block_partial, out_vec, out_scalars, stream);
    case kForceParam:
      return launch_lj_pair<kForceParam>(
          xyz, w, n, lx, ly, lz, cutoff, sigma, eps, rep, attr, partial,
          block_partial, out_vec, out_scalars, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
