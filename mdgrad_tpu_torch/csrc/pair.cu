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
// minimum image and r^2; only the pairs inside the cutoff (~55 neighbours
// per atom at the LJ liquid's density, about 1.4% of the pairs at N =
// 4000) need the LJ terms.  Bytes are 12 per atom in and out (24 with W).
// Every sum is taken in a fixed order, with no float atomics, so each
// kernel gives the same bits on every call: the replay adjoint re-runs
// each step and needs the forward's forces exactly.  Ragged edges are
// masked; nothing is padded.  Integer powers go by repeated squaring, as
// JAX's integer_pow does.  Two walks:
//
// K5, K6b and K7 (modes 0, 2, 3) walk ordered pairs, twice the i < j
// bound, so each row's sums stay in one thread's registers:
//   * grid (column tile, row tile) of 128 x 128 tiles;
//   * a block stages its column tile's positions (and W) in shared
//     memory; thread a owns row i0 + a and walks the tile's columns, every
//     thread reading the same shared word at once (a broadcast), with the
//     minimum image d - rintf(d / L) L (three IEEE divisions a pair);
//   * each block writes its rows' vector partials to a (column tiles, N,
//     3) scratch and its scalar partials (energy; dsigma, deps; dU/dsigma,
//     U/eps), summed over its rows by a fixed shared-memory tree, to a
//     (scalars, blocks) scratch;
//   * one second launch sums the vector partials over the column tiles in
//     tile order and the scalar partials over the blocks by a fixed tree.
//
// K6 (mode 1, the force on every MD step) walks each i < j pair once and
// has no division outside the cutoff (lj_force_half_kernel):
//   * the minimum image compares |d| with a threshold per axis, found
//     once per cell by the wrapper, and gives the same bits as d -
//     rintf(d / L) L (image_exact); only a block whose atoms span more
//     than ~1.5 L on an axis (positions not wrapped) checks each pair for
//     the IEEE formula;
//   * the LJ powers (12, 6) are unrolled at compile time;
//   * blocks of four warps over 64 x 64 block-tile pairs with row tile <=
//     column tile (2016 blocks at N = 4000, 253 at N = 1372, so ~8 warps
//     on each SM); each warp walks one 32 x 32 tile pair with a skewed
//     walk that gives the pair's force to the row in a register and to
//     the column in shared memory, one fixed add per column per step;
//   * each block sums its warps' row and column partials in a fixed order
//     and writes them once to a (block tiles, N, 3) scratch, which the
//     same second launch sums in tile order.

#include <cuda_runtime.h>

#include "image.cuh"

namespace {

constexpr int kPairTile = 128;
constexpr int kReduceThreads = 256;

enum Mode { kEnergyForces = 0, kForce = 1, kForceVjp = 2, kForceParam = 3 };

template <int kMode>
struct ModeScalars {
  static constexpr int value = kMode == kEnergyForces ? 1 : 2;
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

// ---- K6: the force as an i < j walk ----------------------------------------

constexpr int kWarpTile = 32;                 // atoms per warp tile
constexpr int kForceTile = 2 * kWarpTile;     // atoms per block tile
constexpr int kForceThreads = 4 * 32;         // 2 x 2 warps, one per tile pair

// Image, image_exact and image_ieee: the division-free minimum image
// (image.cuh).

// The steps [s0, s1) of one warp's skewed walk over a 32 x 32 tile pair,
// lanes below `lanes` taking part.  kFar: some |d| may reach t2 (the block
// spans more than t2 on an axis), so each pair checks for the IEEE path.
// kRep, kAttr: the powers when known at compile time (-1: rep, attr).
template <bool kFar, int kRep, int kAttr>
__device__ __forceinline__ void force_steps(
    int s0, int s1, int lanes, float xi, float yi, float zi,
    const float* px, const float* py, const float* pz, float* acc,
    const Image& im, float cut_sq, float sigma, float eps, int rep, int attr,
    float& fx, float& fy, float& fz) {
  const int lane = threadIdx.x & 31;
  const int r_pow = kRep >= 0 ? kRep : rep;
  const int a_pow = kAttr >= 0 ? kAttr : attr;
  const float Rp = static_cast<float>(r_pow);
  const float Ap = static_cast<float>(a_pow);
  const bool on = lane < lanes;
  for (int s = s0; s < s1; ++s) {
    const int c = (lane + s) & (kWarpTile - 1);
    float dx = xi - px[c];
    float dy = yi - py[c];
    float dz = zi - pz[c];
    if (kFar && (fabsf(dx) >= im.ux || fabsf(dy) >= im.uy ||
                 fabsf(dz) >= im.uz)) {
      dx = image_ieee(dx, im.lx);
      dy = image_ieee(dy, im.ly);
      dz = image_ieee(dz, im.lz);
    } else {
      dx = image_exact(dx, im.lx, im.tx);
      dy = image_exact(dy, im.ly, im.ty);
      dz = image_exact(dz, im.lz, im.tz);
    }
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (on && r2 < cut_sq) {
      const float inv_r2 = 1.f / r2;
      const float sr = sigma * sqrtf(inv_r2);
      const float sr_a = ipow(sr, a_pow);
      const float sr_r = ipow(sr, r_pow);
      const float g = eps * (4.f * (-Rp * sr_r + Ap * sr_a) * inv_r2);
      const float gx = g * dx, gy = g * dy, gz = g * dz;
      fx -= gx;
      fy -= gy;
      fz -= gz;
      acc[3 * c] += gx;
      acc[3 * c + 1] += gy;
      acc[3 * c + 2] += gz;
    }
    __syncwarp();
  }
}

// One warp's tile pair: a full one walks steps 0-31; a diagonal one takes
// each unordered pair once, steps 1-15 and step 16 from lanes 0-15.
template <bool kFar, int kRep, int kAttr>
__device__ __forceinline__ void force_tile(
    bool diag_tile, float xi, float yi, float zi, const float* px,
    const float* py, const float* pz, float* acc, const Image& im,
    float cut_sq, float sigma, float eps, int rep, int attr, float& fx,
    float& fy, float& fz) {
  constexpr int kHalf = kWarpTile / 2;
  if (diag_tile) {
    force_steps<kFar, kRep, kAttr>(1, kHalf, kWarpTile, xi, yi, zi, px, py,
                                   pz, acc, im, cut_sq, sigma, eps, rep, attr,
                                   fx, fy, fz);
    force_steps<kFar, kRep, kAttr>(kHalf, kHalf + 1, kHalf, xi, yi, zi, px,
                                   py, pz, acc, im, cut_sq, sigma, eps, rep,
                                   attr, fx, fy, fz);
  } else {
    force_steps<kFar, kRep, kAttr>(0, kWarpTile, kWarpTile, xi, yi, zi, px,
                                   py, pz, acc, im, cut_sq, sigma, eps, rep,
                                   attr, fx, fy, fz);
  }
}

// Block b covers the block-tile pair (R, C), R <= C, b = C (C + 1) / 2 + R.
// Warp (wr, wc) walks the warp-tile pair (2 R + wr, 2 C + wc); on the
// diagonal block warp (1, 0) idles and the warps (w, w) walk half a tile.
// Lane a owns row a and at step s takes column (a + s) mod 32: the pair's
// force goes to the row in a register and to the column in shared memory,
// where at each step every column receives one add from one fixed lane
// (__syncwarp between steps), so the sums run in a fixed order.  Out of
// range atoms are NaN, so r^2 < cutoff^2 is false for them.  A block whose
// atoms span less than t2 on every axis (wrapped positions always do)
// skips the IEEE check.
// partial (block tiles, n, 3): atom p of block tile P gets in slot Q its
// sum over the pairs with block tile Q, written once, by block (P, Q) or
// (Q, P).
template <int kRep, int kAttr>
__global__ void __launch_bounds__(kForceThreads) lj_force_half_kernel(
    const float* __restrict__ xyz, int n, Image im, float cut_sq,
    const float* __restrict__ sigma_p, const float* __restrict__ eps_p,
    int rep, int attr, float* __restrict__ partial) {
  // atoms of the block: rows 0-63, then columns 64-127, per axis
  __shared__ float pos[3][2 * kForceTile];
  __shared__ float col_acc[2][kForceTile * 3];   // [wr][column, xyz]
  __shared__ float row_acc[2][kForceTile * 3];   // [wc][row, xyz]
  __shared__ int wide_block;
  const int b = blockIdx.x;
  int C = static_cast<int>((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
  while ((C + 1) * (C + 2) / 2 <= b) ++C;
  while (C * (C + 1) / 2 > b) --C;
  const int R = b - C * (C + 1) / 2;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wr = t >> 6, wc = (t >> 5) & 1;
  const int r0 = R * kForceTile, c0 = C * kForceTile;
  {
    const int p = t < kForceTile ? r0 + t : c0 + t - kForceTile;
    const bool real = p < n;
    const float nan = __int_as_float(0x7fffffff);
    for (int k = 0; k < 3; ++k) pos[k][t] = real ? xyz[3LL * p + k] : nan;
  }
  for (int k = t; k < 2 * kForceTile * 3; k += kForceThreads) {
    (&col_acc[0][0])[k] = 0.f;
    (&row_acc[0][0])[k] = 0.f;
  }
  __syncthreads();
  if (t < 32) {   // the block's span per axis (fminf/fmaxf skip the NaNs)
    bool wide = false;
    const float u[3] = {im.ux, im.uy, im.uz};
    for (int k = 0; k < 3; ++k) {
      float lo = pos[k][t], hi = lo;
      for (int q = t + 32; q < 2 * kForceTile; q += 32) {
        lo = fminf(lo, pos[k][q]);
        hi = fmaxf(hi, pos[k][q]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      wide |= !(hi - lo < u[k]);
    }
    if (t == 0) wide_block = wide;
  }
  __syncthreads();

  const bool diag_block = R == C;
  if (!(diag_block && wr > wc)) {
    const bool diag_tile = diag_block && wr == wc;
    const int a = wr * kWarpTile + lane;
    const float xi = pos[0][a], yi = pos[1][a], zi = pos[2][a];
    const int c = kForceTile + wc * kWarpTile;
    const float sigma = __ldg(sigma_p);
    const float eps = __ldg(eps_p);
    float* acc = col_acc[wr] + wc * kWarpTile * 3;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if (wide_block) {
      force_tile<true, kRep, kAttr>(diag_tile, xi, yi, zi, pos[0] + c,
                                    pos[1] + c, pos[2] + c, acc, im, cut_sq,
                                    sigma, eps, rep, attr, fx, fy, fz);
    } else {
      force_tile<false, kRep, kAttr>(diag_tile, xi, yi, zi, pos[0] + c,
                                     pos[1] + c, pos[2] + c, acc, im, cut_sq,
                                     sigma, eps, rep, attr, fx, fy, fz);
    }
    float* row = row_acc[wc] + a * 3;
    row[0] = fx;
    row[1] = fy;
    row[2] = fz;
  }
  __syncthreads();

  // threads 0-63 write the row atoms, 64-127 the column atoms; on the
  // diagonal block rows and columns are the same atoms: one slot, R
  const bool col_side = t >= kForceTile;
  const int a = col_side ? t - kForceTile : t;
  if (diag_block && col_side) return;
  const int p = (col_side ? c0 : r0) + a;
  if (p >= n) return;
  const int slot = col_side ? R : C;
  float* dst = partial + (static_cast<long long>(slot) * n + p) * 3;
  for (int k = 0; k < 3; ++k) {
    const float rows = row_acc[0][3 * a + k] + row_acc[1][3 * a + k];
    const float cols = col_acc[0][3 * a + k] + col_acc[1][3 * a + k];
    dst[k] = diag_block ? rows + cols : (col_side ? cols : rows);
  }
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

int launch_lj_force(const float* xyz, int n, const Image& im, float cutoff,
                    const float* sigma, const float* eps, int rep, int attr,
                    float* partial, float* out_vec, void* stream) {
  if (n < 1 || rep < 0 || attr < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kForceTile - 1) / kForceTile;
  const int blocks = tiles * (tiles + 1) / 2;
  if (rep == 12 && attr == 6) {   // the LJ powers, unrolled
    lj_force_half_kernel<12, 6><<<blocks, kForceThreads, 0, s>>>(
        xyz, n, im, cutoff * cutoff, sigma, eps, rep, attr, partial);
  } else {
    lj_force_half_kernel<-1, -1><<<blocks, kForceThreads, 0, s>>>(
        xyz, n, im, cutoff * cutoff, sigma, eps, rep, attr, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_blocks = (3 * n + kReduceThreads - 1) / kReduceThreads;
  lj_pair_reduce_kernel<<<vec_blocks, kReduceThreads, 0, s>>>(
      partial, n, tiles, vec_blocks, nullptr, 0, out_vec, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile edges the caller sizes its scratch by: K5, K6b and K7's
// (ops/pair.py PAIR_TILE) and K6's (FORCE_TILE).
int mdg_pair_tile() { return kPairTile; }
int mdg_force_tile() { return kForceTile; }

// One entry point for the four kernels; mode picks the kernel:
//   0 K5 energy and forces, 1 K6 force, 2 K6b force vjp, 3 K7 force and
//   parameter sums.
//   xyz (n, 3) f32; w (n, 3) f32, K6b's cotangent (null elsewhere);
//   lx, ly, lz the diagonal cell; tx, ty, tz and ux, uy, uz each axis's
//   image thresholds t1 and t2 (K6 only; see image_exact);
//   sigma, eps device scalars (f32); rep, attr the integer powers (>= 0);
//   partial: tiles * n * 3 f32 scratch, tiles = ceil(n / mdg_pair_tile()),
//   for K6 ceil(n / mdg_force_tile());
//   block_partial: scalars * tiles^2 f32 scratch (null for K6);
//   out_vec (n, 3) f32; out_scalars: K5 (1,) energy, K6b (2,) dsigma and
//   deps, K7 (2,) dU/dsigma and U/eps, null for K6.
int mdg_lj_pair(int mode, const float* xyz, const float* w, int n, float lx,
                float ly, float lz, float tx, float ty, float tz, float ux,
                float uy, float uz, float cutoff, const float* sigma,
                const float* eps, int rep, int attr, float* partial,
                float* block_partial, float* out_vec, float* out_scalars,
                void* stream) {
  switch (mode) {
    case kEnergyForces:
      return launch_lj_pair<kEnergyForces>(
          xyz, w, n, lx, ly, lz, cutoff, sigma, eps, rep, attr, partial,
          block_partial, out_vec, out_scalars, stream);
    case kForce:
      return launch_lj_force(xyz, n, Image{lx, ly, lz, tx, ty, tz, ux, uy, uz},
                             cutoff, sigma, eps, rep, attr, partial, out_vec,
                             stream);
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
