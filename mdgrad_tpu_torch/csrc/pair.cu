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
//   K7:  F_i, dU/dsigma = 1/2 sum du/dsigma and U / eps = 1/2 sum u / eps
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
// each step and needs the forward's forces, and the vjp, exactly.  Ragged
// edges are masked; nothing is padded.  Integer powers go by repeated
// squaring, as JAX's integer_pow does.
//
// All four modes walk each i < j pair once (lj_half_kernel).  Each
// function's pair term is antisymmetric, so the row takes it and the
// column its negative: K5, K6 and K7 -g d_ij; K6b T_ij = h (W_ij . d_ij)
// d_ij + g W_ij (d and W_ij both flip sign).  Over i < j the scalars sum
// each pair once, so the ordered sums' 1/2 goes with the second visit:
// K5 E = sum u, K7 sum du/dsigma and sum u / eps; K6b d(W.F)/d(sigma, eps)
// = sum (dg/dsigma, g / eps) (W_ij . d_ij), which reuse the dot product
// the vector term needs.
//   * the minimum image and r^2 come from image.cuh's image_r2: |d| is
//     compared with a threshold per axis, found once per cell by the
//     wrapper, which gives the same bits as d - rintf(d / L) L with no
//     division; only a block whose atoms span more than ~1.5 L on an axis
//     (positions not wrapped) checks each pair for the IEEE formula; r^2
//     is summed with no contraction, as the plain versions round it, so a
//     pair at exactly the cutoff stays out in every mode;
//   * the LJ powers (12, 6) are unrolled at compile time;
//   * blocks of four warps over 64 x 64 block-tile pairs with row tile <=
//     column tile (2016 blocks at N = 4000, 253 at N = 1372, so ~8 warps
//     on each SM); each warp walks one 32 x 32 tile pair with a skewed
//     walk that gives the pair's term to the row in registers and to the
//     column in shared memory, one fixed add per column per step; K6b
//     stages W beside the positions;
//   * each block sums its warps' row and column partials in a fixed order
//     and writes them once to a (block tiles, N, 3) scratch, and its
//     scalars (a fixed shuffle tree per warp, then the warps in order) to
//     a (scalars, blocks) scratch; a second launch sums both in order.

#include <cuda_runtime.h>

#include "image.cuh"

namespace {

constexpr int kReduceThreads = 256;

enum Mode { kEnergyForces = 0, kForce = 1, kForceVjp = 2, kForceParam = 3 };

// scalar outputs of each mode: E; none; d/dsigma, d/deps; dU/dsigma, U/eps
__host__ __device__ constexpr int mode_scalars(int mode) {
  return mode == kEnergyForces ? 1 : mode == kForce ? 0 : 2;
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

// ---- the i < j walk -------------------------------------------------------

constexpr int kWarpTile = 32;                 // atoms per warp tile
constexpr int kForceTile = 2 * kWarpTile;     // atoms per block tile
constexpr int kForceThreads = 4 * 32;         // 2 x 2 warps, one per tile pair

struct LjArgs {
  float cut_sq, sigma, eps;
  int rep, attr;
};

// One lane's row: its position and W (K6b), its vector and scalar sums.
struct Row {
  float x, y, z, wx, wy, wz;
  float vx = 0.f, vy = 0.f, vz = 0.f;
  float s0 = 0.f, s1 = 0.f;
};

// A warp tile of columns in shared memory: positions, W (K6b; elsewhere
// the positions again, never read) and the column sums [column, xyz].
struct Cols {
  const float *x, *y, *z, *wx, *wy, *wz;
  float* acc;
};

// The steps [first, last) of one warp's skewed walk over a 32 x 32 tile pair,
// lanes below `lanes` taking part.  kFar: some |d| may reach t2 (the block
// spans more than t2 on an axis), so each pair checks for the IEEE path.
// kRep, kAttr: the powers when known at compile time (-1: rep, attr).
template <int kMode, bool kFar, int kRep, int kAttr>
__device__ __forceinline__ void half_steps(int first, int last, int lanes,
                                           Row& row, const Cols& col,
                                           const Image& im, const LjArgs& p) {
  const int lane = threadIdx.x & 31;
  const int r_pow = kRep >= 0 ? kRep : p.rep;
  const int a_pow = kAttr >= 0 ? kAttr : p.attr;
  const float Rp = static_cast<float>(r_pow);
  const float Ap = static_cast<float>(a_pow);
  const bool on = lane < lanes;
  for (int s = first; s < last; ++s) {
    const int c = (lane + s) & (kWarpTile - 1);
    float dx, dy, dz;
    const float r2 = image_r2<kFar>(im, row.x, row.y, row.z, col.x[c],
                                    col.y[c], col.z[c], dx, dy, dz);
    if (on && r2 < p.cut_sq) {
      const float inv_r2 = 1.f / r2;
      const float sr = p.sigma * sqrtf(inv_r2);
      const float sr_a = ipow(sr, a_pow);
      const float sr_r = ipow(sr, r_pow);
      const float g0 = 4.f * (-Rp * sr_r + Ap * sr_a) * inv_r2;   // g / eps
      const float g = p.eps * g0;
      float tx, ty, tz;   // the pair's term: + to the row, - to the column
      if constexpr (kMode == kForceVjp) {
        const float h = 4.f * p.eps *
                        (Rp * (Rp + 2.f) * sr_r - Ap * (Ap + 2.f) * sr_a) *
                        inv_r2 * inv_r2;
        const float wx = col.wx[c] - row.wx;
        const float wy = col.wy[c] - row.wy;
        const float wz = col.wz[c] - row.wz;
        const float wd = wx * dx + wy * dy + wz * dz;
        const float hwd = h * wd;
        tx = hwd * dx + g * wx;
        ty = hwd * dy + g * wy;
        tz = hwd * dz + g * wz;
        const float dgds = 4.f * p.eps * (-Rp * Rp * sr_r + Ap * Ap * sr_a) *
                           inv_r2 / p.sigma;
        row.s0 += dgds * wd;
        row.s1 += g0 * wd;
      } else {
        tx = -(g * dx);
        ty = -(g * dy);
        tz = -(g * dz);
        if constexpr (kMode == kEnergyForces) {
          row.s0 += 4.f * p.eps * (sr_r - sr_a);
        } else if constexpr (kMode == kForceParam) {
          row.s0 += 4.f * p.eps * (Rp * sr_r - Ap * sr_a) / p.sigma;
          row.s1 += 4.f * (sr_r - sr_a);
        }
      }
      row.vx += tx;
      row.vy += ty;
      row.vz += tz;
      col.acc[3 * c] -= tx;
      col.acc[3 * c + 1] -= ty;
      col.acc[3 * c + 2] -= tz;
    }
    __syncwarp();
  }
}

// One warp's tile pair: a full one walks steps 0-31; a diagonal one takes
// each unordered pair once, steps 1-15 and step 16 from lanes 0-15.
template <int kMode, bool kFar, int kRep, int kAttr>
__device__ __forceinline__ void half_tile(bool diag_tile, Row& row,
                                          const Cols& col, const Image& im,
                                          const LjArgs& p) {
  constexpr int kHalf = kWarpTile / 2;
  if (diag_tile) {
    half_steps<kMode, kFar, kRep, kAttr>(1, kHalf, kWarpTile, row, col, im, p);
    half_steps<kMode, kFar, kRep, kAttr>(kHalf, kHalf + 1, kHalf, row, col,
                                         im, p);
  } else {
    half_steps<kMode, kFar, kRep, kAttr>(0, kWarpTile, kWarpTile, row, col,
                                         im, p);
  }
}

// Block b covers the block-tile pair (R, C), R <= C, b = C (C + 1) / 2 + R.
// Warp (wr, wc) walks the warp-tile pair (2 R + wr, 2 C + wc); on the
// diagonal block warp (1, 0) idles and the warps (w, w) walk half a tile.
// Lane a owns row a and at step s takes column (a + s) mod 32: the pair's
// term goes to the row in registers and to the column in shared memory,
// where at each step every column receives one add from one fixed lane
// (__syncwarp between steps), so the sums run in a fixed order.  Out of
// range atoms are NaN (W 0), so r^2 < cutoff^2 is false for them.  A block
// whose atoms span less than t2 on every axis (wrapped positions always
// do) skips the IEEE check.
// partial (block tiles, n, 3): atom p of block tile P gets in slot Q its
// sum over the pairs with block tile Q, written once, by block (P, Q) or
// (Q, P).  block_partial (scalars, blocks): the block's scalar sums.
template <int kMode, int kRep, int kAttr>
__global__ void __launch_bounds__(kForceThreads) lj_half_kernel(
    const float* __restrict__ xyz, const float* __restrict__ w, int n,
    Image im, float cut_sq, const float* __restrict__ sigma_p,
    const float* __restrict__ eps_p, int rep, int attr,
    float* __restrict__ partial, float* __restrict__ block_partial) {
  constexpr int kScalars = mode_scalars(kMode);
  constexpr bool kUsesW = kMode == kForceVjp;
  // atoms of the block: rows 0-63, then columns 64-127, per axis
  __shared__ float pos[3][2 * kForceTile];
  __shared__ float wsh[kUsesW ? 3 : 1][kUsesW ? 2 * kForceTile : 1];
  __shared__ float col_acc[2][kForceTile * 3];   // [wr][column, xyz]
  __shared__ float row_acc[2][kForceTile * 3];   // [wc][row, xyz]
  __shared__ float warp_sum[kScalars > 0 ? kScalars : 1][4];
  __shared__ int wide_block;
  const int b = blockIdx.x;
  int C = static_cast<int>((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
  while ((C + 1) * (C + 2) / 2 <= b) ++C;
  while (C * (C + 1) / 2 > b) --C;
  const int R = b - C * (C + 1) / 2;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int r0 = R * kForceTile, c0 = C * kForceTile;
  {
    const int q = t < kForceTile ? r0 + t : c0 + t - kForceTile;
    const bool real = q < n;
    const float nan = __int_as_float(0x7fffffff);
    for (int k = 0; k < 3; ++k) pos[k][t] = real ? xyz[3LL * q + k] : nan;
    if constexpr (kUsesW) {
      for (int k = 0; k < 3; ++k) wsh[k][t] = real ? w[3LL * q + k] : 0.f;
    }
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
  Row row;
  if (!(diag_block && wr > wc)) {
    const bool diag_tile = diag_block && wr == wc;
    const int a = wr * kWarpTile + lane;
    const int c = kForceTile + wc * kWarpTile;
    row.x = pos[0][a];
    row.y = pos[1][a];
    row.z = pos[2][a];
    const float* cw[3] = {pos[0] + c, pos[1] + c, pos[2] + c};
    if constexpr (kUsesW) {
      row.wx = wsh[0][a];
      row.wy = wsh[1][a];
      row.wz = wsh[2][a];
      for (int k = 0; k < 3; ++k) cw[k] = wsh[k] + c;
    }
    const Cols col{pos[0] + c, pos[1] + c, pos[2] + c,
                   cw[0],      cw[1],      cw[2],
                   col_acc[wr] + wc * kWarpTile * 3};
    const LjArgs p{cut_sq, __ldg(sigma_p), __ldg(eps_p), rep, attr};
    if (wide_block) {
      half_tile<kMode, true, kRep, kAttr>(diag_tile, row, col, im, p);
    } else {
      half_tile<kMode, false, kRep, kAttr>(diag_tile, row, col, im, p);
    }
    float* dst = row_acc[wc] + a * 3;
    dst[0] = row.vx;
    dst[1] = row.vy;
    dst[2] = row.vz;
  }
  if constexpr (kScalars > 0) {   // every warp, the idle one's sums 0
    float s[2] = {row.s0, row.s1};
    for (int k = 0; k < kScalars; ++k) {
      for (int o = 16; o > 0; o >>= 1) {
        s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
      }
      if (lane == 0) warp_sum[k][warp] = s[k];
    }
  }
  __syncthreads();

  if constexpr (kScalars > 0) {
    if (t == 0) {
      for (int k = 0; k < kScalars; ++k) {
        block_partial[static_cast<long long>(k) * gridDim.x + b] =
            ((warp_sum[k][0] + warp_sum[k][1]) + warp_sum[k][2]) +
            warp_sum[k][3];
      }
    }
  }
  // threads 0-63 write the row atoms, 64-127 the column atoms; on the
  // diagonal block rows and columns are the same atoms: one slot, R
  const bool col_side = t >= kForceTile;
  const int a = col_side ? t - kForceTile : t;
  if (diag_block && col_side) return;
  const int q = (col_side ? c0 : r0) + a;
  if (q >= n) return;
  const int slot = col_side ? R : C;
  float* dst = partial + (static_cast<long long>(slot) * n + q) * 3;
  for (int k = 0; k < 3; ++k) {
    const float rows = row_acc[0][3 * a + k] + row_acc[1][3 * a + k];
    const float cols = col_acc[0][3 * a + k] + col_acc[1][3 * a + k];
    dst[k] = diag_block ? rows + cols : (col_side ? cols : rows);
  }
}

// Blocks [0, vec_blocks) sum the vector partials over the tiles in tile
// order into out_vec (n, 3); block vec_blocks + s sums scalar s over the
// blocks' partials by a fixed tree into out_scalars[s].
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

int tiles_of(int n) { return (n + kForceTile - 1) / kForceTile; }

// blocks of the first launch: the block-tile pairs R <= C
long long blocks_of(int n) {
  const long long tiles = tiles_of(n);
  return tiles * (tiles + 1) / 2;
}

// The second launch, after checking the first.
int launch_reduce(int mode, const float* partial, int n,
                  const float* block_partial, float* out_vec,
                  float* out_scalars, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_blocks = (3 * n + kReduceThreads - 1) / kReduceThreads;
  lj_pair_reduce_kernel<<<vec_blocks + mode_scalars(mode), kReduceThreads, 0,
                          s>>>(partial, n, tiles_of(n), vec_blocks,
                               block_partial,
                               static_cast<int>(blocks_of(n)), out_vec,
                               out_scalars);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_lj_half(const float* xyz, const float* w, int n, const Image& im,
                   float cutoff, const float* sigma, const float* eps,
                   int rep, int attr, float* partial, float* block_partial,
                   float* out_vec, float* out_scalars, cudaStream_t s) {
  const int blocks = static_cast<int>(blocks_of(n));
  if (rep == 12 && attr == 6) {   // the LJ powers, unrolled
    lj_half_kernel<kMode, 12, 6><<<blocks, kForceThreads, 0, s>>>(
        xyz, w, n, im, cutoff * cutoff, sigma, eps, rep, attr, partial,
        block_partial);
  } else {
    lj_half_kernel<kMode, -1, -1><<<blocks, kForceThreads, 0, s>>>(
        xyz, w, n, im, cutoff * cutoff, sigma, eps, rep, attr, partial,
        block_partial);
  }
  return launch_reduce(kMode, partial, n, block_partial, out_vec,
                       out_scalars, s);
}

}  // namespace

extern "C" {

// The i < j walk's block tile (ops/pair.py FORCE_TILE).
int mdg_force_tile() { return kForceTile; }

// Float counts of mdg_lj_pair's scratch for `mode` and n atoms: `partial`
// (which 0: tiles * n * 3) or `block_partial` (which 1: scalars * blocks,
// 0 for K6); -1 for a bad mode, n or which.
long long mdg_lj_scratch(int mode, int n, int which) {
  if (mode < kEnergyForces || mode > kForceParam || n < 1 || which < 0 ||
      which > 1) {
    return -1;
  }
  if (which == 0) return static_cast<long long>(tiles_of(n)) * n * 3;
  return mode_scalars(mode) * blocks_of(n);
}

// One entry point for the four kernels; mode picks the kernel:
//   0 K5 energy and forces, 1 K6 force, 2 K6b force vjp, 3 K7 force and
//   parameter sums.
//   xyz (n, 3) f32; w (n, 3) f32, K6b's cotangent (null elsewhere);
//   lx, ly, lz the diagonal cell; tx, ty, tz and ux, uy, uz each axis's
//   image thresholds t1 and t2 (image.cuh);
//   sigma, eps device scalars (f32); rep, attr the integer powers (>= 0);
//   partial: mdg_lj_scratch(mode, n, 0) f32;
//   block_partial: mdg_lj_scratch(mode, n, 1) f32 (null for K6);
//   out_vec (n, 3) f32; out_scalars: K5 (1,) energy, K6b (2,) dsigma and
//   deps, K7 (2,) dU/dsigma and U/eps, null for K6.
int mdg_lj_pair(int mode, const float* xyz, const float* w, int n, float lx,
                float ly, float lz, float tx, float ty, float tz, float ux,
                float uy, float uz, float cutoff, const float* sigma,
                const float* eps, int rep, int attr, float* partial,
                float* block_partial, float* out_vec, float* out_scalars,
                void* stream) {
  if (n < 1 || rep < 0 || attr < 0 || (mode == kForceVjp && w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Image im{lx, ly, lz, tx, ty, tz, ux, uy, uz};
  switch (mode) {
    case kEnergyForces:
      return launch_lj_half<kEnergyForces>(xyz, w, n, im, cutoff, sigma, eps,
                                           rep, attr, partial, block_partial,
                                           out_vec, out_scalars, s);
    case kForce:
      return launch_lj_half<kForce>(xyz, w, n, im, cutoff, sigma, eps, rep,
                                    attr, partial, block_partial, out_vec,
                                    out_scalars, s);
    case kForceVjp:
      return launch_lj_half<kForceVjp>(xyz, w, n, im, cutoff, sigma, eps,
                                       rep, attr, partial, block_partial,
                                       out_vec, out_scalars, s);
    case kForceParam:
      return launch_lj_half<kForceParam>(xyz, w, n, im, cutoff, sigma, eps,
                                         rep, attr, partial, block_partial,
                                         out_vec, out_scalars, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
