// Soft-histogram RDF counts over F >= 1 frames, and their gradient, on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mdgrad_tpu/ops/pallas_rdf.py:
//   counts            (_fwd_kernel,        "K3", one frame)
//   counts.frames     (_fwd_kernel_frames, "K4", summed over frames)
// as ONE forward kernel with a frame axis:
//   counts[g] = sum_f sum_{i<j, r_ij < cutoff} exp(coeff_g (r_ij - mu_g)^2)
// and their vjps
//   counts_bwd        (_bwd_kernel,        "K3b", one frame)
//   counts_frames_bwd (_bwd_kernel_frames, "K4b", per frame)
// as ONE backward kernel with a frame axis: given the cotangent ct (G,) of
// the counts, per frame
//   dxyz[f, i] = sum_{j != i, r_ij < cutoff} w(r_ij) d_ij / r_ij
//   w(r)       = sum_g ct_g 2 coeff_g (r - mu_g) exp(coeff_g (r - mu_g)^2)
// with d_ij = x_i - x_j under the diagonal-cell minimum image
// d - rint(d / L) L of the TPU kernels, taken here without a division
// (image.cuh, bit-equal).  The TPU kernels' 1/2-weighted full i != j
// forward sum is the same number as the i < j sum here; the backward
// walks each i < j pair once and gives +-(w / r) d to both sites.
//
// What bounds both on the card: the exponentials, on the SFU (16 results
// a clock an SM, 16x below the f32 rate), and only those that are not
// zero.  exp(coeff_g (r - mu_g)^2) is exactly +0 in float32 once the
// argument is below -103.97 (half the least subnormal); the kernels take
// a term only where |r - mu_g| < reach_g = sqrt(110 / -coeff_g), whose
// argument -110 leaves a 5.8% margin, far beyond any float32 rounding of
// reach_g or of the argument, so every term skipped is an exact zero and
// skipping it changes no bit of any sum.  With coeff = -1 / (2 w^2) and w
// the bin spacing, a pair inside the cutoff meets ~24 of the water path's
// 109 bins and ~19 of the LJ fit's 100 (counted on their data by
// chip_smoke.py).  The window is derived from the mu and coeff of the
// call, never from a shape: a bin whose coeff is not negative (or not
// finite) has an unbounded window and meets every pair.  Bytes are
// negligible (12 B per site).  Neither kernel comes near that bound: the
// distances of every i < j pair and each block's latency take most of
// their time (PERF.md).
//
// Both kernels:
//   * one block per tile pair (R <= C) of one frame, i < j pairs only, the
//     sites staged in shared memory.  Tiling site u is site u * stride
//     mod n, stride ~0.618 n and coprime with n, so that sites close in
//     space (close in index on a lattice or along a trajectory) are spread
//     over all tiles and no tile pair is much denser than another: at few
//     blocks the slowest block sets the time.  The backward keeps the
//     sites' own order above kSpreadBlocks blocks: measured on an H100
//     (PERF.md), the strided order is the faster at 3 frames of 512 (408
//     blocks) and 5.6% the slower at 10 frames of 1372 (9460 blocks), the
//     two shapes a path runs it at; where between them the two cross is
//     not measured.  The forward strides at both (measured likewise);
//   * each warp compacts the pairs of its
//     rows that lie inside the cutoff and can meet some bin (r_lo <= r <
//     r_hi over the bins' windows) into its own segment, in row-major
//     order, with the lane's columns in registers and the minimum image
//     from compares alone unless the block's sites span more than the
//     image's second threshold on an axis (positions not wrapped);
//   * every partial is written once and summed by a second small kernel
//     in a fixed order.
// Forward (rdf_partial_kernel), 64 x 64 tile pairs, 8 warps:
//   * the warps' pairs are sorted by a key, r^2 on a grid of 128 cells
//     over the live range: each warp counts its keys four a lane from the
//     ballots of the key bits, the block scans the counts over (key,
//     warp), and each warp moves its segment to its slots, a lane ranked
//     among the lanes of its key by the same ballots -- a stable counting
//     sort with no atomics, so the order, and every sum, is the same on
//     every call; the square root is taken here, for the kept pairs only;
//   * a warp takes 8 bins x 4 streams: the 8 bins' windows give one run of
//     keys, so one contiguous run of the sorted list, which the warp walks
//     with every lane reading one of 4 words at once, stream s taking
//     every 4th pair; the 4 streams of a bin are added by shuffles in a
//     fixed order.  The run holds ~1.3x the non-zero terms (the 8 windows'
//     union and the key cells at its ends);
//   * where frames x tile pairs give fewer than two blocks an SM (3 frames
//     of 512: 108 tile pairs), the groups of 8 bins are split over more
//     blocks, each repeating its tile's sort; a block takes at most 32
//     groups, so any number of bins runs.
// Backward (rdf_bwd_partial_kernel), 32 x 32 tile pairs, 4 warps (408
// blocks at 3 frames of 512, 6800 at 50):
//   * the warps' segments are joined into one list (r, pair index) in
//     row-major order, and one thread takes one pair at a time;
//   * the bins' mu, coeff, 2 ct coeff and window sit in shared memory
//     (loaded once when they fit 512, else chunk by chunk); the thread
//     sums w(r) over the bins whose window holds r -- two binary searches
//     where the windows' ends ascend with g (mu ascending, any widths that
//     keep them so), every bin where not -- in bin order;
//   * it writes (w / r) d of its pair into a dense 32 x 32 tile per axis;
//     the block then sums the tile's rows (+, for the row sites) and
//     columns (-, for the column sites) in index order and writes each
//     site's sum over this tile pair once to a (frame, tile, site)
//     scratch, which the second kernel sums in tile order.
// No float or integer atomics anywhere: both results are the same bits on
// every call, as the replay adjoint needs.  The (N, N, G) tensor is never
// built.

#include <cuda_runtime.h>

#include <algorithm>

#include "image.cuh"

namespace {

constexpr float kReachArg = 110.f;   // -coeff reach^2 (exp(-110) -> +0)
constexpr float kInf = __builtin_huge_valf();

constexpr int kFwdTile = 64;
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdRows = kFwdTile / kFwdWarps;   // rows a warp compacts
constexpr int kGroupBins = 8;                    // bins a warp walks at once
constexpr int kStreams = 32 / kGroupBins;        // pairs a warp takes at once
constexpr int kSliceGroups = 32;                 // groups a block, at most
constexpr int kSliceBins = kSliceGroups * kGroupBins;
constexpr int kTargetBlocks = 2 * 132;           // two a SM of an H100
// above this many backward blocks the tiles keep the sites' own order: a
// point between the paths' 408 and 9460 blocks (see the note at the top)
constexpr int kSpreadBlocks = 4 * kTargetBlocks;
constexpr int kKeys = 128;                       // cells of the r^2 grid
constexpr int kKeyBits = 7;
constexpr int kKeysPerLane = kKeys / 32;
static_assert(1 << kKeyBits == kKeys, "a key is kKeyBits bits");
static_assert(kSliceBins == kFwdThreads, "one thread a bin of the slice");

constexpr int kBwdTile = 32;
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRows = kBwdTile / kBwdWarps;
constexpr int kBinChunk = 512;

constexpr int kReduceThreads = 256;

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ float warp_min(float v, int from = 1) {
  for (int o = from; o < 32; o <<= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v, int from = 1) {
  for (int o = from; o < 32; o <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// [lo, hi]: outside it exp(c (r - m)^2) is +0 in float32; unbounded for
// a bin whose reach is not finite (c >= 0, c or m not finite).
__device__ __forceinline__ void bin_window(float m, float c, float& lo,
                                           float& hi) {
  const float reach = sqrtf(kReachArg / -c);
  lo = m - reach;
  hi = m + reach;
  if (!(reach < kInf) || !(lo == lo) || !(hi == hi)) {
    lo = -kInf;
    hi = kInf;
  }
}

// Block b of a triangle of tile pairs: (R, C), R <= C, b = C (C + 1) / 2
// + R.
__device__ __forceinline__ void tile_pair(int b, int& R, int& C) {
  C = static_cast<int>((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
  while ((C + 1) * (C + 2) / 2 <= b) ++C;
  while (C * (C + 1) / 2 > b) --C;
  R = b - C * (C + 1) / 2;
}

// Site u of the tiling is site u * stride mod n of the frame (stride
// coprime with n): sites that lie close together, which consecutive
// indices of a lattice or a trajectory do, are spread over all tiles, so
// every tile pair holds about as many pairs inside the cutoff and no
// block runs long.
__device__ __forceinline__ int site_of(int u, int n, int stride) {
  return static_cast<int>(static_cast<long long>(u) * stride % n);
}

// The block's sites, tiling sites [i0, i0 + kTile) then [j0, j0 + kTile)
// of the frame x, in two steps so that other loads can fly meanwhile:
// load() into registers, store() into pos[axis][site].  A site past n is
// NaN, so every r^2 with it is NaN and fails every compare.
template <int kTile, int kThreads>
struct Sites {
  static constexpr int kPer = (2 * kTile * 3 + kThreads - 1) / kThreads;
  float v[kPer];
  __device__ __forceinline__ void load(const float* __restrict__ x, int n,
                                       int stride, int i0, int j0) {
    const float nan = __int_as_float(0x7fffffff);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = threadIdx.x + u * kThreads;
      const int a = t / 3, k = t - 3 * a;
      const int p = a < kTile ? i0 + a : j0 + a - kTile;
      v[u] = t < 2 * kTile * 3 && p < n
                 ? x[3LL * site_of(p, n, stride) + k] : nan;
    }
  }
  __device__ __forceinline__ void store(float (*pos)[2 * kTile]) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (t < 2 * kTile * 3) pos[t % 3][t / 3] = v[u];
    }
  }
};

// Whether the staged sites span t2 or more on an axis, so that a pair
// may need the IEEE image (positions not wrapped); fminf and fmaxf skip
// the NaNs.  Every lane of a warp calls it and gets the answer.
template <int kTile>
__device__ __forceinline__ bool spans_far(const float (*pos)[2 * kTile],
                                          const Image& im) {
  const int lane = threadIdx.x & 31;
  const float u[3] = {im.ux, im.uy, im.uz};
  bool far = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lo = pos[k][lane], hi = lo;
    for (int q = lane + 32; q < 2 * kTile; q += 32) {
      lo = fminf(lo, pos[k][q]);
      hi = fmaxf(hi, pos[k][q]);
    }
    far |= !(warp_max(hi) - warp_min(lo) < u[k]);
  }
  return far;
}

// The live pairs of rows [a0, a0 + kRows) x the tile's columns: i < j,
// r^2 < cut_sq and lo2 <= r^2 < hi2 (a pair outside [lo2, hi2) meets no
// bin's window), in row-major order: r^2 into r2_out and, when idx is not
// null, row * kTile + column into idx.  Returns their count.  Every lane
// of the warp calls it; the rows and the lane's columns are read into
// registers first, so no shared load waits behind the list's stores.
template <bool kFar, int kTile, int kRows>
__device__ __forceinline__ int live_rows(const float (*pos)[2 * kTile],
                                         const Image& im, int a0, bool diag,
                                         float cut_sq, float lo2, float hi2,
                                         float* r2_out, unsigned short* idx) {
  constexpr int kHalves = kTile / 32;
  const int lane = threadIdx.x & 31;
  float cx[kHalves], cy[kHalves], cz[kHalves];
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    cx[h] = pos[0][kTile + 32 * h + lane];
    cy[h] = pos[1][kTile + 32 * h + lane];
    cz[h] = pos[2][kTile + 32 * h + lane];
  }
  float rx[kRows], ry[kRows], rz[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    rx[i] = pos[0][a0 + i];
    ry[i] = pos[1][a0 + i];
    rz[i] = pos[2][a0 + i];
  }
  int count = 0;
#pragma unroll
  for (int it = 0; it < kRows * kHalves; ++it) {
    const int i = it / kHalves;
    const int a = a0 + i;
    const int h = it % kHalves;
    const int b = 32 * h + lane;
    float dx, dy, dz;
    const float r2 = image_r2<kFar>(im, rx[i], ry[i], rz[i], cx[h], cy[h],
                                    cz[h], dx, dy, dz);
    const bool live =
        (!diag || a < b) && r2 < cut_sq && r2 >= lo2 && r2 < hi2;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int q = count + __popc(ballot & lanes_below());
      r2_out[q] = r2;
      if (idx != nullptr) idx[q] = static_cast<unsigned short>(a * kTile + b);
    }
    count += __popc(ballot);
  }
  return count;
}

// Moves each warp's segment (seg + warp * stride, count entries) into one
// block list in warp order, so in row-major order, as r = sqrt(r^2) (and
// the pair's index, when given); returns the list's length.  Every thread
// calls it; it ends with the block synchronised.
__device__ int gather_list(const float* seg, const unsigned short* seg_idx,
                           int stride, int count, int* warp_count,
                           float* list, unsigned short* list_idx) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < warps; ++w) {
    base += w < warp ? warp_count[w] : 0;
    total += warp_count[w];
  }
  for (int q = lane; q < count; q += 32) {
    list[base + q] = sqrtf(seg[warp * stride + q]);
    if (list_idx != nullptr) list_idx[base + q] = seg_idx[warp * stride + q];
  }
  __syncthreads();
  return total;
}

// A cell of a uniform grid of r^2 over the slice's live range (the
// square root waits for the pairs that are kept), monotone in r^2: a
// group's window ends map to the cells that bound every pair inside it.
// A NaN falls in cell 0.
struct KeyGrid {
  float lo, inv;
  __device__ __forceinline__ int operator()(float r2) const {
    return static_cast<int>(fminf(fmaxf((r2 - lo) * inv, 0.f), kKeys - 1.f));
  }
};

// The lanes of `valid` whose key has the bits of k, from the ballots of
// the keys' bits: a warp's match on a key with no atomics.
__device__ __forceinline__ unsigned lanes_of_key(const unsigned* bits,
                                                 unsigned valid, int k) {
  unsigned m = valid;
#pragma unroll
  for (int i = 0; i < kKeyBits; ++i) m &= (k >> i) & 1 ? bits[i] : ~bits[i];
  return m;
}

// One chunk of 32 entries of a warp's segment: the ballots of the live
// lanes and of their keys' bits; per lane, the count of keys lane + 32 j
// (j < kKeysPerLane) among them.
struct KeyChunk {
  unsigned valid, bits[kKeyBits];
  __device__ __forceinline__ KeyChunk(bool on, int k) {
    valid = __ballot_sync(0xffffffffu, on);
#pragma unroll
    for (int i = 0; i < kKeyBits; ++i) {
      bits[i] = __ballot_sync(0xffffffffu, (k >> i) & 1);
    }
  }
  __device__ __forceinline__ void add_counts(int* counts) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      counts[j] += __popc(lanes_of_key(bits, valid, lane + 32 * j));
    }
  }
};

// Sorts the warps' segments (seg + warp * stride: count entries of r^2,
// with their pair indices when seg_idx is not null) by key into one block
// list of r = sqrt(r^2) (and list_idx), and leaves in start[k] key k's
// first slot (start[kKeys] the total).  A stable counting sort with no
// atomics: each warp counts its keys kKeysPerLane a lane from the ballots
// of the key bits, the block scans the counts over (key, warp), and each
// warp moves its entries in order to its slots, a lane ranked among the
// lanes of its key by the same ballots; so the order is the same on every
// call.  Every thread calls it (blockDim.x >= kKeys); it ends with the
// block synchronised.  slot (warps x kKeys), warp_sum (warps): scratch.
__device__ void sort_by_key(const float* seg, const unsigned short* seg_idx,
                            int stride, int count, const KeyGrid& key,
                            int (*slot)[kKeys], int* start, int* warp_sum,
                            float* list, unsigned short* list_idx) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const float* mine = seg + warp * stride;
  int next[kKeysPerLane] = {};
  for (int q0 = 0; q0 < count; q0 += 32) {
    const bool on = q0 + lane < count;
    KeyChunk(on, on ? key(mine[q0 + lane]) : 0).add_counts(next);
  }
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) slot[warp][lane + 32 * j] = next[j];
  __syncthreads();

  // key k's first slot, and each warp's first slot within it (threads
  // below kKeys hold a key each; the others add zeros)
  int total = 0;
  if (tid < kKeys) {
    for (int w = 0; w < warps; ++w) {
      const int c = slot[w][tid];
      slot[w][tid] = total;
      total += c;
    }
  }
  int incl = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (tid < kKeys) {
    int excl = incl - total;
    for (int w = 0; w < warp; ++w) excl += warp_sum[w];
    start[tid] = excl;
    if (tid == kKeys - 1) start[kKeys] = excl + total;
    for (int w = 0; w < warps; ++w) slot[w][tid] += excl;
  }
  __syncthreads();

  // the stable fill
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) next[j] = slot[warp][lane + 32 * j];
  for (int q0 = 0; q0 < count; q0 += 32) {
    const int q = q0 + lane;
    const bool on = q < count;
    const float r2 = on ? mine[q] : 0.f;
    const int k = on ? key(r2) : 0;
    const KeyChunk chunk(on, k);
    int base = 0;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      const int v = __shfl_sync(0xffffffffu, next[j], k & 31);
      if (k >> 5 == j) base = v;
    }
    if (on) {
      const unsigned peers = lanes_of_key(chunk.bits, chunk.valid, k);
      const int at = base + __popc(peers & lanes_below());
      list[at] = sqrtf(r2);
      if (list_idx != nullptr) list_idx[at] = seg_idx[warp * stride + q];
    }
    chunk.add_counts(next);
  }
  __syncthreads();
}

// grid (tile pairs, bin slices, frames); partial[g * n_parts + part], part
// = frame * tile pairs + tile pair, written by the block whose slice holds
// g.
__global__ void __launch_bounds__(kFwdThreads) rdf_partial_kernel(
    const float* __restrict__ xyz, int n, int stride, Image im, float cut_sq,
    const float* __restrict__ mu, const float* __restrict__ coeff,
    int n_bins, int groups_per_block, float* __restrict__ partial) {
  __shared__ float pos[3][2 * kFwdTile];
  __shared__ float seg[kFwdWarps][kFwdRows * kFwdTile];   // a warp's r^2
  __shared__ float sorted_r[kFwdTile * kFwdTile];
  __shared__ float2 bins[kSliceBins];           // mu, coeff
  __shared__ float2 win[kSliceGroups];          // a group's window
  __shared__ int slot[kFwdWarps][kKeys];        // counts, then first slots
  __shared__ int start[kKeys + 1];
  __shared__ int warp_sum[kFwdWarps];
  __shared__ float red[2 * kFwdWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int R, C;
  tile_pair(blockIdx.x, R, C);
  const long long n_parts = static_cast<long long>(gridDim.x) * gridDim.z;
  const long long part =
      static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x;
  const int g0 = blockIdx.y * groups_per_block * kGroupBins;
  const int nb = min(n_bins - g0, groups_per_block * kGroupBins);
  const int n_groups = (nb + kGroupBins - 1) / kGroupBins;

  // the slice's bins and the sites, both loads in flight at once
  float m = 0.f, cf = 0.f;
  if (tid < nb) {
    m = __ldg(mu + g0 + tid);
    cf = __ldg(coeff + g0 + tid);
  }
  Sites<kFwdTile, kFwdThreads> sites;
  sites.load(xyz + static_cast<long long>(blockIdx.z) * n * 3, n, stride,
             R * kFwdTile, C * kFwdTile);
  // each group's window (its bins' least lo, greatest hi), the slice's
  float lo = kInf, hi = -kInf;
  if (tid < nb) {
    bins[tid] = make_float2(m, cf);
    bin_window(m, cf, lo, hi);
  }
  for (int o = 1; o < kGroupBins; o <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (tid % kGroupBins == 0 && tid < nb) {
    win[tid / kGroupBins] = make_float2(fmaxf(lo, 0.f), hi);
  }
  lo = warp_min(lo, kGroupBins);
  hi = warp_max(hi, kGroupBins);
  if (lane == 0) {
    red[warp] = lo;
    red[kFwdWarps + warp] = hi;
  }
  sites.store(pos);
  __syncthreads();
  float r_lo = red[0], r_hi = red[kFwdWarps];
  for (int w = 1; w < kFwdWarps; ++w) {
    r_lo = fminf(r_lo, red[w]);
    r_hi = fmaxf(r_hi, red[kFwdWarps + w]);
  }
  r_lo = fmaxf(r_lo, 0.f);
  const float lo2 = r_lo * r_lo, hi2 = r_hi * r_hi;
  const float top2 = fminf(hi2, cut_sq);
  const KeyGrid key{lo2, top2 > lo2 ? kKeys / (top2 - lo2) : 0.f};
  const bool far = spans_far<kFwdTile>(pos, im);

  // 1. this warp's rows: the live pairs' r^2, row-major, sorted by key
  const bool diag = R == C;
  float* mine = seg[warp];
  const int count =
      far ? live_rows<true, kFwdTile, kFwdRows>(pos, im, warp * kFwdRows,
                                                diag, cut_sq, lo2, hi2, mine,
                                                nullptr)
          : live_rows<false, kFwdTile, kFwdRows>(pos, im, warp * kFwdRows,
                                                 diag, cut_sq, lo2, hi2,
                                                 mine, nullptr);
  __syncwarp();
  sort_by_key(&seg[0][0], nullptr, kFwdRows * kFwdTile, count, key, slot,
              start, warp_sum, sorted_r, nullptr);

  // 2. kGroupBins bins x kStreams streams a warp, over the run of keys the
  // group's window covers, stream s taking every kStreams-th pair
  const int sub = lane % kGroupBins;
  const int stream = lane / kGroupBins;
  for (int grp = warp; grp < n_groups; grp += kFwdWarps) {
    const int g = grp * kGroupBins + sub;
    const float2 w = win[grp];
    const int q_end = start[key(w.y * w.y) + 1];
    float acc = 0.f;
    if (g < nb) {
      const float2 b = bins[g];
#pragma unroll 4
      for (int q = start[key(w.x * w.x)] + stream; q < q_end;
           q += kStreams) {
        const float d = sorted_r[q] - b.x;
        acc += expf(b.y * (d * d));
      }
    }
    for (int o = kGroupBins; o < 32; o <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (stream == 0 && g < nb) partial[(g0 + g) * n_parts + part] = acc;
  }
}


__global__ void rdf_reduce_kernel(const float* __restrict__ partial,
                                  long long n_parts, float* __restrict__ out) {
  __shared__ float s[kReduceThreads];
  const long long g = blockIdx.x;
  float acc = 0.f;
  for (long long p = threadIdx.x; p < n_parts; p += kReduceThreads) {
    acc += partial[g * n_parts + p];
  }
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[g] = s[0];
}

// Over every bin: r_lo = max(0, least lo), r_hi = greatest hi, and
// whether lo and hi never decrease with g.  Every thread calls it; it
// ends with the block synchronised.  min and max are exact in any order.
__device__ bool bins_range(const float* __restrict__ mu,
                           const float* __restrict__ coeff, int n_bins,
                           float* red, float& r_lo, float& r_hi) {
  const int warps = blockDim.x >> 5;
  float lo_min = kInf, hi_max = -kInf;
  bool asc = true;
  for (int g = threadIdx.x; g < n_bins; g += blockDim.x) {
    float lo, hi;
    bin_window(__ldg(mu + g), __ldg(coeff + g), lo, hi);
    lo_min = fminf(lo_min, lo);
    hi_max = fmaxf(hi_max, hi);
    if (g > 0) {
      float lo0, hi0;
      bin_window(__ldg(mu + g - 1), __ldg(coeff + g - 1), lo0, hi0);
      asc = asc && lo0 <= lo && hi0 <= hi;
    }
  }
  lo_min = warp_min(lo_min);
  hi_max = warp_max(hi_max);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = lo_min;
    red[warps + (threadIdx.x >> 5)] = hi_max;
  }
  const bool ascending = __syncthreads_and(asc);
  lo_min = red[0];
  hi_max = red[warps];
  for (int w = 1; w < warps; ++w) {
    lo_min = fminf(lo_min, red[w]);
    hi_max = fmaxf(hi_max, red[warps + w]);
  }
  r_lo = fmaxf(lo_min, 0.f);
  r_hi = hi_max;
  __syncthreads();
  return ascending;
}

// Bin g's {mu, coeff, 2 ct coeff, 0} and window.
__device__ __forceinline__ void load_bin(const float* __restrict__ mu,
                                         const float* __restrict__ coeff,
                                         const float* __restrict__ ct, int g,
                                         float4& param, float2& window) {
  const float m = __ldg(mu + g);
  const float cf = __ldg(coeff + g);
  param = make_float4(m, cf, __ldg(ct + g) * 2.f * cf, 0.f);
  float lo, hi;
  bin_window(m, cf, lo, hi);
  window = make_float2(lo, hi);
}

// first index in [0, n) where pred turns true, for a pred that is false
// then true along the indices
template <typename Pred>
__device__ __forceinline__ int first_true(int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(mid)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// grid (tile pairs, frames); dynamic shared memory: min(n_bins,
// kBinChunk) x (float4 params, float2 window).  partial (frames, tiles,
// n, 3): site p of tiling tile P gets in slot Q its sum over the pairs
// with tile Q, written once, by block (P, Q) or (Q, P).
__global__ void __launch_bounds__(kBwdThreads) rdf_bwd_partial_kernel(
    const float* __restrict__ xyz, int n, int stride, Image im, float cut_sq,
    const float* __restrict__ mu, const float* __restrict__ coeff,
    const float* __restrict__ ct, int n_bins, int tiles,
    float* __restrict__ partial) {
  extern __shared__ float4 params[];   // {mu, coeff, 2 ct coeff, 0}
  __shared__ float pos[3][2 * kBwdTile];
  // the warps' r^2, then w of each listed pair over the chunks so far
  __shared__ float scratch[kBwdTile * kBwdTile];
  __shared__ unsigned short seg_idx[kBwdTile * kBwdTile];
  __shared__ float list[kBwdTile * kBwdTile];   // r of the live pairs
  __shared__ unsigned short list_idx[kBwdTile * kBwdTile];
  __shared__ float tile[3][kBwdTile][kBwdTile + 1];   // +1: no conflicts
  __shared__ float red[2 * kBwdWarps];
  __shared__ int warp_count[kBwdWarps];
  const int chunk = min(n_bins, kBinChunk);
  float2* window = reinterpret_cast<float2*>(params + chunk);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  int R, C;
  tile_pair(blockIdx.x, R, C);
  const int f = blockIdx.y;
  const int i0 = R * kBwdTile, j0 = C * kBwdTile;
  Sites<kBwdTile, kBwdThreads> sites;
  sites.load(xyz + static_cast<long long>(f) * n * 3, n, stride, i0, j0);
  for (int t = tid; t < 3 * kBwdTile * (kBwdTile + 1); t += kBwdThreads) {
    (&tile[0][0][0])[t] = 0.f;
  }
  // the bins: every one at once in shared memory when they fit one chunk
  // (their range and order from there), else their range and order from
  // device memory and the chunks one by one below
  const bool one_chunk = n_bins <= kBinChunk;
  float r_lo, r_hi;
  bool ascending;
  if (one_chunk) {
    float lo_min = kInf, hi_max = -kInf;
    for (int g = tid; g < n_bins; g += kBwdThreads) {
      load_bin(mu, coeff, ct, g, params[g], window[g]);
      lo_min = fminf(lo_min, window[g].x);
      hi_max = fmaxf(hi_max, window[g].y);
    }
    lo_min = warp_min(lo_min);
    hi_max = warp_max(hi_max);
    if ((tid & 31) == 0) {
      red[warp] = lo_min;
      red[kBwdWarps + warp] = hi_max;
    }
    sites.store(pos);
    __syncthreads();
    bool asc = true;
    for (int g = tid + 1; g < n_bins; g += kBwdThreads) {
      asc = asc && window[g - 1].x <= window[g].x &&
            window[g - 1].y <= window[g].y;
    }
    ascending = __syncthreads_and(asc);
    r_lo = red[0];
    r_hi = red[kBwdWarps];
    for (int w = 1; w < kBwdWarps; ++w) {
      r_lo = fminf(r_lo, red[w]);
      r_hi = fmaxf(r_hi, red[kBwdWarps + w]);
    }
    r_lo = fmaxf(r_lo, 0.f);
  } else {
    ascending = bins_range(mu, coeff, n_bins, red, r_lo, r_hi);
    sites.store(pos);
    __syncthreads();
  }
  const bool far = spans_far<kBwdTile>(pos, im);

  // the tile's live pairs (i < j), row-major, as one list of (r, index)
  const bool diag = R == C;
  constexpr int kSeg = kBwdRows * kBwdTile;
  const float lo2 = r_lo * r_lo, hi2 = r_hi * r_hi;
  const int count =
      far ? live_rows<true, kBwdTile, kBwdRows>(
                pos, im, warp * kBwdRows, diag, cut_sq, lo2, hi2,
                scratch + warp * kSeg, seg_idx + warp * kSeg)
          : live_rows<false, kBwdTile, kBwdRows>(
                pos, im, warp * kBwdRows, diag, cut_sq, lo2, hi2,
                scratch + warp * kSeg, seg_idx + warp * kSeg);
  const int total = gather_list(scratch, seg_idx, kSeg, count, warp_count,
                                list, list_idx);

  // w(r) of each pair over the bins, chunk by chunk, in bin order: one
  // thread a pair, over the bins whose window holds r -- two binary
  // searches where the windows' ends ascend with g, every bin where not
  for (int c0 = 0; c0 < n_bins; c0 += chunk) {
    const int cn = min(chunk, n_bins - c0);
    if (!one_chunk) {
      __syncthreads();   // the last chunk is used up
      for (int g = tid; g < cn; g += kBwdThreads) {
        load_bin(mu + c0, coeff + c0, ct + c0, g, params[g], window[g]);
      }
      __syncthreads();
    }
    const bool last = c0 + cn >= n_bins;
    for (int q = tid; q < total; q += kBwdThreads) {
      const float r = list[q];
      int g0 = 0, g1 = cn;
      if (ascending) {
        g0 = first_true(cn, [&](int g) { return window[g].y > r; });
        g1 = first_true(cn, [&](int g) { return window[g].x >= r; });
      }
      float w = c0 == 0 ? 0.f : scratch[q];
#pragma unroll 4
      for (int g = g0; g < g1; ++g) {
        const float4 p = params[g];
        const float d = r - p.x;
        w = fmaf(p.z * d, expf(p.y * (d * d)), w);
      }
      if (!last) {
        scratch[q] = w;
        continue;
      }
      const int ab = list_idx[q];
      const int a = ab / kBwdTile, c = ab % kBwdTile;
      float dx, dy, dz;
      if (far) {
        image_r2<true>(im, pos[0][a], pos[1][a], pos[2][a],
                       pos[0][kBwdTile + c], pos[1][kBwdTile + c],
                       pos[2][kBwdTile + c], dx, dy, dz);
      } else {
        image_r2<false>(im, pos[0][a], pos[1][a], pos[2][a],
                        pos[0][kBwdTile + c], pos[1][kBwdTile + c],
                        pos[2][kBwdTile + c], dx, dy, dz);
      }
      const float s = w / r;
      tile[0][a][c] = s * dx;
      tile[1][a][c] = s * dy;
      tile[2][a][c] = s * dz;
    }
  }
  __syncthreads();

  // rows (+) for the row sites, columns (-) for the column sites; on a
  // diagonal block both are the same sites: row - column, slot R
  for (int t = tid; t < 2 * 3 * kBwdTile; t += kBwdThreads) {
    const bool col_side = t >= 3 * kBwdTile;
    if (diag && col_side) break;
    const int u = col_side ? t - 3 * kBwdTile : t;
    const int k = u / kBwdTile, a = u % kBwdTile;
    const int v = (col_side ? j0 : i0) + a;
    if (v >= n) continue;
    const int p = site_of(v, n, stride);
    float rows = 0.f, cols = 0.f;
    if (!col_side) {
      for (int c = 0; c < kBwdTile; ++c) rows += tile[k][a][c];
    }
    if (col_side || diag) {
      for (int c = 0; c < kBwdTile; ++c) cols += tile[k][c][a];
    }
    const int other = col_side ? R : C;
    partial[((static_cast<long long>(f) * tiles + other) * n + p) * 3 + k] =
        diag ? rows - cols : (col_side ? -cols : rows);
  }
}

__global__ void rdf_bwd_reduce_kernel(const float* __restrict__ partial,
                                      int n_frames, int n, int tiles,
                                      float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long per_frame = static_cast<long long>(n) * 3;
  if (e >= per_frame * n_frames) return;
  const long long f = e / per_frame;
  const long long rem = e - f * per_frame;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) {
    acc += partial[(f * tiles + t) * per_frame + rem];
  }
  out[e] = acc;
}

long long tile_pairs(int n, int tile) {
  const long long tiles = (n + tile - 1) / tile;
  return tiles * (tiles + 1) / 2;
}

// The forward's bin slices: (slices, groups a slice), at most
// kSliceGroups groups a slice, and so many slices that tile pairs x
// frames x slices reaches kTargetBlocks where the bins allow.
void bin_slices(int n_frames, int n, int n_bins, int& slices, int& per) {
  const long long blocks = tile_pairs(n, kFwdTile) * n_frames;
  const int n_groups = (n_bins + kGroupBins - 1) / kGroupBins;
  long long want = (kTargetBlocks + blocks - 1) / blocks;
  want = std::max<long long>(want, (n_groups + kSliceGroups - 1) /
                                       kSliceGroups);
  slices = static_cast<int>(std::min<long long>(want, n_groups));
  per = (n_groups + slices - 1) / slices;
  slices = (n_groups + per - 1) / per;
}

// The tiling's stride (site_of): the integer nearest 0.618 n that is
// coprime with n.
int site_stride(int n) {
  int s = static_cast<int>(0.6180339887 * n + 0.5);
  if (s < 1) s = 1;
  for (;; ++s) {
    int a = s, b = n;
    while (b != 0) {
      const int t = a % b;
      a = b;
      b = t;
    }
    if (a == 1) return s;
  }
}

bool bad_shape(int n_frames, int n, int n_bins) {
  return n_frames < 1 || n < 1 || n_bins < 1 || n_frames > 65535 ||
         tile_pairs(n, kBwdTile) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// kReachArg, so that the ops module's reach (ops/rdf.py REACH_ARG) can be
// held to the kernels' own.
float mdg_rdf_reach_arg() { return kReachArg; }

// float32 scratch (partial sums) one call needs: the forward's
// (backward = 0) or the backward's (backward = 1); -1 for a bad shape.
long long mdg_rdf_scratch(int n_frames, int n, int n_bins, int backward) {
  if (bad_shape(n_frames, n, n_bins)) return -1;
  if (backward) {
    return static_cast<long long>(n_frames) * ((n + kBwdTile - 1) / kBwdTile) *
           n * 3;
  }
  return tile_pairs(n, kFwdTile) * n_frames * n_bins;
}

// xyz: (n_frames, n, 3) f32; lx, ly, lz the diagonal cell, tx, ty, tz and
// ux, uy, uz each axis's image thresholds t1 and t2 (image.cuh); mu,
// coeff: (n_bins,) f32, any n_bins >= 1; partial: mdg_rdf_scratch(...,
// 0) f32; out: (n_bins,) f32, counts summed over frames.
int mdg_rdf_counts(const float* xyz, int n_frames, int n, float lx, float ly,
                   float lz, float tx, float ty, float tz, float ux, float uy,
                   float uz, float cutoff, const float* mu, const float* coeff,
                   int n_bins, float* partial, float* out, void* stream) {
  if (bad_shape(n_frames, n, n_bins)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int slices, per;
  bin_slices(n_frames, n, n_bins, slices, per);
  const long long pairs = tile_pairs(n, kFwdTile);
  rdf_partial_kernel<<<dim3(static_cast<unsigned>(pairs), slices, n_frames),
                       kFwdThreads, 0, s>>>(
      xyz, n, site_stride(n), Image{lx, ly, lz, tx, ty, tz, ux, uy, uz},
      cutoff * cutoff, mu, coeff, n_bins, per, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rdf_reduce_kernel<<<n_bins, kReduceThreads, 0, s>>>(partial,
                                                      pairs * n_frames, out);
  return static_cast<int>(cudaGetLastError());
}

// xyz: (n_frames, n, 3) f32; the cell and thresholds as above; mu, coeff,
// ct: (n_bins,) f32, ct the cotangent of the frame-summed counts;
// partial: mdg_rdf_scratch(..., 1) f32; out: (n_frames, n, 3) f32,
// d(ct . counts) / d xyz.
int mdg_rdf_counts_bwd(const float* xyz, int n_frames, int n, float lx,
                       float ly, float lz, float tx, float ty, float tz,
                       float ux, float uy, float uz, float cutoff,
                       const float* mu, const float* coeff, const float* ct,
                       int n_bins, float* partial, float* out, void* stream) {
  if (bad_shape(n_frames, n, n_bins)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kBwdTile - 1) / kBwdTile;
  const int chunk = n_bins < kBinChunk ? n_bins : kBinChunk;
  const size_t shared = static_cast<size_t>(chunk) *
                        (sizeof(float4) + sizeof(float2));
  const long long pairs = tile_pairs(n, kBwdTile);
  const long long spread_blocks = pairs * n_frames;
  rdf_bwd_partial_kernel<<<dim3(static_cast<unsigned>(pairs), n_frames),
                           kBwdThreads, shared, s>>>(
      xyz, n, spread_blocks > kSpreadBlocks ? 1 : site_stride(n),
      Image{lx, ly, lz, tx, ty, tz, ux, uy, uz}, cutoff * cutoff, mu, coeff,
      ct, n_bins, tiles, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(n_frames) * n * 3;
  const int blocks = static_cast<int>((total + kReduceThreads - 1) /
                                      kReduceThreads);
  rdf_bwd_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      partial, n_frames, n, tiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
