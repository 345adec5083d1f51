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
// d - rint(d / L) L of the TPU kernels (its 1/2-weighted full i != j
// forward sum is the same number as the i < j sum here; in the backward
// both orderings of a pair count, with no 1/2).
//
// What bounds both on the card: the exponentials, on the SFU, one expf
// per (i < j pair inside the cutoff, bin) -- also in the backward, since
// w(r_ij) = w(r_ji) and each i < j pair adds +-w/r d_ij to both sites -- so
// the work depends on the data (about 18k of the 131k i < j pairs of a
// 512-site water frame lie inside 8 A).  Bytes are negligible (12 B per
// site).  The backward below spends one expf per ORDERED pair, twice its
// bound, to keep each row's sum in one block; the i < j half needs a
// deterministic two-sided reduction.
// Design, shared by both:
//   * grid (column tile, row tile, frame); a block owns one 64 x 64 tile
//     of one frame and stages both position tiles in shared memory;
//   * phase 1: the block's threads compute the 4096 tile distances and
//     compact those inside the cutoff into a shared list, in a fixed order
//     (warp ballots plus a per-warp prefix), so no exp is spent on a pair
//     outside the cutoff.
// Forward:
//   * the block skips at once a tile that holds no i < j pair;
//   * phase 2: one thread per bin walks the list (every thread reads the
//     same shared word: a broadcast, no bank conflict, and a uniform loop
//     trip count) and keeps its bin's sum in a register;
//   * each block writes its G partial sums; a second small kernel adds the
//     partials of every tile and frame per bin with a fixed-order tree.
// Backward:
//   * no tile is skipped: every tile holds ordered pairs, and tiling the
//     columns as well as the rows gives F x 64 blocks at N = 512 (192 at
//     the 3 training frames) for the 132 SMs, not F x 8;
//   * phase 2: one thread per listed pair walks the G bins (the bin
//     parameters are the same word for every thread of a warp: a
//     broadcast) and writes w(r) / r into a dense 64 x 64 shared tile;
//   * phase 3: one thread per (row, coordinate) sums its row of that tile
//     times the recomputed displacement, in column order, and writes the
//     row's partial for this column tile;
//   * a second small kernel adds the column tiles' partials of each (frame,
//     site, coordinate) in tile order.
// This replaces the TPU's sequential-grid scratch carry; every sum is taken
// in a fixed order (no atomics), so both results are deterministic run to
// run, as the replay adjoint needs.  The (N, N, G) tensor is never built.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kReduceThreads = 256;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float min_image(float d, float L) {
  return d - rintf(d / L) * L;
}

// Stages the position tiles [i0, i0 + kTile) and [j0, j0 + kTile) of the
// frame x, then compacts the tile's pairs (a, b) inside the cutoff -- with
// i0 + a < j0 + b when `upper`, else i0 + a != j0 + b -- in row-major
// order: their distances into r_list and, when p_list is not null, a *
// kTile + b into p_list.  Returns the count.  Every thread of the block
// calls it; it ends with the block synchronised.
__device__ int compact_tile(const float* __restrict__ x, int n, int i0,
                            int j0, float lx, float ly, float lz,
                            float cut_sq, bool upper, float (*rows)[3],
                            float (*cols)[3], float* r_list,
                            unsigned short* p_list, int* warp_count,
                            int* n_valid) {
  const int tid = threadIdx.x;
  for (int t = tid; t < kTile * 3; t += blockDim.x) {
    const int a = t / 3;
    const int c = t - 3 * a;
    rows[a][c] = (i0 + a < n) ? x[static_cast<long long>(i0 + a) * 3 + c] : 0.f;
    cols[a][c] = (j0 + a < n) ? x[static_cast<long long>(j0 + a) * 3 + c] : 0.f;
  }
  if (tid == 0) *n_valid = 0;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int p0 = 0; p0 < kTile * kTile; p0 += blockDim.x) {
    const int p = p0 + tid;
    const int a = p / kTile;
    const int b = p - a * kTile;
    const int i = i0 + a;
    const int j = j0 + b;
    bool valid = false;
    float r = 0.f;
    if (p < kTile * kTile && i < n && j < n && (upper ? i < j : i != j)) {
      const float dx = min_image(cols[b][0] - rows[a][0], lx);
      const float dy = min_image(cols[b][1] - rows[a][1], ly);
      const float dz = min_image(cols[b][2] - rows[a][2], lz);
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 < cut_sq) {
        valid = true;
        r = sqrtf(r2);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = *n_valid;
    for (int w = 0; w < warp; ++w) offset += warp_count[w];
    if (valid) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      r_list[slot] = r;
      if (p_list != nullptr) p_list[slot] = static_cast<unsigned short>(p);
    }
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < n_warps; ++w) s += warp_count[w];
      *n_valid += s;
    }
    __syncthreads();
  }
  return *n_valid;
}

__global__ void rdf_partial_kernel(
    const float* __restrict__ xyz, int n, float lx, float ly, float lz,
    float cut_sq, const float* __restrict__ mu,
    const float* __restrict__ coeff, int n_bins, float* __restrict__ partial) {
  __shared__ float rows[kTile][3];
  __shared__ float cols[kTile][3];
  __shared__ float r_list[kTile * kTile];
  __shared__ int warp_count[32];
  __shared__ int n_valid;

  const int tid = threadIdx.x;
  const long long n_parts =
      static_cast<long long>(gridDim.x) * gridDim.y * gridDim.z;
  const long long part =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
          gridDim.x + blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  // every column index <= every row index: no i < j pair in this tile
  if (j0 + kTile - 1 <= i0) {
    for (int g = tid; g < n_bins; g += blockDim.x) {
      partial[g * n_parts + part] = 0.f;
    }
    return;
  }

  const float* x = xyz + static_cast<long long>(blockIdx.z) * n * 3;
  const int count = compact_tile(x, n, i0, j0, lx, ly, lz, cut_sq, true,
                                 rows, cols, r_list, nullptr, warp_count,
                                 &n_valid);
  for (int g = tid; g < n_bins; g += blockDim.x) {
    const float m = mu[g];
    const float cf = coeff[g];
    float acc = 0.f;
    for (int q = 0; q < count; ++q) {
      const float d = r_list[q] - m;
      acc += expf(cf * (d * d));
    }
    partial[g * n_parts + part] = acc;
  }
}

__global__ void rdf_reduce_kernel(const float* __restrict__ partial,
                                  long long n_parts, float* __restrict__ out) {
  __shared__ float s[kReduceThreads];
  const int g = blockIdx.x;
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

// partial: (n_frames, column tiles, n, 3); block (column tile, row tile,
// frame) writes rows [i0, i0 + kTile) of its (frame, column tile) slab.
__global__ void rdf_bwd_partial_kernel(
    const float* __restrict__ xyz, int n, float lx, float ly, float lz,
    float cut_sq, const float* __restrict__ mu,
    const float* __restrict__ coeff, const float* __restrict__ ct,
    int n_bins, float* __restrict__ partial) {
  // 42.9 KB in all, under the 48 KB of static shared memory
  __shared__ float rows[kTile][3];
  __shared__ float cols[kTile][3];
  __shared__ float r_list[kTile * kTile];
  __shared__ unsigned short p_list[kTile * kTile];
  __shared__ float coef[kTile][kTile + 1];   // +1: rows on distinct banks
  __shared__ int warp_count[32];
  __shared__ int n_valid;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float* x = xyz + static_cast<long long>(blockIdx.z) * n * 3;

  for (int t = tid; t < kTile * (kTile + 1); t += blockDim.x) {
    (&coef[0][0])[t] = 0.f;
  }
  const int count = compact_tile(x, n, i0, j0, lx, ly, lz, cut_sq, false,
                                 rows, cols, r_list, p_list, warp_count,
                                 &n_valid);

  for (int q = tid; q < count; q += blockDim.x) {
    const float r = r_list[q];
    float w = 0.f;
    for (int g = 0; g < n_bins; ++g) {
      const float cf = __ldg(coeff + g);
      const float d = r - __ldg(mu + g);
      w = fmaf(__ldg(ct + g) * 2.f * cf * d, expf(cf * (d * d)), w);
    }
    const int p = p_list[q];
    coef[p / kTile][p % kTile] = w / r;
  }
  __syncthreads();

  if (tid < kTile * 3) {
    const int a = tid % kTile;
    const int c = tid / kTile;
    const float L = c == 0 ? lx : (c == 1 ? ly : lz);
    const float xa = rows[a][c];
    float acc = 0.f;
    for (int b = 0; b < kTile; ++b) {
      acc = fmaf(coef[a][b], min_image(xa - cols[b][c], L), acc);
    }
    if (i0 + a < n) {
      const long long slab =
          static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x;
      partial[(slab * n + i0 + a) * 3 + c] = acc;
    }
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

}  // namespace

extern "C" {

int mdg_rdf_tile() { return kTile; }

// xyz: (n_frames, n, 3) f32; mu, coeff: (n_bins,) f32;
// partial: n_bins * n_frames * tiles^2 f32 scratch, tiles = ceil(n / kTile);
// out: (n_bins,) f32, counts summed over frames.
int mdg_rdf_counts(const float* xyz, int n_frames, int n, float lx, float ly,
                   float lz, float cutoff, const float* mu, const float* coeff,
                   int n_bins, float* partial, float* out, void* stream) {
  if (n_bins < 1 || n_bins > 1024 || n_frames < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  rdf_partial_kernel<<<dim3(tiles, tiles, n_frames), threads, 0, s>>>(
      xyz, n, lx, ly, lz, cutoff * cutoff, mu, coeff, n_bins, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_parts = static_cast<long long>(tiles) * tiles * n_frames;
  rdf_reduce_kernel<<<n_bins, kReduceThreads, 0, s>>>(partial, n_parts, out);
  return static_cast<int>(cudaGetLastError());
}

// xyz: (n_frames, n, 3) f32; mu, coeff, ct: (n_bins,) f32, ct the
// cotangent of the frame-summed counts;
// partial: n_frames * tiles * n * 3 f32 scratch, tiles = ceil(n / kTile);
// out: (n_frames, n, 3) f32, d(ct . counts) / d xyz.
int mdg_rdf_counts_bwd(const float* xyz, int n_frames, int n, float lx,
                       float ly, float lz, float cutoff, const float* mu,
                       const float* coeff, const float* ct, int n_bins,
                       float* partial, float* out, void* stream) {
  if (n_bins < 1 || n_frames < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  rdf_bwd_partial_kernel<<<dim3(tiles, tiles, n_frames), kBwdThreads, 0,
                           s>>>(xyz, n, lx, ly, lz, cutoff * cutoff, mu,
                                coeff, ct, n_bins, partial);
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
