// Soft-histogram RDF counts over F >= 1 frames on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mdgrad_tpu/ops/pallas_rdf.py:
//   counts        (_fwd_kernel,        "K3", one frame)
//   counts.frames (_fwd_kernel_frames, "K4", summed over frames)
// as ONE kernel with a frame axis:
//   counts[g] = sum_f sum_{i<j, r_ij < cutoff} exp(coeff_g (r_ij - mu_g)^2)
// with the diagonal-cell minimum image d - rint(d / L) L of the TPU kernel
// (its 1/2-weighted full i != j sum is the same number as this i < j sum).
//
// What bounds it on the card: the exponentials.  Each pair inside the
// cutoff costs one expf per bin, so the work depends on the data (about
// 18k of the 131k pairs of a 512-site water frame lie inside 8 A).  Bytes
// are negligible (12 B per site).  Design:
//   * grid (column tile, row tile, frame); a block owns one 64 x 64 tile
//     of one frame, stages both position tiles in shared memory, and skips
//     at once a tile that holds no i < j pair;
//   * phase 1: the block's threads compute the 4096 tile distances and
//     compact those inside the cutoff into a shared list, in a fixed order
//     (warp ballots plus a per-warp prefix), so no exp is spent on a pair
//     outside the cutoff;
//   * phase 2: one thread per bin walks that list (every thread reads the
//     same shared word: a broadcast, no bank conflict, and a uniform loop
//     trip count) and keeps its bin's sum in a register;
//   * each block writes its G partial sums; a second small kernel adds the
//     partials of every tile and frame per bin with a fixed-order tree.
// This replaces the TPU's sequential-grid scratch carry, and the sum is
// deterministic (no atomics).  The (N, N, G) tensor is never built.
//
// Forward only: the backward kernels (pallas_rdf _bwd_kernel and
// _bwd_kernel_frames) belong to the training slice.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kReduceThreads = 256;

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
  for (int t = tid; t < kTile * 3; t += blockDim.x) {
    const int a = t / 3;
    const int c = t - 3 * a;
    rows[a][c] = (i0 + a < n) ? x[static_cast<long long>(i0 + a) * 3 + c] : 0.f;
    cols[a][c] = (j0 + a < n) ? x[static_cast<long long>(j0 + a) * 3 + c] : 0.f;
  }
  if (tid == 0) n_valid = 0;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int p0 = 0; p0 < kTile * kTile; p0 += blockDim.x) {
    const int p = p0 + tid;
    const int a = p / kTile;
    const int b = p - a * kTile;
    bool valid = false;
    float r = 0.f;
    if (p < kTile * kTile && i0 + a < j0 + b && j0 + b < n) {
      float dx = cols[b][0] - rows[a][0];
      float dy = cols[b][1] - rows[a][1];
      float dz = cols[b][2] - rows[a][2];
      dx -= rintf(dx / lx) * lx;
      dy -= rintf(dy / ly) * ly;
      dz -= rintf(dz / lz) * lz;
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 < cut_sq) {
        valid = true;
        r = sqrtf(r2);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = n_valid;
    for (int w = 0; w < warp; ++w) offset += warp_count[w];
    if (valid) r_list[offset + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < n_warps; ++w) s += warp_count[w];
      n_valid += s;
    }
    __syncthreads();
  }

  const int count = n_valid;
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

}  // extern "C"
