// Neighbor-table gather, scatter and fused gather-multiply-reduce for the
// SchNet table aggregation on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mdgrad_tpu/ops/pallas_gather.py:
//   mdg_gather_mul_reduce  <- gather_mul_reduce (_gmr_kernel)     "K1"
//   mdg_table_gather       <- table_gather      (_gather_kernel)  "K2a"
//   mdg_table_scatter      <- table_scatter     (_scatter_kernel) "K2b"
//
// The TPU kernels build a one-hot tile in VMEM and contract it on the MXU
// (with a bf16 hi/lo split for ~f32 accuracy).  On Hopper the gather is a
// plain indexed load: every kernel here is exact f32, memory-bound, and
// reads the edge tensor once with neighbouring threads on neighbouring
// features (coalesced 128-byte rows).  The (N, F) node table is small
// (256 KB at N=512, F=128) and stays in L2 across the K re-reads.
//
// Index convention (shared with the Python plain versions): an index
// outside [0, n_values) is the padding sentinel -- it gathers a zero row
// and is dropped by the scatter.
//
// The scatter is the transpose of the gather.  Float atomics would make it
// run-to-run nondeterministic, so it reads a CSR inverse of the index
// (built once per neighbor-table refresh in Python: a stable argsort plus
// row pointers) and each output row sums its incoming edges in ascending
// edge order, which is deterministic.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is raised by the Python wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 2;

__global__ void gather_mul_reduce_kernel(
    const float* __restrict__ values, const float* __restrict__ w,
    const int* __restrict__ idx, float* __restrict__ out,
    int n_values, int n_out, int k, int f) {
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n_out) return;
  const long long e0 = static_cast<long long>(i) * k;
  for (int c = threadIdx.x; c < f; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < k; ++s) {
      const int j = __ldg(idx + e0 + s);
      if (static_cast<unsigned>(j) < static_cast<unsigned>(n_values)) {
        acc = fmaf(__ldg(values + static_cast<long long>(j) * f + c),
                   __ldg(w + (e0 + s) * f + c), acc);
      }
    }
    out[static_cast<long long>(i) * f + c] = acc;
  }
}

__global__ void table_gather_kernel(
    const float* __restrict__ values, const int* __restrict__ idx,
    float* __restrict__ out, int n_values, int n_edges, int f) {
  const int e = blockIdx.x * blockDim.y + threadIdx.y;
  if (e >= n_edges) return;
  const int j = __ldg(idx + e);
  const bool real = static_cast<unsigned>(j) < static_cast<unsigned>(n_values);
  float* dst = out + static_cast<long long>(e) * f;
  const float* src = values + static_cast<long long>(real ? j : 0) * f;
  for (int c = threadIdx.x; c < f; c += blockDim.x) {
    dst[c] = real ? __ldg(src + c) : 0.f;
  }
}

__global__ void table_scatter_kernel(
    const float* __restrict__ g, const int* __restrict__ order,
    const int* __restrict__ rowptr, float* __restrict__ out,
    int n_out, int f) {
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n_out) return;
  const int p0 = __ldg(rowptr + i);
  const int p1 = __ldg(rowptr + i + 1);
  for (int c = threadIdx.x; c < f; c += blockDim.x) {
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      acc += __ldg(g + static_cast<long long>(__ldg(order + p)) * f + c);
    }
    out[static_cast<long long>(i) * f + c] = acc;
  }
}

dim3 feature_block(int f) {
  // threads over the feature axis (a multiple of the warp, at most 128),
  // kRowsPerBlock output rows per block
  int tx = ((f + 31) / 32) * 32;
  if (tx > 128) tx = 128;
  return dim3(tx, kRowsPerBlock);
}

}  // namespace

extern "C" {

const char* mdg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mdg_gather_mul_reduce(const float* values, const float* w, const int* idx,
                          float* out, int n_values, int n_out, int k, int f,
                          void* stream) {
  if (n_out == 0) return 0;
  const dim3 block = feature_block(f);
  const dim3 grid((n_out + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_mul_reduce_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      values, w, idx, out, n_values, n_out, k, f);
  return static_cast<int>(cudaGetLastError());
}

int mdg_table_gather(const float* values, const int* idx, float* out,
                     int n_values, int n_edges, int f, void* stream) {
  if (n_edges == 0) return 0;
  const dim3 block = feature_block(f);
  const dim3 grid((n_edges + kRowsPerBlock - 1) / kRowsPerBlock);
  table_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      values, idx, out, n_values, n_edges, f);
  return static_cast<int>(cudaGetLastError());
}

int mdg_table_scatter(const float* g, const int* order, const int* rowptr,
                      float* out, int n_out, int f, void* stream) {
  if (n_out == 0) return 0;
  const dim3 block = feature_block(f);
  const dim3 grid((n_out + kRowsPerBlock - 1) / kRowsPerBlock);
  table_scatter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      g, order, rowptr, out, n_out, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
