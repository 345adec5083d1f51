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
// run-to-run nondeterministic, so it reads a CSR inverse of the index and
// each output row sums its incoming edges in ascending edge order, which
// is deterministic.  The inverse is built on the card, once per
// TableIndex (once per SchNet energy on the MD path), by
// mdg_table_index_csr, integer-equal to a stable argsort of the
// sentinel-mapped index (the plain build in ops/gather.py).  Its bound is
// bytes, 4E in and 4E + 4(n + 1) out (0.05 us at the water shape), but at
// these sizes it is bound by latency, so one block does it all in one
// launch: a stable counting sort in which each warp counts its slice of
// the edges per key, a scan over (key, warp) gives every warp's first slot
// per key, and each warp fills its slice in edge order, ranking equal keys
// within a step by a mask word per key -- integer atomics only, no sort.
// Its shared memory is 4E + 260 (n + 1) bytes (213 KB at the water shape,
// E = 20480 and n = 512).  Past 32768 edges, or where that passes the
// card's 227 KB, the grid path takes over: count with integer atomics (exact in any order), scan,
// drop each edge into its row with an atomic cursor, then sort each row's
// segment by edge id (a bitonic network whose compare-exchanges all put
// the smaller value at the lower index, so the padding past the segment
// never moves), which undoes the atomics' run-to-run order.
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

// ---- K2b's CSR inverse ----------------------------------------------------

constexpr int kCsrThreads = 1024;    // the one-block build
constexpr int kCsrWarps = kCsrThreads / 32;
constexpr int kCsrSteps = 32;        // edges a lane holds in the one block
constexpr int kCsrGridThreads = 256; // the grid build's count, fill, sort

__device__ __forceinline__ int csr_key(int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n) ? j : n;
}

// Exclusive scan of a[0, m) in place by one block (blockDim a multiple of
// 32); every thread returns the total.
__device__ int block_exclusive_scan(int* a, int m) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < m ? a[i] : 0;
    int x = v;   // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < n_warps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < m) a[i] = excl;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = excl + v;
    __syncthreads();
  }
  return carry;
}

// Ascending sort of seg[0, len) by the whole block: a bitonic network over
// the next power of two in which every compare-exchange puts the smaller
// value at the lower index, so the virtual +inf padding never moves.
__device__ void block_sort(int* seg, int len) {
  int p = 1;
  while (p < len) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (p >> 1); q += blockDim.x) {
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int hi = j == (k >> 1) ? lo ^ (k - 1) : lo ^ j;
        if (hi < len) {
          const int a = seg[lo];
          const int b = seg[hi];
          if (a > b) {
            seg[lo] = b;
            seg[hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The whole build in one block, as a stable counting sort.  Warp w owns
// the slice [p0, p1) of the edges, at most 32 a lane, whose keys it loads
// into registers at once (their latencies overlap), and a row of hist
// (warps, n + 1): it counts its keys there with integer atomics (exact in
// any order).  Per key the counts are summed over the warps, the sums
// scanned into the row starts, and each warp's row of hist set to where
// its slice's edges of that key begin.  Then each warp walks its slice
// again, 32 edges a step: the lanes of one key find each other by setting
// their bits in the warp's mask word for that key (atomicOr, exact in any
// order; the sentinel's lanes by a vote), each puts its edge at the key's
// slot plus the number of lower lanes in the mask, and the lowest lane
// advances the slot and clears the word.  Equal keys land in edge order,
// so no sort is needed.  order is assembled in shared memory, whose
// scattered stores are cheap, and copied out with coalesced ones.
__global__ void __launch_bounds__(kCsrThreads) csr_one_block_kernel(
    const int* __restrict__ idx, int e, int n, int* __restrict__ order,
    int* __restrict__ rowptr) {
  extern __shared__ int sm[];
  const int m = n + 1;
  int* hist = sm;                      // (kCsrWarps, m)
  int* mask = sm + kCsrWarps * m;      // (kCsrWarps, m)
  int* start = mask + kCsrWarps * m;   // (m,)
  int* ord = start + m;                // (e,)
  for (int k = threadIdx.x; k < 2 * kCsrWarps * m; k += blockDim.x) {
    sm[k] = 0;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = (e + kCsrWarps - 1) / kCsrWarps;
  const int p0 = min(warp * chunk, e);
  const int p1 = min(p0 + chunk, e);
  int key[kCsrSteps];   // -1 past the slice
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    const int p = p0 + s * 32 + lane;
    key[s] = p < p1 ? csr_key(__ldg(idx + p), n) : -1;
  }
  __syncthreads();
  int* own = hist + warp * m;
  unsigned* own_mask = reinterpret_cast<unsigned*>(mask + warp * m);
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    if (key[s] >= 0) atomicAdd(own + key[s], 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    int total = 0;
    for (int w = 0; w < kCsrWarps; ++w) total += hist[w * m + k];
    start[k] = total;
  }
  __syncthreads();
  block_exclusive_scan(start, m);
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    int slot = start[k];
    rowptr[k] = slot;
    for (int w = 0; w < kCsrWarps; ++w) {
      const int count = hist[w * m + k];
      hist[w * m + k] = slot;
      slot += count;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    if (p0 + s * 32 >= p1) break;   // warp-uniform
    const int k = key[s];
    // the sentinel row takes ~30% of the edges: its lanes find each other
    // by a vote, not by atomics that would all hit one word
    const unsigned sentinel = __ballot_sync(0xffffffffu, k == n);
    if (k >= 0 && k != n) atomicOr(own_mask + k, 1u << lane);
    __syncwarp();
    const unsigned peers = k == n ? sentinel : k >= 0 ? own_mask[k] : 0u;
    const int slot = k >= 0 ? own[k] : 0;
    __syncwarp();
    if (k >= 0) {
      ord[slot + __popc(peers & ((1u << lane) - 1))] = p0 + s * 32 + lane;
      if (lane == __ffs(peers) - 1) {
        own[k] = slot + __popc(peers);
        own_mask[k] = 0;
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int p = threadIdx.x; p < e; p += blockDim.x) order[p] = ord[p];
}

// The grid build: counts into rowptr (zeroed by the caller), one block's
// scan, the fill, one block per row's sort.
__global__ void csr_count_kernel(const int* __restrict__ idx, int e, int n,
                                 int* __restrict__ counts) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < e) atomicAdd(counts + csr_key(__ldg(idx + p), n), 1);
}

__global__ void __launch_bounds__(kCsrThreads) csr_scan_kernel(
    int* __restrict__ rowptr, int* __restrict__ cursor, int n) {
  block_exclusive_scan(rowptr, n + 1);
  for (int r = threadIdx.x; r <= n; r += blockDim.x) cursor[r] = rowptr[r];
}

__global__ void csr_fill_kernel(const int* __restrict__ idx, int e, int n,
                                int* __restrict__ cursor,
                                int* __restrict__ order) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < e) order[atomicAdd(cursor + csr_key(__ldg(idx + p), n), 1)] = p;
}

__global__ void csr_sort_kernel(const int* __restrict__ rowptr, int e, int n,
                                int* __restrict__ order) {
  const int r = blockIdx.x;
  const int s = rowptr[r];
  const int len = (r < n ? rowptr[r + 1] : e) - s;
  if (len > 1) block_sort(order + s, len);
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

// K2b's CSR inverse of idx (e,) over n rows: order (e,) and rowptr
// (n + 1,), both int32; scratch: n + 1 ints.  One block when e <= 32768
// and its shared memory, 4 e + 260 (n + 1) bytes, fits in max_shared
// bytes and the card's opt-in limit; the grid path otherwise; both give
// the same integers.
int mdg_table_index_csr(const int* idx, int e, int n, int* order,
                        int* rowptr, int* scratch, int max_shared,
                        void* stream) {
  if (e < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e == 0) {
    return static_cast<int>(
        cudaMemsetAsync(rowptr, 0, sizeof(int) * (n + 1), s));
  }
  // the dynamic shared memory csr_one_block_kernel may take: the card's
  // opt-in limit less the kernel's static shared memory, granted once
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncGetAttributes(&attr, csr_one_block_kernel);
    const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
    const cudaError_t err = cudaFuncSetAttribute(
        csr_one_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = dynamic;
  }
  const long long bytes = 4LL * ((2 * kCsrWarps + 1) * (n + 1LL) + e);
  if (e <= kCsrSteps * kCsrThreads && bytes <= max_shared && bytes <= limit) {
    csr_one_block_kernel<<<1, kCsrThreads, bytes, s>>>(idx, e, n, order,
                                                       rowptr);
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = (e + kCsrGridThreads - 1) / kCsrGridThreads;
  const cudaError_t err = cudaMemsetAsync(rowptr, 0, sizeof(int) * (n + 1),
                                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_count_kernel<<<blocks, kCsrGridThreads, 0, s>>>(idx, e, n, rowptr);
  csr_scan_kernel<<<1, kCsrThreads, 0, s>>>(rowptr, scratch, n);
  csr_fill_kernel<<<blocks, kCsrGridThreads, 0, s>>>(idx, e, n, scratch,
                                                     order);
  csr_sort_kernel<<<n + 1, kCsrGridThreads, 0, s>>>(rowptr, e, n, order);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
