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
// plain indexed load: every kernel here is exact f32 and memory-bound.
// The (N, F) node table is small (256 KB at N=512, F=128) and stays in L2
// across the K re-reads; what has to move is the (E, F) edge tensor, read
// once at its real edges (K1, K2b) or written at every slot (K2a).
//
// Their bound is bytes, but they reach it only with enough loads in
// flight: ~15-20 KB an SM (Little's law at ~0.7 us), which a thread a
// feature walking the K slots as a dependent chain (index, branch, one
// 4-byte load) is far from.  So both move rows as
// 16-byte vectors (float4 a lane; a scalar instantiation of the same
// kernel takes F % 4 != 0 or an unaligned pointer) and issue a batch of
// independent row loads before they use any: K1 spreads each output row's
// slots over up to 16 warps, each loading 4 slots' index, then their
// values and w rows, then doing the FMAs, and sums the warps' partials in
// warp order; K2a gives each warp 8 edge rows, whose indices one load and
// a shuffle bring, loads them all, then stores them.
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

#include <algorithm>
#include <cstdint>

namespace {

// ---- K1 and K2a ------------------------------------------------------------
// A row of F floats moves as T = float4 (16 bytes a lane) when F % 4 == 0
// and every row pointer is 16-byte aligned, else as T = float: the same
// kernels, instantiated twice.  fv is the row length in T.

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

__device__ __forceinline__ void fma_into(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}
__device__ __forceinline__ void add_into(float4& acc, float4 a) {
  acc.x += a.x;
  acc.y += a.y;
  acc.z += a.z;
  acc.w += a.w;
}
__device__ __forceinline__ void add_into(float& acc, float a) { acc += a; }

__device__ __forceinline__ bool real_row(int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n);
}

constexpr int kSlotsPerWarp = 4;   // K1: slots a warp loads before an FMA
constexpr int kMaxRowWarps = 16;   // K1: warps on one output row

// K1.  Block i owns output row i; its warp q takes the slots q, q + W,
// q + 2W, ... of the row (W = blockDim.y), kSlotsPerWarp at a time: the
// indices of the batch first, then every real slot's values and w rows,
// then the FMAs, so a warp has 4 rows of w (2 KB at F = 128) in flight,
// not one.  Striding the slots over the warps balances the water table,
// whose real neighbours come first in each row.  The warps' partials are
// summed in warp order through shared memory: a fixed order, no atomics.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxRowWarps) gather_mul_reduce_kernel(
    const T* __restrict__ values, const T* __restrict__ w,
    const int* __restrict__ idx, T* __restrict__ out, int n_values, int k,
    int fv) {
  __shared__ T part[kMaxRowWarps][32];
  const int lane = threadIdx.x;
  const int q = threadIdx.y;
  const int n_warps = blockDim.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * k;
  for (int c0 = 0; c0 < fv; c0 += 32) {   // one pass at F = 128
    const int c = c0 + lane;
    const bool in_row = c < fv;
    T acc = zero<T>();
    for (int s0 = q; s0 < k; s0 += n_warps * kSlotsPerWarp) {
      int j[kSlotsPerWarp];
#pragma unroll
      for (int u = 0; u < kSlotsPerWarp; ++u) {
        const int s = s0 + u * n_warps;
        j[u] = s < k ? __ldg(idx + e0 + s) : -1;
      }
      T a[kSlotsPerWarp], b[kSlotsPerWarp];
#pragma unroll
      for (int u = 0; u < kSlotsPerWarp; ++u) {
        const bool real = in_row && real_row(j[u], n_values);
        const long long e = e0 + s0 + u * n_warps;
        a[u] = real ? load(values + static_cast<long long>(j[u]) * fv + c)
                    : zero<T>();
        b[u] = real ? load(w + e * fv + c) : zero<T>();
      }
#pragma unroll
      for (int u = 0; u < kSlotsPerWarp; ++u) fma_into(acc, a[u], b[u]);
    }
    part[q][lane] = acc;
    __syncthreads();
    if (q == 0 && in_row) {
      T sum = part[0][lane];
      for (int p = 1; p < n_warps; ++p) add_into(sum, part[p][lane]);
      out[static_cast<long long>(blockIdx.x) * fv + c] = sum;
    }
    __syncthreads();
  }
}

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherRowsPerWarp = 8;   // K2a: rows loaded before a store

// K2a.  Each warp owns kGatherRowsPerWarp consecutive edge rows: one lane
// a row loads the index, a shuffle hands them to every lane, then all the
// rows' loads are issued before the first store (4 KB in flight a warp at
// F = 128).  A sentinel row is stored as zeros without a load.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads) table_gather_kernel(
    const T* __restrict__ values, const int* __restrict__ idx,
    T* __restrict__ out, int n_values, int n_edges, int fv) {
  const int lane = threadIdx.x & 31;
  const long long e0 = (static_cast<long long>(blockIdx.x) * kGatherWarps +
                        (threadIdx.x >> 5)) * kGatherRowsPerWarp;
  if (e0 >= n_edges) return;   // warp-uniform
  const int mine = lane < kGatherRowsPerWarp && e0 + lane < n_edges
                       ? __ldg(idx + e0 + lane)
                       : -1;
  int j[kGatherRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kGatherRowsPerWarp; ++u) {
    j[u] = __shfl_sync(0xffffffffu, mine, u);
  }
  for (int c = lane; c < fv; c += 32) {   // one pass at F = 128
    T v[kGatherRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kGatherRowsPerWarp; ++u) {
      v[u] = real_row(j[u], n_values)
                 ? load(values + static_cast<long long>(j[u]) * fv + c)
                 : zero<T>();
    }
#pragma unroll
    for (int u = 0; u < kGatherRowsPerWarp; ++u) {
      if (e0 + u < n_edges) out[(e0 + u) * fv + c] = v[u];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- K2b -------------------------------------------------------------------

constexpr int kRowsPerBlock = 2;

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

// The dynamic shared memory csr_one_block_kernel may take: the card's
// opt-in limit less the kernel's static shared memory, granted once.
cudaError_t csr_shared_limit(int* limit) {
  static int granted = -1;
  if (granted < 0) {
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
    if (err != cudaSuccess) return err;
    granted = dynamic;
  }
  *limit = granted;
  return cudaSuccess;
}

// One block when e <= 32768 and its shared memory, 4 e + 260 (n + 1)
// bytes, fits in max_shared bytes and in limit.
bool csr_one_block(int e, int n, int max_shared, int limit) {
  const long long bytes = 4LL * ((2 * kCsrWarps + 1) * (n + 1LL) + e);
  return e <= kCsrSteps * kCsrThreads && bytes <= max_shared &&
         bytes <= limit;
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
  if (k < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = std::min(kMaxRowWarps,
                             (k + kSlotsPerWarp - 1) / kSlotsPerWarp);
  const dim3 block(32, warps);
  if (f % 4 == 0 && aligned16(values) && aligned16(w) && aligned16(out)) {
    gather_mul_reduce_kernel<float4><<<n_out, block, 0, s>>>(
        reinterpret_cast<const float4*>(values),
        reinterpret_cast<const float4*>(w), idx,
        reinterpret_cast<float4*>(out), n_values, k, f / 4);
  } else {
    gather_mul_reduce_kernel<float><<<n_out, block, 0, s>>>(
        values, w, idx, out, n_values, k, f);
  }
  return static_cast<int>(cudaGetLastError());
}

int mdg_table_gather(const float* values, const int* idx, float* out,
                     int n_values, int n_edges, int f, void* stream) {
  if (n_edges == 0) return 0;
  if (f < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int rows_per_block = kGatherWarps * kGatherRowsPerWarp;
  const int grid =
      static_cast<int>((n_edges + rows_per_block - 1LL) / rows_per_block);
  if (f % 4 == 0 && aligned16(values) && aligned16(out)) {
    table_gather_kernel<float4><<<grid, kGatherThreads, 0, s>>>(
        reinterpret_cast<const float4*>(values), idx,
        reinterpret_cast<float4*>(out), n_values, n_edges, f / 4);
  } else {
    table_gather_kernel<float><<<grid, kGatherThreads, 0, s>>>(
        values, idx, out, n_values, n_edges, f);
  }
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
  int limit = 0;
  const cudaError_t limit_err = csr_shared_limit(&limit);
  if (limit_err != cudaSuccess) return static_cast<int>(limit_err);
  if (csr_one_block(e, n, max_shared, limit)) {
    const int bytes = 4 * ((2 * kCsrWarps + 1) * (n + 1) + e);
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

// Which build mdg_table_index_csr takes for e edges over n rows when its
// max_shared allows any size: 1 the one-block build, 0 the grid build; a
// negative CUDA error code if the shared-memory limit cannot be read.
int mdg_table_index_csr_one_block(int e, int n) {
  int limit = 0;
  const cudaError_t err = csr_shared_limit(&limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return csr_one_block(e, n, 0x7fffffff, limit) ? 1 : 0;
}

}  // extern "C"
