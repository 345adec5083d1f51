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
// 4-byte load) is far from.  So all three move rows as wide lanes (a
// scalar instantiation of the same kernel takes a row that does not split
// into lanes or an unaligned pointer) and issue a batch of independent row
// loads before they use any:
//   K1 (replaces _gmr_kernel): 4 elements a lane in both types (float4,
//   16 bytes, in f32; uint2, 8 bytes, in bf16), so 32 lanes span a
//   128-wide row and no lane idles.  Block i owns output row i and spreads
//   its K slots over W = min(16, ceil(K / 4)) warps, 4 slots a warp: their
//   indices, then the real slots' values and w rows (4 KB in flight a warp
//   in f32, 2 KB in bf16), then the FMAs.  The warps' partials meet in
//   shared memory, and the block's threads, one output element each, add
//   them in a fixed pairwise tree (four levels at most) and store.  At the
//   water shape, 512 blocks of 10 warps (K = 40) over 132 SMs are resident
//   at once: 116 SMs hold 4 blocks, 16 hold 3.
//   K2a (replaces _gather_kernel): a copy in the widest lane (float4;
//   uint4, 8 bf16) on every lane of a warp.  A block is one warp owning a
//   contiguous run of rows * fv output lanes, rows = min(32, 256 / fv): 16
//   rows of 256 bytes in bf16 at F = 128 (two rows a warp instruction), 8
//   rows of 512 in f32.  Each thread loads 8 lanes' indices and lanes,
//   then stores them: 4 KB in flight a warp.  One-warp blocks keep the
//   grid even: the 20480 water rows make 1280 blocks in bf16, 10 on 92 SMs
//   and 9 on 40, all resident at once (at most 32 blocks an SM), so the
//   SMs' rows differ by one block's 16; in f32 2560 blocks, 20 or 19 an SM.
//   K2b: a warp a 32-lane chunk of one output row (8-byte lanes: two
//   warps a row in f32, one in bf16 at F = 128), whose edge ids one load
//   and a shuffle bring, loads up to 32 of their rows, then adds them.

// Index convention (shared with the Python plain versions): an index
// outside [0, n_values) is the padding sentinel -- it gathers a zero row
// and is dropped by the scatter.
//
// The scatter is the transpose of the gather.  Float atomics would make it
// run-to-run nondeterministic, so it reads a CSR inverse of the index and
// each lane sums its features of an output row from +0 in ascending edge
// order, one add at a time: deterministic, and the bits of one thread a
// feature walking the row.  The inverse is built on the card,
// once per TableIndex (once per SchNet energy on the MD path), by
// mdg_table_index_csr, integer-equal to a stable argsort of the
// sentinel-mapped index (the plain build in ops/gather.py).  Its bound is
// bytes, 4E in and 4E + 4(n + 1) out (0.05 us at the water shape), but at
// these sizes it is bound by latency, so it is one launch of one thread
// block cluster: 8 blocks on 8 SMs, each owning a contiguous slice of the
// edges, a stable counting sort with no sort pass.  Each warp counts its
// slice per key (equal keys of a step found by __match_any_sync), each
// block turns its warps' counts into per-warp offsets and a total per key,
// the blocks read each other's totals through distributed shared memory
// after one cluster barrier, and each warp fills its slice in edge order.
// Its capacity: 65536 edges and 2048 keys (n <= 2047), 72 (n + 1) + 12
// bytes of shared memory a block.  Past it -- the 4096-site water and a-Si
// tables (196608 and 360448 edges), the 1728-site 'sparse' prior (82944),
// any n up to 2^31 - 2 and E into the millions -- the grid build takes
// over.  It replaces no TPU kernel either (K2b's own inverse).  Its bound
// is the same bytes (0.5-0.9 us at 4096 rows), all of it resident in the
// 50 MB L2, so what it pays is launches and dependent chains: it is the
// cluster build's stable counting sort with global memory where that uses
// distributed shared memory, as an LSD radix sort over 8-bit digits (2
// passes up to n = 65535): one counting launch, one scattering launch a
// pass and one for rowptr, each over the SMs (at most 256 blocks of 512
// threads; 4 launches at 4096 rows), with no sort pass and no atomics on
// any slot (the digit counts add integers, exact in any order), so every
// call gives the same integers.
//
// bf16 (the JAX package's split=False, mdg_*_bf16): the same three kernels
// instantiated over bf16 rows: K1 and K2b 4 to an 8-byte lane (uint2) where
// F % 4 == 0, K2a 8 to a 16-byte lane (uint4) where F % 8 == 0, with the
// rows aligned, else one at a time (unsigned short, the bf16 bits).  K1
// widens each bf16 to f32 (exact: the top 16 bits), so each product is
// exact in f32, sums over K in f32 in the same fixed order on either path
// and rounds once to bf16 (round to nearest even); K2a copies the bf16
// bits; K2b sums bf16 rows in f32 and writes f32.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is raised by the Python wrapper.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

// ---- lane types ------------------------------------------------------------
// A row of F elements moves as a lane type T of 8 or 16 bytes where F splits
// into it and every row pointer is aligned to it, else one element at a time
// (float, or bf16_bits: one bf16's bits).  fv is the row length in T.
//   K1:  float4 (4 f32), uint2 (4 bf16): 32 lanes span 128 features
//   K2a: float4 (4 f32), uint4 (8 bf16): a copy takes the widest lane
//   K2b: float2 (2 f32), uint2 (4 bf16): below
// K1 and K2b add in f32: AccOf<T> is float4 for float4 and uint2, float2 for
// float2, float for the scalars.

using bf16_bits = unsigned short;

template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<uint2> {   // 4 bf16 a lane
  using type = float4;
};
template <>
struct AccOf<bf16_bits> {
  using type = float;
};

// K1's output element: an f32 sum, or the bits of its bf16 rounding
template <typename T>
struct ElemOf {
  using type = float;
};
template <>
struct ElemOf<uint2> {
  using type = bf16_bits;
};
template <>
struct ElemOf<bf16_bits> {
  using type = bf16_bits;
};

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint2 load(const uint2* p) { return __ldg(p); }
__device__ __forceinline__ float2 load(const float2* p) { return __ldg(p); }
__device__ __forceinline__ bf16_bits load(const bf16_bits* p) {
  return __ldg(p);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint2 zero<uint2>() { return make_uint2(0u, 0u); }
template <>
__device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}
template <>
__device__ __forceinline__ bf16_bits zero<bf16_bits>() { return 0; }

// *p where pred holds, else zero (p is not read)
template <typename T>
__device__ __forceinline__ T load_if(const T* p, bool pred) {
  return pred ? load(p) : zero<T>();
}
// *p where pred holds, else -1 (a sentinel)
__device__ __forceinline__ int index_if(const int* p, bool pred) {
  return pred ? __ldg(p) : -1;
}

// bf16 -> f32 is exact: the bf16 bits are the top half of the f32's
__device__ __forceinline__ float widen(bf16_bits b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float widen_lo(unsigned word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float widen_hi(unsigned word) {
  return __uint_as_float(word & 0xffff0000u);
}

__device__ __forceinline__ void fma_into(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}
// a product of two bf16 is exact in f32, so the FMA rounds only the sum
__device__ __forceinline__ void fma_into(float4& acc, uint2 a, uint2 b) {
  acc.x = fmaf(widen_lo(a.x), widen_lo(b.x), acc.x);
  acc.y = fmaf(widen_hi(a.x), widen_hi(b.x), acc.y);
  acc.z = fmaf(widen_lo(a.y), widen_lo(b.y), acc.z);
  acc.w = fmaf(widen_hi(a.y), widen_hi(b.y), acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, bf16_bits a,
                                         bf16_bits b) {
  acc = fmaf(widen(a), widen(b), acc);
}
__device__ __forceinline__ void add_into(float& acc, float a) { acc += a; }
// K2b's bf16 rows, widened exactly and added in f32
__device__ __forceinline__ void add_into(float4& acc, uint2 a) {
  acc.x += widen_lo(a.x);
  acc.y += widen_hi(a.x);
  acc.z += widen_lo(a.y);
  acc.w += widen_hi(a.y);
}
__device__ __forceinline__ void add_into(float& acc, bf16_bits a) {
  acc += widen(a);
}
__device__ __forceinline__ void add_into(float2& acc, float2 a) {
  acc.x += a.x;
  acc.y += a.y;
}

// K1's f32 sum as its output element: as it is, or rounded once to bf16
// (round to nearest even)
template <typename E>
__device__ __forceinline__ E to_elem(float x);
template <>
__device__ __forceinline__ float to_elem<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_bits to_elem<bf16_bits>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool real_row(int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n);
}

constexpr int kSlotsPerWarp = 4;   // K1: slots a warp loads before an FMA
constexpr int kMaxRowWarps = 16;   // K1: warps on one output row

// K1.  Block i owns output row i; its warp q takes the slots q, q + W,
// q + 2W, ... of the row (W = blockDim.y), kSlotsPerWarp at a time: the
// batch's indices first, then every real slot's values and w rows, then
// the FMAs (a lane's f32 chain from +0 in slot order).  A sentinel slot
// loads nothing, so a padded w row never reaches the sum.  The warps'
// partials meet in shared memory and the block's threads, one f32 output
// element each, add them in a fixed pairwise tree: level h adds partial
// p + h into p for p = 0, 2h, 4h, ... while p + h < W.  No atomics: the
// same bits on every call, and on the scalar path.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxRowWarps) gather_mul_reduce_kernel(
    const T* __restrict__ values, const T* __restrict__ w,
    const int* __restrict__ idx, typename ElemOf<T>::type* __restrict__ out,
    int n_values, int k, int fv) {
  using Acc = typename AccOf<T>::type;
  using Elem = typename ElemOf<T>::type;
  constexpr int kAccFloats = sizeof(Acc) / sizeof(float);
  __shared__ Acc part[kMaxRowWarps][32];
  const float* flat = reinterpret_cast<const float*>(&part[0][0]);
  const int lane = threadIdx.x;
  const int q = threadIdx.y;
  const int n_warps = blockDim.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * k;
  for (int c0 = 0; c0 < fv; c0 += 32) {   // one pass at F = 128
    const int c = c0 + lane;
    const bool in_row = c < fv;
    Acc acc = zero<Acc>();
    for (int s0 = q; s0 < k; s0 += n_warps * kSlotsPerWarp) {
      int j[kSlotsPerWarp];
#pragma unroll
      for (int u = 0; u < kSlotsPerWarp; ++u) {
        const int s = s0 + u * n_warps;
        j[u] = index_if(idx + e0 + s, s < k);
      }
      T a[kSlotsPerWarp], b[kSlotsPerWarp];
#pragma unroll
      for (int u = 0; u < kSlotsPerWarp; ++u) {
        const bool real = in_row && real_row(j[u], n_values);
        const long long e = e0 + s0 + u * n_warps;
        a[u] = load_if(values + static_cast<long long>(j[u]) * fv + c, real);
        b[u] = load_if(w + e * fv + c, real);
      }
#pragma unroll
      for (int u = 0; u < kSlotsPerWarp; ++u) fma_into(acc, a[u], b[u]);
    }
    part[q][lane] = acc;
    __syncthreads();
    // this pass's f32 elements: lane l's Acc holds kAccFloats of them
    Elem* row = out + (static_cast<long long>(blockIdx.x) * fv + c0) *
                          kAccFloats;
    const int width = min(32, fv - c0) * kAccFloats;
    for (int t = q * 32 + lane; t < width; t += 32 * n_warps) {
      float v[kMaxRowWarps];
#pragma unroll
      for (int p = 0; p < kMaxRowWarps; ++p) {
        v[p] = p < n_warps ? flat[p * 32 * kAccFloats + t] : 0.f;
      }
#pragma unroll
      for (int h = 1; h < kMaxRowWarps; h <<= 1) {
#pragma unroll
        for (int p = 0; p + h < kMaxRowWarps; p += 2 * h) {
          if (p + h < n_warps) v[p] += v[p + h];
        }
      }
      row[t] = to_elem<Elem>(v[0]);
    }
    __syncthreads();
  }
}

constexpr int kGatherLanes = 8;   // K2a: lanes a thread loads before a store

// K2a.  A block is one warp, owning `rows` consecutive edge rows: one
// contiguous block of rows * fv lanes of the output.  Thread l moves the
// block's lanes l, l + 32, l + 64, ..., kGatherLanes at a time: for each,
// the index of its row (a load the warp's other lanes of that row share),
// then the row's lane; then all the stores.  A sentinel row is stored as
// zeros without a load.  (The index load is predicated on the row, not on
// the lane as the store is: with one predicate for both, ptxas moved each
// store up beside its load, and fewer loads were in flight.)
template <typename T>
__global__ void __launch_bounds__(32) table_gather_kernel(
    const T* __restrict__ values, const int* __restrict__ idx,
    T* __restrict__ out, int n_values, int n_edges, int fv, int rows) {
  const int lane = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * rows;
  const int n_rows = static_cast<int>(
      min(static_cast<long long>(rows), n_edges - e0));
  const int total = n_rows * fv;
  // lane t of the block is lane t % fv of row t / fv; a step of 32 lanes
  // moves du rows and dc lanes on
  const int du = 32 / fv;
  const int dc = 32 - du * fv;
  int u = lane / fv;
  int c = lane - u * fv;
  T* dst = out + e0 * fv;
  for (int t0 = 0; t0 < total; t0 += 32 * kGatherLanes) {
    T v[kGatherLanes];
#pragma unroll
    for (int i = 0; i < kGatherLanes; ++i) {
      const int j = index_if(idx + e0 + u, u < n_rows);
      v[i] = load_if(values + static_cast<long long>(j) * fv + c,
                     t0 + 32 * i + lane < total && real_row(j, n_values));
      c += dc;
      u += du;
      if (c >= fv) {
        c -= fv;
        ++u;
      }
    }
#pragma unroll
    for (int i = 0; i < kGatherLanes; ++i) {
      const int t = t0 + 32 * i + lane;
      if (t < total) dst[t] = v[i];
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---- K2b -------------------------------------------------------------------
// A row moves as an 8-byte lane type T: float2 (2 f32) where F % 2 == 0,
// uint2 (4 bf16) where F % 4 == 0, with the rows aligned; else float or
// bf16_bits.  Each lane sums in AccOf<T> (float2, float4 or float) and
// writes f32.

constexpr int kScatterWarps = 4;   // warps a block, a row chunk each

// K2b.  Each warp owns one 32-lane chunk of one output row (two warps a
// row at F = 128: 8-byte lanes, so that a warp's 32 row loads in flight
// are 8 KB).  The row's edge ids come 32 at a time, one coalesced load,
// and a shuffle hands each to every lane; then all their rows are loaded,
// then added one at a time in ascending edge order from +0: the same
// order, and bits, as one thread a feature walking the row.  A slot past
// the row's end is neither loaded nor added.
template <typename T>
__global__ void __launch_bounds__(32 * kScatterWarps) table_scatter_kernel(
    const T* __restrict__ g, const int* __restrict__ order,
    const int* __restrict__ rowptr, typename AccOf<T>::type* __restrict__ out,
    int n_out, int fv) {
  using Acc = typename AccOf<T>::type;
  const int lane = threadIdx.x & 31;
  const int chunks = (fv + 31) / 32;
  const long long w = static_cast<long long>(blockIdx.x) * kScatterWarps +
                      (threadIdx.x >> 5);
  if (w >= static_cast<long long>(n_out) * chunks) return;   // warp-uniform
  const int i = static_cast<int>(w / chunks);
  const int c = static_cast<int>(w % chunks) * 32 + lane;
  const bool in_row = c < fv;
  const int p0 = __ldg(rowptr + i);
  const int p1 = __ldg(rowptr + i + 1);
  Acc acc = zero<Acc>();
  for (int p = p0; p < p1; p += 32) {
    const int mine = p + lane < p1 ? __ldg(order + p + lane) : 0;
    const int count = min(32, p1 - p);
    T v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int e = __shfl_sync(0xffffffffu, mine, u);
      v[u] = in_row && u < count
                 ? load(g + static_cast<long long>(e) * fv + c)
                 : zero<T>();
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (u < count) add_into(acc, v[u]);   // warp-uniform
    }
  }
  if (in_row) out[static_cast<long long>(i) * fv + c] = acc;
}

// ---- K2b's CSR inverse ----------------------------------------------------

constexpr int kCsrCluster = 8;        // blocks a cluster: the portable most
constexpr int kCsrThreads = 512;      // a block of the cluster build
constexpr int kCsrWarps = kCsrThreads / 32;
constexpr int kCsrSlices = kCsrCluster * kCsrWarps;   // one a warp
constexpr int kCsrSteps = 16;         // edges a lane holds
constexpr int kCsrMaxEdges = kCsrSlices * 32 * kCsrSteps;   // 65536
constexpr int kCsrMaxKeys = 2048;     // n + 1 (the sentinel is key n)
static_assert(4 * kCsrThreads >= kCsrMaxKeys, "4 keys a thread at most");

__device__ __forceinline__ int csr_key(int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n) ? j : n;
}

// The cluster build's dynamic shared memory for n rows: the warps' counts
// (warps x (n + 1) ints), the block's totals (n + 1, padded to 4 for
// 16-byte reads) and the keys' first slots (n + 1)
constexpr long long csr_cluster_bytes(long long n) {
  return 4LL * ((kCsrWarps + 2) * (n + 1) + 3);
}

__device__ __forceinline__ void add4(int4& a, int4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Exclusive sum of v over the block (kCsrThreads threads): the warps'
// inclusive scans by shuffles, then each thread adds the lower warps'
// totals.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int below = 0;
#pragma unroll
  for (int w = 0; w < kCsrWarps; ++w) below += w < warp ? warp_sums[w] : 0;
  return below + x - v;
}

// The cluster build, a stable counting sort in one launch.  The edges are
// cut into 8 x 16 contiguous warp slices, block r holding slices 16 r to
// 16 r + 15, at most 16 edges a lane, whose keys each lane loads into
// registers at once (their latencies overlap).
//   1. Each warp counts its keys into its row of hist (warps, n + 1), a
//      step of 32 edges at a time: the lanes of one key find each other by
//      __match_any_sync, each keeps its place among the warp's edges of
//      its key so far (the count before the step plus its lower peers),
//      and the lowest adds their number (a warp's own row: no atomics).
//   2. One thread a key loads the key's 16 warp counts at once, turns them
//      into the counts of the lower warps and writes the block's total.
//   3. After a cluster barrier each thread reads, for its 4 keys, the 8
//      blocks' totals through distributed shared memory (one 16-byte read
//      a block): the lower blocks' sum and the whole.  A block-wide
//      exclusive sum of the wholes gives each key's first slot (rowptr,
//      written by block 0) and, plus the lower blocks', where this
//      block's edges of the key begin (base).
//   4. Each lane stores its edges at base + its warp's lower count + its
//      place: reads and independent stores only.
// Blocks in rank order, warps in slice order and lanes in edge order keep
// equal keys in edge order.  The cluster barrier's arrive follows the last
// remote read and its wait ends the kernel, so no block leaves while
// another still reads its shared memory.
__global__ void __cluster_dims__(kCsrCluster, 1, 1)
    __launch_bounds__(kCsrThreads) csr_cluster_kernel(
        const int* __restrict__ idx, int e, int n, int* __restrict__ order,
        int* __restrict__ rowptr) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int sm[];
  __shared__ int warp_sums[kCsrWarps];
  const int m = n + 1;
  const int m4 = (m + 3) & ~3;
  int* hist = sm;                      // (kCsrWarps, m): counts, then offsets
  int* total = hist + kCsrWarps * m;   // (m4,): this block's count per key
  int* base = total + m4;              // (m,): the key's first slot here
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunk = (e + kCsrSlices - 1) / kCsrSlices;
  const int p0 = min((rank * kCsrWarps + warp) * chunk, e);
  const int p1 = min(p0 + chunk, e);
  int key[kCsrSteps];   // -1 past the slice
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    const int p = p0 + s * 32 + lane;
    key[s] = p < p1 ? csr_key(idx[p], n) : -1;
  }
  for (int k = threadIdx.x; k < kCsrWarps * m; k += kCsrThreads) hist[k] = 0;
  __syncthreads();
  int* own = hist + warp * m;
  int place[kCsrSteps];   // each edge's place among its warp's of its key
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    if (p0 + s * 32 >= p1) break;   // warp-uniform
    const int k = key[s];
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int before = k >= 0 ? own[k] : 0;
    place[s] = before + __popc(peers & lower);
    __syncwarp();
    if (k >= 0 && (peers & lower) == 0) own[k] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m4; k += kCsrThreads) {
    int c[kCsrWarps];
#pragma unroll
    for (int w = 0; w < kCsrWarps; ++w) c[w] = k < m ? hist[w * m + k] : 0;
    int below = 0;
#pragma unroll
    for (int w = 0; w < kCsrWarps; ++w) {
      if (k < m) hist[w * m + k] = below;
      below += c[w];
    }
    total[k] = below;
  }
  cluster.sync();   // every block's totals written and visible
  // this thread's keys [k0, k0 + 4): each block's 4 totals in one read
  const int k0 = 4 * threadIdx.x;
  int4 lower_blocks = make_int4(0, 0, 0, 0);
  int4 whole = make_int4(0, 0, 0, 0);
  if (k0 < m4) {
    int4 t[kCsrCluster];
#pragma unroll
    for (int r = 0; r < kCsrCluster; ++r) {
      t[r] = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(total, r) + k0);
    }
#pragma unroll
    for (int r = 0; r < kCsrCluster; ++r) {
      if (r < rank) add4(lower_blocks, t[r]);
      add4(whole, t[r]);
    }
  }
  // the remote reads are done: arrive now, wait at the end
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  int first = block_exclusive_sum(whole.x + whole.y + whole.z + whole.w,
                                  warp_sums);
  const int wholes[4] = {whole.x, whole.y, whole.z, whole.w};
  const int lowers[4] = {lower_blocks.x, lower_blocks.y, lower_blocks.z,
                         lower_blocks.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (k0 + u < m) {
      if (rank == 0) rowptr[k0 + u] = first;
      base[k0 + u] = first + lowers[u];
      first += wholes[u];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kCsrSteps; ++s) {
    if (p0 + s * 32 >= p1) break;   // warp-uniform
    const int k = key[s];
    if (k >= 0) order[base[k] + own[k] + place[s]] = p0 + s * 32 + lane;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ---- the grid build: a stable LSD radix sort spread over the grid ----
// Each pass sorts the (key, edge) pairs stably by one 8-bit digit of the
// key, the lowest first, so that after ceil(bits(n) / 8) passes (2 at n =
// 4096 or 48668) they are in key order and, within a key, in edge order.
// Every launch runs the same blocks, block b owning the contiguous tiles
// [b t, b t + t) of 4096 edges (t = 1 up to 256 tiles, then more), and
// needs each block's count of each digit of its pass:
//   count (the first pass only): each warp's lanes of one digit found by
//     __match_any_sync, the lowest adding their number to the block's
//     shared count (integer adds, exact in any order); it also zeroes the
//     later passes' counts;
//   scatter (one a pass): each block sums the blocks' counts (8 groups of
//     64 threads, a thread reading 4 digits of every 8th block in one
//     16-byte load) into the digit's total and the lower blocks' share,
//     takes one exclusive scan of the 256 totals (the digits' first
//     slots), then walks its tiles in order as the cluster build walks
//     its slice: each warp counts its lanes' digits into its own row (a
//     place for each edge among its warp's edges of its digit),
//     one thread a digit turns the 16 rows into the lower warps' counts
//     and a scan of the tile's counts gives each digit's first place in
//     the tile; the pairs are staged in shared memory in digit order and
//     stored from there, each digit's run to consecutive slots (the
//     digit's first slot + the lower blocks' + the block's earlier tiles'
//     + its place in the tile's run).  As it stores, it adds the next
//     pass's digits into the counts of the blocks that will read them
//     (integer atomics, one for each warp's lanes of one block and digit),
//     so no count launch stands between two passes;
//   rowptr: position q of the sorted keys writes q into rowptr[k] for
//     every key k in (key[q - 1], key[q]], and position e fills the keys
//     past the last.
// Blocks in order, tiles in order, warps in order and lanes in edge order
// keep equal digits in input order: each pass is stable, and no slot is
// written through an atomic, so every call gives the same integers.
constexpr int kCsrRadixBits = 8;                   // a digit of the key
constexpr int kCsrDigits = 1 << kCsrRadixBits;     // 256
constexpr int kCsrTileSteps = 8;                   // edges a lane holds
constexpr int kCsrTile = kCsrThreads * kCsrTileSteps;   // 4096 edges
constexpr int kCsrMaxBlocks = 256;                 // blocks of a launch
constexpr int kCsrRowptrThreads = 256;
static_assert(kCsrThreads >= kCsrDigits, "a thread a digit");
constexpr int kCsrCountSplit = kCsrThreads / (kCsrDigits / 4);   // 8
static_assert(2 * kCsrTile >= (kCsrWarps + 2 * kCsrCountSplit) * kCsrDigits,
              "the scatter's counts fit where its tile is staged");

// The key of edge p of a pass's input (the index, sentinel-mapped, in the
// first pass; the last pass's keys after it), or -1 past the edges
template <bool kFirst>
__device__ __forceinline__ int csr_pass_key(const int* src, long long p,
                                            int e, int n) {
  if (p >= e) return -1;
  return kFirst ? csr_key(__ldg(src + p), n) : __ldg(src + p);
}

__device__ __forceinline__ int csr_digit(int key, int shift) {
  return key < 0 ? -1 : (key >> shift) & (kCsrDigits - 1);
}

// Block blockIdx.x's edges [first, end) of e, `tiles` tiles of kCsrTile
__device__ __forceinline__ long long csr_block_first(int tiles) {
  return static_cast<long long>(blockIdx.x) * tiles * kCsrTile;
}
__device__ __forceinline__ long long csr_block_end(int e, int tiles) {
  return min(static_cast<long long>(e),
             csr_block_first(tiles) + static_cast<long long>(tiles) *
                                          kCsrTile);
}

// counts[0] (blocks, 256): the block's count of each digit of the index's
// keys; counts[1, passes) zeroed for the scatters to add into
__global__ void __launch_bounds__(kCsrThreads) csr_radix_count_kernel(
    const int* __restrict__ idx, int e, int n, int tiles, int passes,
    int* __restrict__ counts) {
  __shared__ int hist[kCsrDigits];
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const long long rows = static_cast<long long>(gridDim.x) * kCsrDigits;
  for (int d = threadIdx.x; d < kCsrDigits; d += kCsrThreads) {
    hist[d] = 0;
    for (int p = 1; p < passes; ++p) {
      counts[p * rows + static_cast<long long>(blockIdx.x) * kCsrDigits +
             d] = 0;
    }
  }
  __syncthreads();
  const long long end = csr_block_end(e, tiles);
  for (long long t0 = csr_block_first(tiles); t0 < end; t0 += kCsrTile) {
    const long long p0 = t0 + (threadIdx.x >> 5) * (32 * kCsrTileSteps) +
                         lane;
    int dig[kCsrTileSteps];
#pragma unroll
    for (int s = 0; s < kCsrTileSteps; ++s) {
      dig[s] = csr_digit(csr_pass_key<true>(idx, p0 + s * 32, e, n), 0);
    }
#pragma unroll
    for (int s = 0; s < kCsrTileSteps; ++s) {
      const unsigned peers = __match_any_sync(0xffffffffu, dig[s]);
      if (dig[s] >= 0 && (peers & lower) == 0) {
        atomicAdd(hist + dig[s], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kCsrDigits; d += kCsrThreads) {
    counts[static_cast<long long>(blockIdx.x) * kCsrDigits + d] = hist[d];
  }
}

// One pass: src/src_ids (the index and the edge positions in the first
// pass) sorted by the digit at shift into dst/dst_ids, reading counts
// (blocks, 256) of that digit and adding the digit at shift + 8 into
// next_counts (nullptr in the last pass).
template <bool kFirst>
__global__ void __launch_bounds__(kCsrThreads) csr_radix_scatter_kernel(
    const int* __restrict__ src, const int* __restrict__ src_ids, int e,
    int n, int shift, int tiles, const int* __restrict__ counts,
    int* __restrict__ next_counts, int* __restrict__ dst,
    int* __restrict__ dst_ids) {
  // the warps' counts, then offsets (hist), and the blocks' sums (part)
  // share stage, which then holds the tile's pairs in digit order
  __shared__ __align__(16) int stage[2 * kCsrTile];
  __shared__ int base[kCsrDigits];   // where the next tile's digit begins
  __shared__ int tile_first[kCsrDigits];   // the digit's first place
  __shared__ int warp_sums[kCsrWarps];
  int (*hist)[kCsrDigits] = reinterpret_cast<int (*)[kCsrDigits]>(stage);
  int4 (*part)[2][kCsrDigits / 4] =
      reinterpret_cast<int4 (*)[2][kCsrDigits / 4]>(stage +
                                                   kCsrWarps * kCsrDigits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int d = threadIdx.x & (kCsrDigits - 1);
  const bool digit_thread = threadIdx.x < kCsrDigits;
  const long long span = static_cast<long long>(tiles) * kCsrTile;
  const long long first = csr_block_first(tiles);
  const long long end = csr_block_end(e, tiles);
  int* own = hist[warp];
  for (long long t0 = first; t0 < end; t0 += kCsrTile) {
    const long long w0 = t0 + warp * (32 * kCsrTileSteps);   // warp-uniform
    int key[kCsrTileSteps], id[kCsrTileSteps], place[kCsrTileSteps];
#pragma unroll
    for (int s = 0; s < kCsrTileSteps; ++s) {
      const long long p = w0 + s * 32 + lane;
      key[s] = csr_pass_key<kFirst>(src, p, e, n);
      id[s] = kFirst ? static_cast<int>(p)
                     : (p < e ? __ldg(src_ids + p) : -1);
    }
    if (t0 == first) {   // block-uniform; the tile's loads in flight
      // thread (r, c) sums digits 4c to 4c + 3 of the blocks r, r + 8, ...
      const int c = threadIdx.x % (kCsrDigits / 4);
      const int r = threadIdx.x / (kCsrDigits / 4);
      int4 total = make_int4(0, 0, 0, 0);
      int4 below = make_int4(0, 0, 0, 0);
#pragma unroll 4
      for (int b = r; b < static_cast<int>(gridDim.x); b += kCsrCountSplit) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(
                                 counts + static_cast<long long>(b) *
                                              kCsrDigits) + c);
        add4(total, v);
        if (b < static_cast<int>(blockIdx.x)) add4(below, v);
      }
      part[r][0][c] = total;
      part[r][1][c] = below;
      __syncthreads();
      int whole = 0;
      int lower_blocks = 0;
      if (digit_thread) {
        const int* flat = reinterpret_cast<const int*>(part);
#pragma unroll
        for (int q = 0; q < kCsrCountSplit; ++q) {
          whole += flat[(2 * q) * kCsrDigits + d];
          lower_blocks += flat[(2 * q + 1) * kCsrDigits + d];
        }
      }
      const int start = block_exclusive_sum(whole, warp_sums);
      if (digit_thread) base[d] = start + lower_blocks;
    }
    for (int k = threadIdx.x; k < kCsrWarps * kCsrDigits; k += kCsrThreads) {
      (&hist[0][0])[k] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kCsrTileSteps; ++s) {
      if (w0 + s * 32 >= end) break;   // warp-uniform
      const int k = csr_digit(key[s], shift);
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      const int before = k >= 0 ? own[k] : 0;
      place[s] = before + __popc(peers & lower);
      __syncwarp();
      if (k >= 0 && (peers & lower) == 0) own[k] = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    int tile_count = 0;
    if (digit_thread) {
#pragma unroll
      for (int w = 0; w < kCsrWarps; ++w) {
        const int c = hist[w][d];
        hist[w][d] = tile_count;
        tile_count += c;
      }
    }
    const int t_first = block_exclusive_sum(tile_count, warp_sums);
    if (digit_thread) tile_first[d] = t_first;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kCsrTileSteps; ++s) {   // past the edges: -1
      const int k = csr_digit(key[s], shift);
      place[s] = k >= 0 ? tile_first[k] + own[k] + place[s] : -1;
    }
    __syncthreads();   // hist read: stage may take its place
#pragma unroll
    for (int s = 0; s < kCsrTileSteps; ++s) {
      if (place[s] >= 0) {
        stage[place[s]] = key[s];
        stage[kCsrTile + place[s]] = id[s];
      }
    }
    __syncthreads();
    const int count = static_cast<int>(min(static_cast<long long>(kCsrTile),
                                           end - t0));
    for (int j0 = 0; j0 < count; j0 += kCsrThreads) {   // block-uniform
      const int j = j0 + threadIdx.x;
      int next = -1;   // the next pass's (block, digit), or -1
      if (j < count) {
        const int k_full = stage[j];
        const int k = csr_digit(k_full, shift);
        const int q = base[k] + j - tile_first[k];
        dst[q] = k_full;
        dst_ids[q] = stage[kCsrTile + j];
        if (next_counts != nullptr) {
          next = static_cast<int>(q / span) * kCsrDigits +
                 csr_digit(k_full, shift + kCsrRadixBits);
        }
      }
      if (next_counts != nullptr) {   // block-uniform
        const unsigned peers = __match_any_sync(0xffffffffu, next);
        if (next >= 0 && (peers & lower) == 0) {
          atomicAdd(next_counts + next, __popc(peers));
        }
      }
    }
    __syncthreads();   // every read of base, tile_first and stage done
    if (digit_thread) base[d] += tile_count;
  }
}

__global__ void __launch_bounds__(kCsrRowptrThreads) csr_rowptr_kernel(
    const int* __restrict__ keys, int e, int n, int* __restrict__ rowptr) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q > e) return;
  const int a = q > 0 ? __ldg(keys + q - 1) : -1;
  const int b = q < e ? __ldg(keys + q) : n;
  for (int k = a + 1; k <= b; ++k) rowptr[k] = static_cast<int>(q);
}

// The passes the grid build takes over keys 0..n: one a digit of n
int csr_radix_passes(int n) {
  int bits = 1;
  while (bits < 31 && (n >> bits) != 0) ++bits;
  return (bits + kCsrRadixBits - 1) / kCsrRadixBits;
}

// The grid build's blocks for e > 0 edges and the tiles each owns
struct CsrGrid {
  int blocks;
  int tiles;
};

CsrGrid csr_grid(int e) {
  const long long tiles = (e + kCsrTile - 1LL) / kCsrTile;
  const long long per = (tiles + kCsrMaxBlocks - 1) / kCsrMaxBlocks;
  return {static_cast<int>((tiles + per - 1) / per), static_cast<int>(per)};
}

// The grid build's scratch in ints: each pass's blocks' digit counts
// (first, for 16-byte reads), keys twice and edge ids once (e each)
long long csr_grid_scratch(int e, int n) {
  if (e <= 0) return 0;
  return 3LL * e + static_cast<long long>(csr_radix_passes(n)) *
                       csr_grid(e).blocks * kCsrDigits;
}

cudaError_t csr_grid_build(const int* idx, int e, int n, int* order,
                           int* rowptr, int* scratch, cudaStream_t s) {
  const int passes = csr_radix_passes(n);
  const CsrGrid g = csr_grid(e);
  const long long rows = static_cast<long long>(g.blocks) * kCsrDigits;
  int* counts = scratch;
  int* keys[2] = {scratch + passes * rows, scratch + passes * rows + e};
  // the last pass writes order, the one before it ids[0], ...
  int* ids[2] = {scratch + passes * rows + 2LL * e, order};
  csr_radix_count_kernel<<<g.blocks, kCsrThreads, 0, s>>>(idx, e, n, g.tiles,
                                                          passes, counts);
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kCsrRadixBits;
    int* next = p + 1 < passes ? counts + (p + 1) * rows : nullptr;
    int* dst = keys[p & 1];
    int* dst_ids = ids[(passes - 1 - p) % 2 == 0];
    if (p == 0) {
      csr_radix_scatter_kernel<true><<<g.blocks, kCsrThreads, 0, s>>>(
          idx, nullptr, e, n, shift, g.tiles, counts, next, dst, dst_ids);
    } else {
      csr_radix_scatter_kernel<false><<<g.blocks, kCsrThreads, 0, s>>>(
          keys[(p - 1) & 1], ids[(passes - p) % 2 == 0], e, n, shift,
          g.tiles, counts + p * rows, next, dst, dst_ids);
    }
  }
  const long long threads = e + 1LL;
  csr_rowptr_kernel<<<static_cast<int>((threads + kCsrRowptrThreads - 1) /
                                       kCsrRowptrThreads),
                      kCsrRowptrThreads, 0, s>>>(keys[(passes - 1) & 1], e,
                                                 n, rowptr);
  return cudaGetLastError();
}

// The cluster build's shared memory past the default 48 KB, granted once
// for its largest size.
cudaError_t csr_cluster_grant() {
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(csr_cluster_bytes(kCsrMaxKeys - 1)));
    if (err != cudaSuccess) return err;
    granted = true;
  }
  return cudaSuccess;
}

// The cluster build takes e edges over n rows when e <= 65536, n <= 2047
// and its shared memory, 72 (n + 1) + 12 bytes, fits in max_shared bytes.
bool csr_cluster(int e, int n, int max_shared) {
  return e <= kCsrMaxEdges && n < kCsrMaxKeys &&
         csr_cluster_bytes(n) <= max_shared;
}

// K1 with Vec (kLanes elements a lane) where F and the input pointers
// allow it, else Scalar; either writes its output one element at a time.
template <typename Vec, typename Scalar, int kLanes>
int launch_gather_mul_reduce(const Scalar* values, const Scalar* w,
                             const int* idx, Scalar* out, int n_values,
                             int n_out, int k, int f, void* stream) {
  if (n_out == 0) return 0;
  if (k < 1 || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = std::min(kMaxRowWarps,
                             (k + kSlotsPerWarp - 1) / kSlotsPerWarp);
  const dim3 block(32, warps);
  if (f % kLanes == 0 && aligned(values, sizeof(Vec)) &&
      aligned(w, sizeof(Vec))) {
    gather_mul_reduce_kernel<Vec><<<n_out, block, 0, s>>>(
        reinterpret_cast<const Vec*>(values),
        reinterpret_cast<const Vec*>(w), idx, out, n_values, k, f / kLanes);
  } else {
    gather_mul_reduce_kernel<Scalar><<<n_out, block, 0, s>>>(
        values, w, idx, out, n_values, k, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Vec, typename Scalar, int kLanes>
int launch_table_gather(const Scalar* values, const int* idx, Scalar* out,
                        int n_values, int n_edges, int f, void* stream) {
  if (n_edges == 0 || f == 0) return 0;
  if (f < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = f % kLanes == 0 && aligned(values, sizeof(Vec)) &&
                   aligned(out, sizeof(Vec));
  const int fv = vec ? f / kLanes : f;
  // 256 lanes a warp (16 rows of 16 uint4 at F = 128 in bf16, 8 of 32
  // float4 in f32), at most 32 rows
  const int rows = std::max(1, std::min(32, 32 * kGatherLanes / fv));
  const int grid = static_cast<int>((n_edges + rows - 1LL) / rows);
  if (vec) {
    table_gather_kernel<Vec><<<grid, 32, 0, s>>>(
        reinterpret_cast<const Vec*>(values), idx,
        reinterpret_cast<Vec*>(out), n_values, n_edges, fv, rows);
  } else {
    table_gather_kernel<Scalar><<<grid, 32, 0, s>>>(
        values, idx, out, n_values, n_edges, fv, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Vec, typename Scalar, int kLanes>
int launch_table_scatter(const Scalar* g, const int* order, const int* rowptr,
                         float* out, int n_out, int f, void* stream) {
  if (n_out == 0) return 0;
  if (f < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using VecAcc = typename AccOf<Vec>::type;
  const bool vec = f % kLanes == 0 && aligned(g, sizeof(Vec)) &&
                   aligned(out, sizeof(VecAcc));
  const int fv = vec ? f / kLanes : f;
  const long long warps = static_cast<long long>(n_out) * ((fv + 31) / 32);
  const int grid = static_cast<int>((warps + kScatterWarps - 1) /
                                    kScatterWarps);
  if (grid == 0) return 0;
  const int block = 32 * kScatterWarps;
  if (vec) {
    table_scatter_kernel<Vec><<<grid, block, 0, s>>>(
        reinterpret_cast<const Vec*>(g), order, rowptr,
        reinterpret_cast<VecAcc*>(out), n_out, fv);
  } else {
    table_scatter_kernel<Scalar><<<grid, block, 0, s>>>(g, order, rowptr,
                                                        out, n_out, fv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mdg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mdg_gather_mul_reduce(const float* values, const float* w, const int* idx,
                          float* out, int n_values, int n_out, int k, int f,
                          void* stream) {
  return launch_gather_mul_reduce<float4, float, 4>(values, w, idx, out,
                                                    n_values, n_out, k, f,
                                                    stream);
}

// bf16 values, w and out (their bits as unsigned short)
int mdg_gather_mul_reduce_bf16(const bf16_bits* values, const bf16_bits* w,
                               const int* idx, bf16_bits* out, int n_values,
                               int n_out, int k, int f, void* stream) {
  return launch_gather_mul_reduce<uint2, bf16_bits, 4>(values, w, idx, out,
                                                       n_values, n_out, k, f,
                                                       stream);
}

int mdg_table_gather(const float* values, const int* idx, float* out,
                     int n_values, int n_edges, int f, void* stream) {
  return launch_table_gather<float4, float, 4>(values, idx, out, n_values,
                                               n_edges, f, stream);
}

int mdg_table_gather_bf16(const bf16_bits* values, const int* idx,
                          bf16_bits* out, int n_values, int n_edges, int f,
                          void* stream) {
  return launch_table_gather<uint4, bf16_bits, 8>(values, idx, out, n_values,
                                                  n_edges, f, stream);
}

int mdg_table_scatter(const float* g, const int* order, const int* rowptr,
                      float* out, int n_out, int f, void* stream) {
  return launch_table_scatter<float2, float, 2>(g, order, rowptr, out, n_out,
                                                f, stream);
}

// bf16 g, f32 out
int mdg_table_scatter_bf16(const bf16_bits* g, const int* order,
                           const int* rowptr, float* out, int n_out, int f,
                           void* stream) {
  return launch_table_scatter<uint2, bf16_bits, 4>(g, order, rowptr, out,
                                                   n_out, f, stream);
}

// K2b's CSR inverse of idx (e,) over n rows: order (e,) and rowptr
// (n + 1,), both int32; scratch: mdg_table_index_csr_scratch(e, n) ints.
// The cluster build when e <= 65536, n <= 2047 and its shared memory,
// 72 (n + 1) + 12 bytes, fits in max_shared bytes (0 forces the grid
// build); the grid build otherwise; both give the same integers.
int mdg_table_index_csr(const int* idx, int e, int n, int* order,
                        int* rowptr, int* scratch, int max_shared,
                        void* stream) {
  if (e < 0 || n < 0 || n == INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e == 0) {
    return static_cast<int>(
        cudaMemsetAsync(rowptr, 0, sizeof(int) * (n + 1LL), s));
  }
  if (csr_cluster(e, n, max_shared)) {
    const cudaError_t err = csr_cluster_grant();
    if (err != cudaSuccess) return static_cast<int>(err);
    csr_cluster_kernel<<<kCsrCluster, kCsrThreads,
                         static_cast<size_t>(csr_cluster_bytes(n)), s>>>(
        idx, e, n, order, rowptr);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(csr_grid_build(idx, e, n, order, rowptr, scratch,
                                         s));
}

// The scratch mdg_table_index_csr needs for e edges over n rows, in ints
// (the grid build's; the cluster build takes none)
long long mdg_table_index_csr_scratch(int e, int n) {
  return csr_grid_scratch(e, n);
}

// Which build mdg_table_index_csr takes for e edges over n rows when its
// max_shared allows any size: 1 the cluster build, 0 the grid build.
int mdg_table_index_csr_cluster(int e, int n) {
  return csr_cluster(e, n, 0x7fffffff) ? 1 : 0;
}

}  // extern "C"
