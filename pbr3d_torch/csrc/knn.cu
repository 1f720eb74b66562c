// k nearest neighbours: for each row of A the k smallest squared distances
// |A[i] - B[j]|^2 (float32, direct difference) and their indices j, ascending,
// exact ties to the lower index.
//
// The second kernel of the min-dist family (csrc/min_dist2.cu).  It has no
// TPU kernel behind it: it replaces the XLA program
// pbr3d/ops/neighbors.py:122 _knn_padded (a tiled |a|^2 + |b|^2 - 2 a.b
// matmul with lax.top_k), the engine of ICP, the NN-regularity statistics,
// the surface metrics' neighbourhoods and the mesh vertex colours.
//
// What bounds it on an H100: FP32 issue slots, as for min_dist2.  A pair
// costs 3 FSUB, 1 FMUL, 2 FFMA and the compare against the list's last
// entry; on top comes the list upkeep, which depends on the data (a query
// inserts about k ln(M / k) times on points in random order, and a warp runs
// the insertion whenever one of its lanes does).  Bytes are negligible.
//
// Design (a first one: right and simple, then parallel enough to fill the card):
//
// * One thread a query.  Its k-list (distances and int32 indices) is two
//   arrays of the compile-time capacity K, every loop over them fully
//   unrolled, so the list lives in registers.  K is the smallest of
//   1, 2, 4, 8, 16, 20, 32 that holds k.
// * The list is ordered by (distance, index), a total order.  An insertion is
//   one pass of compare-and-swap over the K slots carrying the displaced
//   entry along.  Because the order is total, the result does not depend on
//   the order in which candidates arrive, which is what lets B be split.
// * B is packed once into float4, padded with +inf points, and split into
//   chunks (grid y) so that a few thousand queries still fill 132 SMs; a
//   block streams its chunk through two shared tiles with cp.async, as
//   min_dist2 does.  Every chunk writes its own k-list; a second kernel
//   merges the chunk lists of a query with the same insertion, and writes the
//   first k entries out (indices as int64).  Entries that were never filled,
//   or lie at an infinite distance, point at the query's nearest neighbour
//   (the JAX package's rule for k > M, pbr3d/ops/neighbors.py:157-159).
//
// The distance is min_dist2's arithmetic exactly, so knn with k = 1 returns
// min_dist2's bits.
//
// Plain C interface, no PyTorch headers; the wrapper
// (ops/cuda_kernels.py::knn_kernel) checks the tensors, allocates output and
// scratch, passes the current stream and raises on a non-zero return.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTile = 512;     // B points per shared tile (8 KB)
constexpr int kUnroll = 4;     // B points per step; chunks and tiles are multiples of it
constexpr int kNone = 0x7fffffff;
constexpr int kPackThreads = 256;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void copy_async(float4* dst, const float4* src, int count) {
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst + t));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + t));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// (d, i) sorts before (e, j).
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert (d, i) into the ascending list; the last entry falls out.
template <int K>
__device__ __forceinline__ void insert(float (&ld)[K], int (&li)[K], float d, int i) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (before(d, i, ld[s], li[s])) {
      const float td = ld[s];
      const int ti = li[s];
      ld[s] = d;
      li[s] = i;
      d = td;
      i = ti;
    }
  }
}

// B4[i] = (B[i], 0) for i < m and +inf points up to m_pad.
__global__ void __launch_bounds__(kPackThreads)
knn_pack_kernel(const float* __restrict__ B, int64_t m, int64_t m_pad, float4* __restrict__ B4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPackThreads + threadIdx.x;
  const float inf = pos_inf();
  if (i < m_pad)
    B4[i] = i < m ? make_float4(B[3 * i], B[3 * i + 1], B[3 * i + 2], 0.f)
                  : make_float4(inf, inf, inf, inf);
}

// Chunk blockIdx.y's k-list of every query, into part_d / part_i laid out
// [chunk][slot][query].
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_scan_kernel(const float* __restrict__ A, int64_t n, const float4* __restrict__ B4,
                int64_t m_pad, int64_t chunk_len, float* __restrict__ part_d,
                int* __restrict__ part_i) {
  __shared__ __align__(16) float4 tile[2][kTile];

  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool ok = i < n;
  const float ax = ok ? A[3 * i + 0] : 0.f;
  const float ay = ok ? A[3 * i + 1] : 0.f;
  const float az = ok ? A[3 * i + 2] : 0.f;
  float ld[K];
  int li[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ld[s] = pos_inf();
    li[s] = kNone;
  }

  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk_len;
  const int len = static_cast<int>(m_pad - j0 < chunk_len ? m_pad - j0 : chunk_len);
  const int tiles = (len + kTile - 1) / kTile;
  copy_async(tile[0], B4 + j0, len < kTile ? len : kTile);
  for (int k = 0; k < tiles; ++k) {
    const int rest = len - k * kTile;
    if (k + 1 < tiles) {
      const int next = rest - kTile;
      copy_async(tile[(k + 1) & 1], B4 + j0 + static_cast<int64_t>(k + 1) * kTile,
                 next < kTile ? next : kTile);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile k has landed for every thread
    const float4* b = tile[k & 1];
    const int count = rest < kTile ? rest : kTile;
    const int base = static_cast<int>(j0) + k * kTile;
    for (int t = 0; t < count; t += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 p = b[t + u];
        const float dx = ax - p.x;
        const float dy = ay - p.y;
        const float dz = az - p.z;
        const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        // candidates arrive by ascending index, so one that ties the last
        // entry sorts after it
        if (d < ld[K - 1]) insert<K>(ld, li, d, base + t + u);
      }
    }
    __syncthreads();  // tile k is consumed before the prefetch of tile k + 2 overwrites it
  }

  if (ok) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int64_t at = (static_cast<int64_t>(blockIdx.y) * K + s) * n + i;
      part_d[at] = ld[s];
      part_i[at] = li[s];
    }
  }
}

// Merge the chunk lists of each query and write its first k entries.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i, int64_t n,
                 int chunks, int k, float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float ld[K];
  int li[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ld[s] = part_d[static_cast<int64_t>(s) * n + i];
    li[s] = part_i[static_cast<int64_t>(s) * n + i];
  }
  for (int c = 1; c < chunks; ++c) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int64_t at = (static_cast<int64_t>(c) * K + s) * n + i;
      const float d = part_d[at];
      const int j = part_i[at];
      if (before(d, j, ld[K - 1], li[K - 1])) insert<K>(ld, li, d, j);
    }
  }
  const int nearest = li[0] == kNone ? 0 : li[0];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      const bool finite = ld[s] < pos_inf();
      out_d[i * k + s] = finite ? ld[s] : pos_inf();
      out_i[i * k + s] = finite ? li[s] : nearest;
    }
  }
}

template <int K>
cudaError_t launch(const float* A, int64_t n, const float4* b4, int64_t m_pad, int64_t chunk_len,
                   int chunks, float* part_d, int* part_i, int k, float* out_d, int64_t* out_i,
                   cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  knn_scan_kernel<K><<<dim3(blocks, static_cast<unsigned int>(chunks)), kThreads, 0, stream>>>(
      A, n, b4, m_pad, chunk_len, part_d, part_i);
  knn_merge_kernel<K><<<blocks, kThreads, 0, stream>>>(part_d, part_i, n, chunks, k, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Queries one block covers, and the B points per step (the padding and chunk
// granularity the kernel needs); the wrapper's launch plan must agree.
int pbr3d_knn_queries_per_block() { return kThreads; }
int pbr3d_knn_b_step() { return kUnroll; }

// The list capacity the kernel takes for k neighbours (0 when k is out of
// range): the wrapper sizes the scratch with it.
int pbr3d_knn_capacity(int k) {
  const int caps[] = {1, 2, 4, 8, 16, 20, 32};
  if (k < 1) return 0;
  for (int c : caps)
    if (k <= c) return c;
  return 0;
}

// Launches the pack, the scan and the merge on `stream` without
// synchronising and returns cudaGetLastError().  A (n, 3) and B (m, 3)
// float32, n > 0, m > 0; B4 scratch for (m_pad, 4) float32, m_pad = m rounded
// up to a multiple of kUnroll; chunk_len a positive multiple of kUnroll;
// part_d / part_i scratch for chunks * capacity(k) * n float32 / int32 with
// chunks = ceil(m_pad / chunk_len); out_d (n, k) float32 squared distances,
// out_i (n, k) int64.
int pbr3d_knn(const float* A, int64_t n, const float* B, int64_t m, float* B4, int64_t m_pad,
              int64_t chunk_len, float* part_d, int* part_i, int k, float* out_d, int64_t* out_i,
              cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t chunks = chunk_len > 0 ? (m_pad + chunk_len - 1) / chunk_len : 0;
  const int64_t pack_blocks = (m_pad + kPackThreads - 1) / kPackThreads;
  const int cap = pbr3d_knn_capacity(k);
  if (n <= 0 || m <= 0 || m_pad % kUnroll || m_pad < m || m_pad - m >= kUnroll ||
      m_pad >= 0x7fffffff || chunk_len <= 0 || chunk_len % kUnroll || blocks > 0x7fffffff ||
      pack_blocks > 0x7fffffff || chunks > 65535 || cap == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float4* b4 = reinterpret_cast<float4*>(B4);
  knn_pack_kernel<<<static_cast<unsigned int>(pack_blocks), kPackThreads, 0, stream>>>(B, m, m_pad,
                                                                                     b4);
  const int c = static_cast<int>(chunks);
  cudaError_t err = cudaErrorInvalidValue;
  switch (cap) {
    case 1: err = launch<1>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
    case 2: err = launch<2>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
    case 4: err = launch<4>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
    case 8: err = launch<8>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
    case 16: err = launch<16>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
    case 20: err = launch<20>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
    case 32: err = launch<32>(A, n, b4, m_pad, chunk_len, c, part_d, part_i, k, out_d, out_i, stream); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
