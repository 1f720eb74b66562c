// k nearest neighbours: for each row of A the k smallest squared distances
// |A[i] - B[j]|^2 (float32, direct difference) and their indices j, ascending,
// exact ties to the lower index.
//
// The second kernel of the min-dist family (csrc/min_dist2.cu).  It has no
// TPU kernel behind it: it replaces the XLA program
// pbr3d/ops/neighbors.py:122 _knn_padded (a tiled |a|^2 + |b|^2 - 2 a.b
// matmul with lax.top_k), the engine of ICP and the mesh vertex colours
// (k = 1), the NN-regularity statistics (k = 2) and the surface metrics'
// neighbourhoods (k = 20).
//
// What bounds it on an H100: FP32 issue slots, as for min_dist2.  A pair
// costs 3 FSUB, 1 FMUL, 2 FFMA and one compare or min, 7 warp-lane
// instructions at 4 x 32 a clock an SM; the wrapper's bound counts those
// and leaves the list upkeep out (it depends on the data: a query meets
// about k ln(M / k) candidates that enter its list), so the bound errs low.
// Bytes are negligible (16 a B point, 12 a query, 12 a result entry).
//
// Design:
//
// * Register tiling, as min_dist2.  A thread holds Q queries (8 at k = 1, 4
//   at capacities 2 and 4, 2 up to 20, 1 at 32) and their lists in
//   registers; one broadcast 16-byte shared load of a B point feeds Q
//   pairs, and the B loop runs in groups of kGroup points, so Q x kGroup
//   independent chains hide the FMA latency.  B is packed once into float4
//   (+inf points pad it to a multiple of kGroup) and a block's chunk streams
//   through two shared tiles with 16-byte cp.async.
// * Capacity 1 (k = 1): no list and no merge kernel.  A query keeps its
//   running minimum by fminf, exactly min_dist2's loop, and per group only
//   notes the group in which the minimum last fell strictly (a select).
//   The nearest point's index is the first point of that group at the
//   minimum: every earlier point lies strictly above it.  After the chunk,
//   the thread rescans that group (kGroup points, from L2) for the index.
//   Chunks merge by a 64-bit atomicMin on the key (distance bits << 32) | j
//   in the int64 output, which the pack kernel fills with all ones: a
//   non-negative float32 orders as its bits, so the key's order is
//   (distance, index), total, and the result does not depend on which chunk
//   lands first.  A last small pass splits the keys into distances and
//   indices.  The distances are min_dist2's bits.
// * Capacities 2 to 32: the insertion leaves the warp's common path.  Per
//   pair a thread compares the distance against its threshold (the list's
//   last entry at the last drain) and sets the point's bit in the group's
//   mask: a compare and a predicated or (inline PTX), 8 instructions a pair
//   with the distance.  Per group a query with candidates appends one entry,
//   (offset in the tile << 8) | mask, to its queue in shared memory.  Before
//   a group, when any lane of the warp has a full queue (__any_sync), and at
//   the end of every tile, the whole warp drains its queues at once: each
//   marked point's distance again from the tile, then a select chain into
//   the list.  Lists are ordered by (distance, index); inside a chunk
//   candidates arrive by ascending index, so a new entry goes after the
//   entries at its distance and strict compares keep ties at the lower
//   index.  The lists come out as with one insertion per candidate: the
//   order is total.  Each chunk restarts its lists, so a chunk costs a
//   restart besides its points; the launch plan does not count it.
// * Capacities 2 to 32 write one list per chunk to scratch laid out
//   [chunk][slot][query]; a second kernel merges a query's chunk lists by
//   compare-and-swap on the full (distance, index) order, O(chunks x K) a
//   query, and writes the first k entries (indices int64).
// * The grid is query tiles x B chunks; the wrapper's launch plan
//   (ops/cuda_kernels.py::knn_launch_plan) takes the chunk count from the
//   card's SMs and each instantiation's resident blocks per SM
//   (pbr3d_knn_blocks_per_sm), by min_dist2's rule.
// * Entries that were never filled, or lie at an infinite distance, point
//   at the query's nearest neighbour (the JAX package's rule for k > M,
//   pbr3d/ops/neighbors.py:157-159), index 0 where there is none.
//
// What the card offers and this kernel leaves alone: tensor cores.  The
// depth is 3, and the expansion |a|^2 + |b|^2 - 2 a.b a product would need
// (TF32, or FP32 through wgmma) loses the bits k = 1 shares with min_dist2
// and the exact tie order on integer lattices that the notebook-4/5 parity
// rests on.  TMA would save about one instruction per 128 B points.
//
// Plain C interface, no PyTorch headers; the wrapper
// (ops/cuda_kernels.py::knn_kernel) checks the tensors, allocates output and
// scratch, passes the current stream and raises on a non-zero return.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 512;     // B points per shared tile (8 KB)
constexpr int kGroup = 8;      // B points per step; chunks and tiles are multiples of it
constexpr int kQueue = 8;      // queue entries (groups) per query at capacities 2 to 32
constexpr int kNone = 0x7fffffff;
constexpr int kPackThreads = 256;
constexpr unsigned long long kNoKey = ~0ull;

// Queries a thread holds at list capacity K.
__host__ __device__ constexpr int queries_per_thread(int K) {
  return K == 1 ? 8 : K <= 4 ? 4 : K <= 20 ? 2 : 1;
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float dist2(float ax, float ay, float az, float4 p) {
  const float dx = ax - p.x;
  const float dy = ay - p.y;
  const float dz = az - p.z;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

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

// Insert (d, i) into the ascending list by compare-and-swap on the full
// order; the last entry falls out.  Any arrival order.
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

// Insert (d, j), whose index is above every listed one, after the entries
// at its distance: a select chain from the tail; the last entry falls out.
template <int K>
__device__ __forceinline__ void push(float (&ld)[K], int (&li)[K], float d, int j) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool shift = d < ld[s - 1];  // the entry above moves down
    const bool here = d < ld[s];       // else the new entry lands here
    ld[s] = shift ? ld[s - 1] : (here ? d : ld[s]);
    li[s] = shift ? li[s - 1] : (here ? j : li[s]);
  }
  const bool first = d < ld[0];
  ld[0] = first ? d : ld[0];
  li[0] = first ? j : li[0];
}

// B4[i] = (B[i], 0) for i < m and +inf points up to m_pad; keys[i] = all ones
// for i < n where keys is given.
__global__ void __launch_bounds__(kPackThreads)
knn_pack_kernel(const float* __restrict__ B, int64_t m, int64_t m_pad, float4* __restrict__ B4,
                unsigned long long* __restrict__ keys, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPackThreads + threadIdx.x;
  const float inf = pos_inf();
  if (i < m_pad)
    B4[i] = i < m ? make_float4(B[3 * i], B[3 * i + 1], B[3 * i + 2], 0.f)
                  : make_float4(inf, inf, inf, inf);
  if (keys != nullptr && i < n) keys[i] = kNoKey;
}

// Starts the chunk's first tile; returns the chunk's first point and length.
__device__ __forceinline__ int64_t chunk_start(float4 (&tile)[2][kTile], const float4* B4,
                                               int64_t m_pad, int64_t chunk_len, int* len) {
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * chunk_len;
  *len = static_cast<int>(m_pad - j0 < chunk_len ? m_pad - j0 : chunk_len);
  copy_async(tile[0], B4 + j0, *len < kTile ? *len : kTile);
  return j0;
}

// Waits for tile k and prefetches tile k + 1; returns tile k's point count.
__device__ __forceinline__ int tile_wait(float4 (&tile)[2][kTile], const float4* B4, int64_t j0,
                                         int len, int tiles, int k) {
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
  return rest < kTile ? rest : kTile;
}

// k = 1: the nearest point of chunk blockIdx.y for Q queries a thread,
// merged into keys by atomicMin on (distance bits << 32) | j.
template <int Q>
__global__ void __launch_bounds__(kThreads, 4)
knn1_scan_kernel(const float* __restrict__ A, int64_t n, const float4* __restrict__ B4,
                 int64_t m_pad, int64_t chunk_len, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float4 tile[2][kTile];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * Q) + threadIdx.x;
  float ax[Q], ay[Q], az[Q], best[Q];
  int group[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = first + static_cast<int64_t>(q) * kThreads;
    const bool ok = i < n;
    ax[q] = ok ? A[3 * i + 0] : 0.f;
    ay[q] = ok ? A[3 * i + 1] : 0.f;
    az[q] = ok ? A[3 * i + 2] : 0.f;
    best[q] = pos_inf();
    group[q] = 0;
  }

  int len;
  const int64_t j0 = chunk_start(tile, B4, m_pad, chunk_len, &len);
  const int tiles = (len + kTile - 1) / kTile;
  for (int k = 0; k < tiles; ++k) {
    const int count = tile_wait(tile, B4, j0, len, tiles, k);
    const float4* b = tile[k & 1];
    const int base = static_cast<int>(j0) + k * kTile;
    for (int t = 0; t < count; t += kGroup) {
      float was[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) was[q] = best[q];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 p = b[t + u];
#pragma unroll
        for (int q = 0; q < Q; ++q) best[q] = fminf(best[q], dist2(ax[q], ay[q], az[q], p));
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) group[q] = best[q] < was[q] ? base + t : group[q];
    }
    __syncthreads();  // tile k is consumed before the prefetch of tile k + 2 overwrites it
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = first + static_cast<int64_t>(q) * kThreads;
    if (i < n && best[q] < pos_inf()) {
      int j = group[q];
#pragma unroll 1
      for (int u = 0; u < kGroup; ++u) {
        if (dist2(ax[q], ay[q], az[q], B4[j + u]) == best[q]) {
          j += u;
          break;
        }
      }
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(best[q])) << 32) | static_cast<unsigned int>(j);
      atomicMin(keys + i, key);
    }
  }
}

// k = 1: keys, in place in the int64 output, to distances and indices.
__global__ void __launch_bounds__(kThreads)
knn1_finish_kernel(int64_t n, float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = static_cast<unsigned long long>(out_i[i]);
  const bool found = key != kNoKey;
  out_d[i] = found ? __uint_as_float(static_cast<unsigned int>(key >> 32)) : pos_inf();
  out_i[i] = found ? static_cast<int64_t>(key & 0xffffffffull) : 0;
}

// Sets `bit` in *mask when d < thr: a compare and a predicated or.
__device__ __forceinline__ void note(unsigned int* mask, float d, float thr, unsigned int bit) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f32 p, %1, %2;\n\t"
      "@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(*mask)
      : "f"(d), "f"(thr), "r"(bit));
}

// Appends `entry` to a query's queue at shared address *at, and moves *at
// on, when the group's mask is not empty.
template <int Q>
__device__ __forceinline__ void append(unsigned int* at, unsigned int mask, unsigned int entry) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "@p st.shared.u32 [%0], %2;\n\t"
      "@p add.u32 %0, %0, %3;\n\t}"
      : "+r"(*at)
      : "r"(mask), "r"(entry), "n"(Q * kThreads * 4));
}

// The warp drains every queue into its list and refreshes the thresholds.
// An entry is a group of the tile, (offset << 8) | mask of its candidates;
// their distances come again from the tile, in ascending order.
template <int K, int Q>
__device__ __forceinline__ void drain(float (&ld)[Q][K], int (&li)[Q][K], unsigned int (&at)[Q],
                                      float (&thr)[Q], const float (&ax)[Q], const float (&ay)[Q],
                                      const float (&az)[Q], unsigned int start, const float4* b,
                                      int base) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const unsigned int first = start + q * kThreads * 4;
#pragma unroll 1
    for (unsigned int a = first; a < at[q]; a += Q * kThreads * 4) {
      unsigned int e;
      asm volatile("ld.shared.u32 %0, [%1];" : "=r"(e) : "r"(a));
      const int t = static_cast<int>(e >> 8);
#pragma unroll 1
      for (unsigned int m = e & 0xffu; m; m &= m - 1) {
        const int u = t + __ffs(m) - 1;
        const float d = dist2(ax[q], ay[q], az[q], b[u]);
        if (d < ld[q][K - 1]) push<K>(ld[q], li[q], d, base + u);
      }
    }
    at[q] = first;
    thr[q] = ld[q][K - 1];
  }
}

// Capacities 2 to 32: chunk blockIdx.y's k-list of every query, into
// part_d / part_i laid out [chunk][slot][query].
template <int K, int Q>
__global__ void __launch_bounds__(kThreads, K <= 4 ? 4 : 3)
knn_scan_kernel(const float* __restrict__ A, int64_t n, const float4* __restrict__ B4,
                int64_t m_pad, int64_t chunk_len, float* __restrict__ part_d,
                int* __restrict__ part_i) {
  static_assert(kGroup <= 8 && kTile <= (1 << 24), "a queue entry is (offset << 8) | 8-bit mask");
  __shared__ __align__(16) float4 tile[2][kTile];
  // queue[e][q][thread]: groups of the tile with candidates, kQueue a query
  __shared__ unsigned int queue[kQueue * Q * kThreads];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * Q) + threadIdx.x;
  const unsigned int start = static_cast<unsigned int>(__cvta_generic_to_shared(queue + threadIdx.x));
  float ax[Q], ay[Q], az[Q], thr[Q];
  float ld[Q][K];
  int li[Q][K];
  unsigned int at[Q];  // shared address of a query's next queue entry
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = first + static_cast<int64_t>(q) * kThreads;
    const bool ok = i < n;
    ax[q] = ok ? A[3 * i + 0] : 0.f;
    ay[q] = ok ? A[3 * i + 1] : 0.f;
    az[q] = ok ? A[3 * i + 2] : 0.f;
    thr[q] = pos_inf();
    at[q] = start + q * kThreads * 4;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      ld[q][s] = pos_inf();
      li[q][s] = kNone;
    }
  }
  constexpr unsigned int kFull = (kQueue - 1) * Q * kThreads * 4;  // a queue with no room left

  int len;
  const int64_t j0 = chunk_start(tile, B4, m_pad, chunk_len, &len);
  const int tiles = (len + kTile - 1) / kTile;
  for (int k = 0; k < tiles; ++k) {
    const int count = tile_wait(tile, B4, j0, len, tiles, k);
    const float4* b = tile[k & 1];
    const int base = static_cast<int>(j0) + k * kTile;
    for (int t = 0; t < count; t += kGroup) {
      bool full = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) full |= at[q] - (start + q * kThreads * 4) > kFull;
      if (__any_sync(0xffffffffu, full)) drain<K, Q>(ld, li, at, thr, ax, ay, az, start, b, base);
      unsigned int mask[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) mask[q] = 0;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float4 p = b[t + u];
#pragma unroll
        for (int q = 0; q < Q; ++q) note(&mask[q], dist2(ax[q], ay[q], az[q], p), thr[q], 1u << u);
      }
      const unsigned int offset = static_cast<unsigned int>(t) << 8;
#pragma unroll
      for (int q = 0; q < Q; ++q) append<Q>(&at[q], mask[q], offset | mask[q]);
    }
    drain<K, Q>(ld, li, at, thr, ax, ay, az, start, b, base);
    __syncthreads();  // tile k is consumed before the prefetch of tile k + 2 overwrites it
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t i = first + static_cast<int64_t>(q) * kThreads;
    if (i < n) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int64_t at_ = (static_cast<int64_t>(blockIdx.y) * K + s) * n + i;
        part_d[at_] = ld[q][s];
        part_i[at_] = li[q][s];
      }
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
  constexpr int Q = queries_per_thread(K);
  const unsigned int tiles = static_cast<unsigned int>((n + kThreads * Q - 1) / (kThreads * Q));
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  if constexpr (K == 1) {
    knn1_scan_kernel<Q><<<dim3(tiles, static_cast<unsigned int>(chunks)), kThreads, 0, stream>>>(
        A, n, b4, m_pad, chunk_len, reinterpret_cast<unsigned long long*>(out_i));
    knn1_finish_kernel<<<blocks, kThreads, 0, stream>>>(n, out_d, out_i);
  } else {
    knn_scan_kernel<K, Q><<<dim3(tiles, static_cast<unsigned int>(chunks)), kThreads, 0, stream>>>(
        A, n, b4, m_pad, chunk_len, part_d, part_i);
    knn_merge_kernel<K><<<blocks, kThreads, 0, stream>>>(part_d, part_i, n, chunks, k, out_d, out_i);
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t blocks_per_sm(int* blocks) {
  constexpr int Q = queries_per_thread(K);
  if constexpr (K == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, knn1_scan_kernel<Q>, kThreads, 0);
  else
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, knn_scan_kernel<K, Q>, kThreads, 0);
}

}  // namespace

extern "C" {

// The list capacity the kernel takes for k neighbours (0 when k is out of
// range): the wrapper sizes the scratch and the launch plan with it.
int pbr3d_knn_capacity(int k) {
  const int caps[] = {1, 2, 4, 8, 16, 20, 32};
  if (k < 1) return 0;
  for (int c : caps)
    if (k <= c) return c;
  return 0;
}

// Queries one block covers at a capacity (0 for no capacity), and the B
// points per step (the padding and chunk granularity); the wrapper's launch
// plan must agree.
int pbr3d_knn_queries_per_block(int capacity) {
  return pbr3d_knn_capacity(capacity) == capacity ? kThreads * queries_per_thread(capacity) : 0;
}
int pbr3d_knn_b_step() { return kGroup; }

// Resident blocks per SM of the scan kernel at a capacity on the current
// device, into *blocks.
int pbr3d_knn_blocks_per_sm(int capacity, int* blocks) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (pbr3d_knn_capacity(capacity) == capacity ? capacity : 0) {
    case 1: err = blocks_per_sm<1>(blocks); break;
    case 2: err = blocks_per_sm<2>(blocks); break;
    case 4: err = blocks_per_sm<4>(blocks); break;
    case 8: err = blocks_per_sm<8>(blocks); break;
    case 16: err = blocks_per_sm<16>(blocks); break;
    case 20: err = blocks_per_sm<20>(blocks); break;
    case 32: err = blocks_per_sm<32>(blocks); break;
  }
  return static_cast<int>(err);
}

// Launches the pack, the scan and the merge (k = 1: the finish) on `stream`
// without synchronising and returns cudaGetLastError().  A (n, 3) and B
// (m, 3) float32, n > 0, m > 0; B4 scratch for (m_pad, 4) float32, m_pad = m
// rounded up to a multiple of kGroup; chunk_len a positive multiple of
// kGroup; for k > 1 part_d / part_i scratch for chunks * capacity(k) * n
// float32 / int32 with chunks = ceil(m_pad / chunk_len) (unused at k = 1);
// out_d (n, k) float32 squared distances, out_i (n, k) int64.
int pbr3d_knn(const float* A, int64_t n, const float* B, int64_t m, float* B4, int64_t m_pad,
              int64_t chunk_len, float* part_d, int* part_i, int k, float* out_d, int64_t* out_i,
              cudaStream_t stream) {
  const int cap = pbr3d_knn_capacity(k);
  const int64_t per_block = cap ? kThreads * queries_per_thread(cap) : 1;
  const int64_t tiles = (n + per_block - 1) / per_block;
  const int64_t chunks = chunk_len > 0 ? (m_pad + chunk_len - 1) / chunk_len : 0;
  const int64_t pack_n = cap == 1 && n > m_pad ? n : m_pad;
  const int64_t pack_blocks = (pack_n + kPackThreads - 1) / kPackThreads;
  if (n <= 0 || m <= 0 || m_pad % kGroup || m_pad < m || m_pad - m >= kGroup ||
      m_pad >= 0x7fffffff || chunk_len <= 0 || chunk_len % kGroup || tiles > 0x7fffffff ||
      (n + kThreads - 1) / kThreads > 0x7fffffff || pack_blocks > 0x7fffffff || chunks > 65535 ||
      cap == 0 || (cap > 1 && (part_d == nullptr || part_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float4* b4 = reinterpret_cast<float4*>(B4);
  knn_pack_kernel<<<static_cast<unsigned int>(pack_blocks), kPackThreads, 0, stream>>>(
      B, m, m_pad, b4, cap == 1 ? reinterpret_cast<unsigned long long*>(out_i) : nullptr, n);
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
