// Mean part IoU of candidate cameras: the splat of labelled points under
// each camera and its colour-exact per-part IoU against a ground-truth plane,
// for P cameras of each of V views.
//
// Replaces the body of pbr3d/camera/align.py:56 _candidate_iou (the exact
// route): pbr3d/ops/projection.py:54 splat_labels, then :287 partwise_iou,
// vmapped over the cameras (:69-83).  In the port it is the objective of
// the mask-IoU search, camera/align.py::_batch_iou; its plain version is
// ops/cuda_kernels.py::splat_iou_plain.
//
// The function.  Per view v and camera p: project every point n with
// cameramath.project_points (Z clamped at 1e-8), round u and v half to
// even, keep the points inside the view's true (Ht, Wt) whose `valid` is
// set; each pixel takes the label of its largest such n (the last writer),
// 0 where none lands.  Then per part k, intersection and union of
// (label == id_k) and (gt == id_k) over the whole (H, W) plane, iou_k =
// inter / union (0 for an empty union), and the mean: the left-to-right sum
// times float32(1 / K).
//
// What bounds it on an H100.  The function must read the points (12 B),
// labels and valid flags (1 B each) of every view, the ground truth (1 B a
// pixel) and the cameras, and write 4 B a camera; it does ~30 operations a
// point and camera and ~4K + 2 a pixel and camera.  So its least time is
// that of its operations, a few microseconds at the search's batches.  The
// plain version issued ~200 small launches a call (the float64 round trips
// of the emulated FMAs, an int64 key plane of H * W + 1 buckets,
// scatter_reduce, the compares and sums).  The design, three launches and a
// memset from one C call:
//
// * (a) splat, grid = (point tiles, P, V).  A block's first thread computes
//   its camera's rotation in look_at_rotation's op order into shared
//   memory.  Each thread projects its points with project_points_soa's FMAs,
//   clamps Z, rounds with rintf, tests the bounds on the rounded floats and
//   applies `valid`, then atomicMax(plane[v, p, pixel], n + 1) on an int32
//   plane where 0 is empty.  The winner of the plain version's int64 key
//   n * 256 + label under amax is the largest n, so the label is read back as
//   labels[n], and the plane is half the size of the int64 one.
// * (b) count, grid = (pixel tiles, P, V).  Per pixel the label (0 where
//   empty) and the ground truth; per part a warp ballot of the intersection
//   and of the union, counted by the part's lane, summed over the block's
//   warps in shared memory and added to counts (V, P, K, 2) int32 by one
//   atomicAdd per block and count.
// * (c) mean, a thread per (v, p): as projection.py's partwise_iou.
// * The design's own traffic: the plane cleared (4 B a pixel and camera),
//   the atomics of the in-bounds points (in L2), the plane read once by the
//   count (4 B) beside the ground truth (1 B, from L2 after the first
//   camera).
// * Rounding: __fmaf_rn where the plain version calls cameramath._fma (XLA's
//   single-rounded FMA, emulated there through float64: a pixel whose double
//   rounding differs from one true FMA can change an IoU by ~1/union, and the
//   on-card smoke counts such IoUs), __fsqrt_rn, __fdiv_rn, __fmul_rn and
//   __fsub_rn elsewhere, so nvcc contracts nothing the plain version does
//   not.
//
// Plain C interface, no PyTorch headers (see lm_fit.cu).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPointsPerThread = 4;
constexpr int kPixelsPerThread = 8;
constexpr int kMaxParts = 32;  // a part's counts live in one lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kZClamp = 1e-8f;

struct Parts {
  int id[kMaxParts];
};

// cameramath._norm
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(__fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a))));
}

// cameramath.look_at_rotation of camera c (9 floats) into R (row major).
__device__ __forceinline__ void look_at(const float* c, float tol, float* R) {
  float z0 = __fsub_rn(c[3], c[0]), z1 = __fsub_rn(c[4], c[1]), z2 = __fsub_rn(c[5], c[2]);
  const float zn = norm3(z0, z1, z2);
  z0 = __fdiv_rn(z0, zn);
  z1 = __fdiv_rn(z1, zn);
  z2 = __fdiv_rn(z2, zn);
  const bool degenerate = fabsf(__fsub_rn(fabsf(z1), 1.f)) <= tol;
  const float zero = __fsub_rn(z0, z0);
  float x0 = degenerate ? -z1 : z2, x1 = degenerate ? z0 : zero, x2 = degenerate ? zero : -z0;
  const float xn = norm3(x0, x1, x2);
  x0 = __fdiv_rn(x0, xn);
  x1 = __fdiv_rn(x1, xn);
  x2 = __fdiv_rn(x2, xn);
  R[0] = x0;
  R[1] = x1;
  R[2] = x2;
  R[3] = __fmaf_rn(z1, x2, -__fmul_rn(z2, x1));
  R[4] = __fmaf_rn(z2, x0, -__fmul_rn(z0, x2));
  R[5] = __fmaf_rn(z0, x1, -__fmul_rn(z1, x0));
  R[6] = z0;
  R[7] = z1;
  R[8] = z2;
}

__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ cams, const float* __restrict__ pts, const uint8_t* __restrict__ valid,
             const int* __restrict__ hw, int P, int N, int H, int W, float tol, int* __restrict__ plane) {
  __shared__ float s[9];
  const int64_t vp = static_cast<int64_t>(blockIdx.z) * P + blockIdx.y;
  const float* cam = cams + vp * 9;
  if (threadIdx.x == 0) look_at(cam, tol, s);
  __syncthreads();
  const float R00 = s[0], R01 = s[1], R02 = s[2], R10 = s[3], R11 = s[4], R12 = s[5];
  const float R20 = s[6], R21 = s[7], R22 = s[8];
  const float c0 = cam[0], c1 = cam[1], c2 = cam[2], f = cam[6], cx = cam[7], cy = cam[8];
  const float Ht = static_cast<float>(hw ? hw[2 * blockIdx.z] : H);
  const float Wt = static_cast<float>(hw ? hw[2 * blockIdx.z + 1] : W);
  const float* p = pts + static_cast<int64_t>(blockIdx.z) * N * 3;
  const uint8_t* ok = valid ? valid + static_cast<int64_t>(blockIdx.z) * N : nullptr;
  int* out = plane + vp * H * W;
  const int first = blockIdx.x * kThreads * kPointsPerThread + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kPointsPerThread; ++q) {
    const int n = first + q * kThreads;
    if (n >= N || (ok && !ok[n])) continue;
    const float* pn = p + 3 * static_cast<int64_t>(n);
    const float d0 = __fsub_rn(pn[0], c0), d1 = __fsub_rn(pn[1], c1), d2 = __fsub_rn(pn[2], c2);
    const float X = __fmaf_rn(R02, d2, __fmaf_rn(R00, d0, __fmul_rn(R01, d1)));
    const float Y = __fmaf_rn(R12, d2, __fmaf_rn(R10, d0, __fmul_rn(R11, d1)));
    const float Z = __fmaf_rn(R22, d2, __fmaf_rn(R20, d0, __fmul_rn(R21, d1)));
    const float Zc = Z < kZClamp ? kZClamp : Z;  // torch.clamp_min: NaN stays
    const float ur = rintf(__fmaf_rn(__fdiv_rn(X, Zc), f, cx));
    const float vr = rintf(__fmaf_rn(-__fdiv_rn(Y, Zc), f, cy));
    if (ur >= 0.f && ur < Wt && vr >= 0.f && vr < Ht)
      atomicMax(out + static_cast<int64_t>(vr) * W + static_cast<int64_t>(ur), n + 1);
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ plane, const uint8_t* __restrict__ labels, const uint8_t* __restrict__ gt,
             Parts parts, int K, int P, int N, int64_t HW, int* __restrict__ counts) {
  __shared__ int s[kWarps][kMaxParts][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t vp = static_cast<int64_t>(blockIdx.z) * P + blockIdx.y;
  const int* pl = plane + vp * HW;
  const uint8_t* g = gt + static_cast<int64_t>(blockIdx.z) * HW;
  const uint8_t* lab = labels + static_cast<int64_t>(blockIdx.z) * N;
  int my_id = -1;  // lane k < K counts part k
#pragma unroll
  for (int k = 0; k < kMaxParts; ++k)
    if (k == lane && k < K) my_id = parts.id[k];
  int inter = 0, uni = 0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kPixelsPerThread + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kPixelsPerThread; ++q) {
    const int64_t i = first + q * kThreads;
    int l = -1, t = -1;  // past the plane: no part
    if (i < HW) {
      const int w = pl[i];
      l = w > 0 ? lab[w - 1] : 0;
      t = g[i];
    }
    for (int k = 0; k < K; ++k) {
      const int id = __shfl_sync(kFull, my_id, k);
      const bool in_l = l == id, in_t = t == id;
      const unsigned both = __ballot_sync(kFull, in_l && in_t), either = __ballot_sync(kFull, in_l || in_t);
      if (lane == k) {
        inter += __popc(both);
        uni += __popc(either);
      }
    }
  }
  if (lane < K) {
    s[warp][lane][0] = inter;
    s[warp][lane][1] = uni;
  }
  __syncthreads();
  if (threadIdx.x < 2 * K) {
    const int k = threadIdx.x >> 1, c = threadIdx.x & 1;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s[w][k][c];
    if (sum) atomicAdd(counts + (vp * K + k) * 2 + c, sum);
  }
}

__global__ void __launch_bounds__(kThreads)
mean_kernel(const int* __restrict__ counts, int K, int64_t VP, float inv_k, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= VP) return;
  float total = 0.f;
  for (int k = 0; k < K; ++k) {
    const int inter = counts[(i * K + k) * 2], uni = counts[(i * K + k) * 2 + 1];
    const float iou = uni > 0 ? __fdiv_rn(static_cast<float>(inter), static_cast<float>(uni)) : 0.f;
    total = k == 0 ? iou : __fadd_rn(total, iou);
  }
  out[i] = __fmul_rn(total, inv_k);
}

}  // namespace

extern "C" {

// The most parts a call takes; the wrapper checks it.
int pbr3d_splat_iou_max_parts() { return kMaxParts; }

// Clears the scratch and launches the splat, count and mean kernels on
// `stream` without synchronising; returns the first CUDA error.  cams
// (V, P, 9), pts (V, N, 3) float32; labels, valid (V, N) uint8 (valid may be
// null: every point); hw (V, 2) int32 true (Ht, Wt) inside the (H, W)
// allocation (null: (H, W)); gt (V, H, W) uint8; part_ids K host ints;
// scratch V * P * (H * W + 2K) int32; out (V, P) float32.
int pbr3d_splat_iou(const float* cams, const float* pts, const uint8_t* labels, const uint8_t* valid,
                    const int* hw, const uint8_t* gt, const int* part_ids, int K, int V, int P, int N, int H,
                    int W, float tol, int* scratch, float* out, cudaStream_t stream) {
  if (V <= 0 || V > 65535 || P <= 0 || P > 65535 || N < 0 || N == 0x7fffffff || H <= 0 || W <= 0 || K <= 0 ||
      K > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t HW = static_cast<int64_t>(H) * W, VP = static_cast<int64_t>(V) * P;
  const int64_t point_tiles = (N + kThreads * kPointsPerThread - 1) / (kThreads * kPointsPerThread);
  const int64_t pixel_tiles = (HW + kThreads * kPixelsPerThread - 1) / (kThreads * kPixelsPerThread);
  if (point_tiles > 0x7fffffff || pixel_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Parts parts{};
  for (int k = 0; k < K; ++k) parts.id[k] = part_ids[k];
  int* counts = scratch + VP * HW;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * VP * (HW + 2 * K), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0)
    splat_kernel<<<dim3(static_cast<unsigned>(point_tiles), P, V), kThreads, 0, stream>>>(
        cams, pts, valid, hw, P, N, H, W, tol, scratch);
  count_kernel<<<dim3(static_cast<unsigned>(pixel_tiles), P, V), kThreads, 0, stream>>>(
      scratch, labels, gt, parts, K, P, N, HW, counts);
  mean_kernel<<<static_cast<unsigned>((VP + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      counts, K, VP, 1.0f / static_cast<float>(K), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
