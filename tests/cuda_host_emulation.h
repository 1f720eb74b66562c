// Host emulation of the CUDA subset that pbr3d_torch/csrc/lm_fit.cu and
// splat_iou.cu use, so that their source compiles with g++ and runs on the
// CPU (tests/test_torch_stage2_emulated.py).  A launch runs the grid's blocks
// one after another on blockDim std::threads; __syncthreads and the warp
// intrinsics meet at a barrier of the block's threads, which is exact for
// kernels whose every thread reaches each of them in the same order (both
// files' kernels do).  Each __*_rn intrinsic is the IEEE operation it names
// (compile with -ffp-contract=off), so the emulation computes the card's
// bits wherever the kernel's result does not depend on the order of its
// atomics.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }

namespace emu {
inline std::barrier<>* block_barrier = nullptr;
inline float fslot[1024];
inline int islot[1024];
inline std::mutex atomics;
inline unsigned warp_lane(unsigned lane) { return (threadIdx.x & ~31u) | lane; }
inline void sync() { block_barrier->arrive_and_wait(); }
}  // namespace emu

inline void __syncthreads() { emu::sync(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  emu::fslot[threadIdx.x] = v;
  emu::sync();
  const float r = emu::fslot[emu::warp_lane((threadIdx.x & 31) ^ off)];
  emu::sync();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) {
  emu::islot[threadIdx.x] = v;
  emu::sync();
  const int r = emu::islot[emu::warp_lane(src)];
  emu::sync();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  emu::islot[threadIdx.x] = p;
  emu::sync();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l) r |= static_cast<unsigned>(emu::islot[emu::warp_lane(l)] != 0) << l;
  emu::sync();
  return r;
}
inline int atomicMax(int* p, int v) {
  std::lock_guard<std::mutex> g(emu::atomics);
  const int o = *p;
  if (v > o) *p = v;
  return o;
}
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> g(emu::atomics);
  const int o = *p;
  *p += v;
  return o;
}

namespace emu {
// `kernel<<<grid, block, smem, stream>>>(args)` is rewritten to
// `emu::launch(grid, block, smem, stream).run(kernel, args)`.
struct launch {
  dim3 grid, block;
  launch(dim3 g, dim3 b, int = 0, cudaStream_t = nullptr) : grid(g), block(b) {}
  template <class F, class... A>
  void run(F kernel, A... args) {
    const unsigned n = block.x;
    std::barrier<> bar(n);
    block_barrier = &bar;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        for (unsigned z = 0; z < grid.z; ++z)
          for (unsigned y = 0; y < grid.y; ++y)
            for (unsigned x = 0; x < grid.x; ++x) {
              blockIdx = dim3(x, y, z);
              kernel(args...);
              bar.arrive_and_wait();  // the block ends before the next begins
            }
      });
    for (auto& th : threads) th.join();
  }
};
}  // namespace emu
