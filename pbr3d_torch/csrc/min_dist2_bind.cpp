// PyTorch binding of the hand-written CUDA kernels in this directory.  The
// only file that includes PyTorch's headers: it checks the tensors, allocates
// the output, launches on the current stream and checks the launch.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

void pbr3d_min_dist2_launch(const float* A, int64_t n, const float* B, int64_t m,
                            float* out, cudaStream_t stream);

static void check_points(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.dim() == 2 && t.size(1) == 3, name, " must have shape (N, 3)");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

torch::Tensor min_dist2(const torch::Tensor& A, const torch::Tensor& B) {
  check_points(A, "A");
  check_points(B, "B");
  TORCH_CHECK(A.device() == B.device(), "A and B must be on the same device");
  const c10::cuda::CUDAGuard guard(A.device());
  auto out = torch::empty({A.size(0)}, A.options());
  if (A.size(0) == 0) return out;
  pbr3d_min_dist2_launch(A.data_ptr<float>(), A.size(0), B.data_ptr<float>(), B.size(0),
                         out.data_ptr<float>(), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("min_dist2", &min_dist2, "min_j |A[i] - B[j]|^2 for A (N,3), B (M,3) float32");
}
