// Keypoint Levenberg-Marquardt camera fit, the whole loop in one launch.
//
// Replaces pbr3d/camera/estimate.py:77 _lm_fit (a jax.lax.while_loop over
// jax.jacfwd, the normal equations at Precision.HIGHEST and
// jnp.linalg.solve).  The port's plain version is
// ops/cuda_kernels.py::lm_fit_plain: forward-mode AD in PyTorch, two batched
// residual evaluations and a LAPACK solve a step.
//
// The function.  Per fit v of V: x (9: cam_pos, target, f, cx, cy) from
// x0[v]; up to max_iters steps, each of which stops the loop once
// |delta| <= 1e-10 or is NaN: residuals r of the K keypoints (u, v per
// keypoint, times the keypoint's mask; for L1 the smoothed
// sqrt(r^2 + 1e-12) * mask, and LM runs on sqrt(|r| + 1e-12)), their
// Jacobian J (2K x 9), delta from (J^T J + lambda I) delta = -J^T r, x_new =
// clip(x + delta, lo, hi), accept when loss(x_new) < loss(x) (loss: sum r^2,
// or sum |r| for L1), lambda times 0.5 or 4 clipped to [1e-8, 1e12].  Out:
// x, loss(x) and the steps taken.
//
// What bounds it on an H100: latency.  A fit is a serial chain of up to 200
// steps over a handful of keypoints (6 on the study's views: R = 12
// residuals), a 9 x 9 solve and a loss; its operations and bytes are
// nanoseconds of the card at any V.  The plain version issued ~40 small
// launches a step, ~8,000 a fit, behind one process-wide forward-AD lock.
// The design:
//
// * One block a fit, one warp a block, grid = V fits.  The whole loop runs
//   in the kernel.  Every lane holds the same state (x, lambda, loss,
//   |delta|) and takes the same branches, so the early stop is uniform, and
//   it falls at the step where the plain version freezes its state.
// * The Jacobian by forward-mode dual numbers in registers, through the op
//   sequence of ops/cameramath.py::project_points: look_at_rotation (_norm,
//   the degenerate-up test, _cross), the clamp of Z (tangent 0 below it), the
//   two divisions and the u/v FMAs.  The rotation is a function of
//   target - cam_pos alone, so it carries 3 tangents (its cam_pos tangents
//   are their negation, exactly) and is computed once a step; a keypoint
//   carries 6 (cam_pos, target), and f, cx, cy enter u and v in closed form.
//   The Jacobian is the plain version's forward-AD one up to rounding.
// * Keypoints spread over the warp's lanes (any K: a lane loops over
//   k = lane, lane + 32, ...); J^T J (45), J^T r (9) and the loss reduce by
//   an xor butterfly of shuffles, which leaves the same bits on every lane
//   (float addition commutes).
// * delta by LU with partial pivoting (LAPACK getrf's factorisation, which
//   torch.linalg.solve_ex and jnp.linalg.solve call), fully unrolled in
//   registers, row swaps as predicated moves.  A zero pivot gives inf/NaN in
//   delta as the library does; NaN ends the loop.
// * Rounding: __fmaf_rn where the plain version calls cameramath._fma (XLA's
//   single-rounded FMA, emulated there through float64), __fmul_rn,
//   __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn elsewhere, so nvcc
//   contracts nothing the plain version does not.
//
// Plain C interface, no PyTorch headers: built by nvcc into the kernels'
// shared library and called through ctypes (ops/cuda_kernels.py), which
// checks the tensors, allocates the outputs, passes the current stream and
// raises on a non-zero return.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp a fit
constexpr int kN = 9;         // camera parameters
constexpr int kSym = kN * (kN + 1) / 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kZClamp = 1e-8f;
constexpr float kSmooth = 1e-12f;

// A value and T tangents (T = 0: the value alone).
template <int T>
struct Dual {
  float v;
  float t[T > 0 ? T : 1];
};

template <int T>
__device__ __forceinline__ Dual<T> dsub(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = __fsub_rn(a.v, b.v);
#pragma unroll
  for (int i = 0; i < T; ++i) r.t[i] = __fsub_rn(a.t[i], b.t[i]);
  return r;
}

template <int T>
__device__ __forceinline__ Dual<T> dneg(const Dual<T>& a) {
  Dual<T> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < T; ++i) r.t[i] = -a.t[i];
  return r;
}

template <int T>
__device__ __forceinline__ Dual<T> dmul(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = __fmul_rn(a.v, b.v);
#pragma unroll
  for (int i = 0; i < T; ++i) r.t[i] = __fmaf_rn(a.t[i], b.v, __fmul_rn(a.v, b.t[i]));
  return r;
}

// cameramath._fma(a, b, c): a * b + c rounded once.
template <int T>
__device__ __forceinline__ Dual<T> dfma(const Dual<T>& a, const Dual<T>& b, const Dual<T>& c) {
  Dual<T> r;
  r.v = __fmaf_rn(a.v, b.v, c.v);
#pragma unroll
  for (int i = 0; i < T; ++i) r.t[i] = __fmaf_rn(a.t[i], b.v, __fmaf_rn(a.v, b.t[i], c.t[i]));
  return r;
}

template <int T>
__device__ __forceinline__ Dual<T> ddiv(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = __fdiv_rn(a.v, b.v);
#pragma unroll
  for (int i = 0; i < T; ++i) r.t[i] = __fdiv_rn(__fsub_rn(a.t[i], __fmul_rn(b.t[i], r.v)), b.v);
  return r;
}

template <int T>
__device__ __forceinline__ Dual<T> dsqrt(const Dual<T>& a) {
  Dual<T> r;
  r.v = __fsqrt_rn(a.v);
  const float two_r = __fmul_rn(2.f, r.v);
#pragma unroll
  for (int i = 0; i < T; ++i) r.t[i] = __fdiv_rn(a.t[i], two_r);
  return r;
}

// cameramath._norm: sqrt(fma(v2, v2, fma(v1, v1, v0 * v0))).
template <int T>
__device__ __forceinline__ Dual<T> dnorm(const Dual<T> (&v)[3]) {
  return dsqrt(dfma(v[2], v[2], dfma(v[1], v[1], dmul(v[0], v[0]))));
}

// cameramath.look_at_rotation: rows x, y, z of the world->camera rotation,
// with T = 3 tangents along target - cam_pos (or none).
template <int T>
__device__ __forceinline__ void look_at(const float (&x)[kN], float tol, Dual<T> (&R)[3][3]) {
  Dual<T> z[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    z[j].v = __fsub_rn(x[3 + j], x[j]);
#pragma unroll
    for (int i = 0; i < T; ++i) z[j].t[i] = i == j ? 1.f : 0.f;
  }
  const Dual<T> zn = dnorm(z);
#pragma unroll
  for (int j = 0; j < 3; ++j) z[j] = ddiv(z[j], zn);
  const bool degenerate = fabsf(__fsub_rn(fabsf(z[1].v), 1.f)) <= tol;
  const Dual<T> zero = dsub(z[0], z[0]);
  Dual<T> a[3];
  if (degenerate) {
    a[0] = dneg(z[1]);
    a[1] = z[0];
    a[2] = zero;
  } else {
    a[0] = z[2];
    a[1] = zero;
    a[2] = dneg(z[0]);
  }
  const Dual<T> an = dnorm(a);
#pragma unroll
  for (int j = 0; j < 3; ++j) a[j] = ddiv(a[j], an);
  // y = _cross(z, x): y_i = fma(z_p, x_q, -(z_q * x_p)), (p, q) = (1, 2), (2, 0), (0, 1)
  R[1][0] = dfma(z[1], a[2], dneg(dmul(z[2], a[1])));
  R[1][1] = dfma(z[2], a[0], dneg(dmul(z[0], a[2])));
  R[1][2] = dfma(z[0], a[1], dneg(dmul(z[1], a[0])));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    R[0][j] = a[j];
    R[2][j] = z[j];
  }
}

// A rotation entry with its tangents along target - cam_pos as 2 * TR
// tangents along (cam_pos, target).
template <int TR>
__device__ __forceinline__ Dual<2 * TR> widen(const Dual<TR>& a) {
  Dual<2 * TR> r;
  r.v = a.v;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    r.t[i] = -a.t[i];
    r.t[TR + i] = a.t[i];
  }
  return r;
}

// project_points_soa of one point p up to the u/v FMAs: a = X / Zc and
// b = -(Y / Zc), so that u = fma(a, f, cx) and v = fma(b, f, cy).
template <int TR>
__device__ __forceinline__ void project(const Dual<TR> (&R)[3][3], const float (&x)[kN],
                                        const float (&p)[3], Dual<2 * TR>& a, Dual<2 * TR>& b) {
  constexpr int T = 2 * TR;
  Dual<T> d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d[j].v = __fsub_rn(p[j], x[j]);
#pragma unroll
    for (int i = 0; i < T; ++i) d[j].t[i] = i == j ? -1.f : 0.f;
  }
  Dual<T> X[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    X[r] = dfma(widen(R[r][2]), d[2], dfma(widen(R[r][0]), d[0], dmul(widen(R[r][1]), d[1])));
  // torch.clamp_min: NaN stays, the tangent passes where Z >= the clamp
  Dual<T> Zc = X[2];
  if (!(X[2].v >= kZClamp)) {
    Zc.v = X[2].v < kZClamp ? kZClamp : X[2].v;
#pragma unroll
    for (int i = 0; i < T; ++i) Zc.t[i] = 0.f;
  }
  a = ddiv(X[0], Zc);
  b = dneg(ddiv(X[1], Zc));
}

// One residual row w = fma(a, f, c) (c = cx for u, cy for v, its parameter
// c_param): r = (w - e) * m, then the L1 smoothing.  Returns the LM residual,
// adds the row's loss term to `loss` and, with tangents, writes the row of J.
template <int T>
__device__ __forceinline__ float residual_row(const Dual<T>& a, float f, float c, int c_param, float e,
                                              float m, bool l1, float& loss, float (&J)[kN]) {
  float r = __fmul_rn(__fsub_rn(__fmaf_rn(a.v, f, c), e), m);
  if (T > 0) {
#pragma unroll
    for (int i = 0; i < T; ++i) J[i] = __fmul_rn(__fmul_rn(a.t[i], f), m);
    J[6] = __fmul_rn(a.v, m);
    J[7] = c_param == 7 ? m : 0.f;
    J[8] = c_param == 8 ? m : 0.f;
  }
  if (!l1) {
    loss = __fadd_rn(loss, __fmul_rn(r, r));
    return r;
  }
  // r = sqrt(r * r + 1e-12) * m, loss |r|; the LM residual sqrt(|r| + 1e-12)
  const float q = __fsqrt_rn(__fadd_rn(__fmul_rn(r, r), kSmooth));
  const float r1 = __fmul_rn(q, m);
  const float q2 = __fsqrt_rn(__fadd_rn(fabsf(r1), kSmooth));
  if (T > 0) {
    const float two_q = __fmul_rn(2.f, q), two_q2 = __fmul_rn(2.f, q2);
    const float sgn = r1 > 0.f ? 1.f : (r1 < 0.f ? -1.f : 0.f);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float t1 = __fmul_rn(__fdiv_rn(__fmaf_rn(J[i], r, __fmul_rn(r, J[i])), two_q), m);
      J[i] = __fdiv_rn(__fmul_rn(t1, sgn), two_q2);
    }
  }
  loss = __fadd_rn(loss, fabsf(r1));
  return q2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

struct Fit {
  const float* vox;  // (K, 3)
  const float* img;  // (K, 2)
  const float* mask; // (K,)
  int K;
  bool l1;
  float tol;
};

__device__ __forceinline__ void load_keypoint(const Fit& fit, int k, float (&p)[3], float& iu, float& iv,
                                              float& m) {
#pragma unroll
  for (int j = 0; j < 3; ++j) p[j] = fit.vox[3 * k + j];
  iu = fit.img[2 * k];
  iv = fit.img[2 * k + 1];
  m = fit.mask[k];
}

// The loss at x (the same bits on every lane).
__device__ float fit_loss(const Fit& fit, const float (&x)[kN]) {
  Dual<0> R[3][3];
  look_at(x, fit.tol, R);
  float loss = 0.f, J[kN];
  for (int k = threadIdx.x; k < fit.K; k += kThreads) {
    float p[3], iu, iv, m;
    load_keypoint(fit, k, p, iu, iv, m);
    Dual<0> a, b;
    project(R, x, p, a, b);
    residual_row(a, x[6], x[7], 7, iu, m, fit.l1, loss, J);
    residual_row(b, x[6], x[8], 8, iv, m, fit.l1, loss, J);
  }
  return warp_sum(loss);
}

__global__ void __launch_bounds__(kThreads, 1)
lm_fit_kernel(const float* __restrict__ x0, const float* __restrict__ vox, const float* __restrict__ img,
              const float* __restrict__ mask, const float* __restrict__ lo, const float* __restrict__ hi,
              int K, int l1, int max_iters, float tol, float* __restrict__ x_out,
              float* __restrict__ loss_out, int* __restrict__ steps_out) {
  const int64_t v = blockIdx.x;
  const Fit fit{vox + v * K * 3, img + v * K * 2, mask + v * K, K, l1 != 0, tol};
  float x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = x0[v * kN + i];
  float lam = 1e-3f, dn = 1.f;
  float loss = fit_loss(fit, x);
  int it = 0;
  for (; it < max_iters && dn > 1e-10f; ++it) {
    // ---- the normal equations: J^T J (upper triangle), J^T r ----
    float s[kSym], g[kN];
#pragma unroll
    for (int i = 0; i < kSym; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) g[i] = 0.f;
    {
      Dual<3> R[3][3];
      look_at(x, tol, R);
      float unused = 0.f;
      for (int k = threadIdx.x; k < K; k += kThreads) {
        float p[3], iu, iv, m;
        load_keypoint(fit, k, p, iu, iv, m);
        Dual<6> a, b;
        project(R, x, p, a, b);
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float J[kN];
          const float r = row == 0 ? residual_row(a, x[6], x[7], 7, iu, m, fit.l1, unused, J)
                                   : residual_row(b, x[6], x[8], 8, iv, m, fit.l1, unused, J);
          int at = 0;
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            g[i] = __fadd_rn(g[i], __fmul_rn(J[i], r));
#pragma unroll
            for (int j = i; j < kN; ++j, ++at) s[at] = __fadd_rn(s[at], __fmul_rn(J[i], J[j]));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSym; ++i) s[i] = warp_sum(s[i]);
#pragma unroll
    for (int i = 0; i < kN; ++i) g[i] = warp_sum(g[i]);

    // ---- (J^T J + lambda I) delta = -J^T r, LU with partial pivoting ----
    float A[kN][kN], d[kN];
    {
      int at = 0;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
#pragma unroll
        for (int j = i; j < kN; ++j, ++at) A[i][j] = A[j][i] = i == j ? __fadd_rn(s[at], lam) : s[at];
        d[i] = -g[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      int piv = k;
      float big = fabsf(A[k][k]);
#pragma unroll
      for (int i = k + 1; i < kN; ++i) {
        const float c = fabsf(A[i][k]);
        if (c > big) {
          big = c;
          piv = i;
        }
      }
#pragma unroll
      for (int i = k + 1; i < kN; ++i) {
        const bool swap = piv == i;
#pragma unroll
        for (int j = k; j < kN; ++j) {
          const float t = A[k][j];
          A[k][j] = swap ? A[i][j] : t;
          A[i][j] = swap ? t : A[i][j];
        }
        const float t = d[k];
        d[k] = swap ? d[i] : t;
        d[i] = swap ? t : d[i];
      }
#pragma unroll
      for (int i = k + 1; i < kN; ++i) {
        const float l = __fdiv_rn(A[i][k], A[k][k]);
#pragma unroll
        for (int j = k + 1; j < kN; ++j) A[i][j] = __fmaf_rn(-l, A[k][j], A[i][j]);
        d[i] = __fmaf_rn(-l, d[k], d[i]);
      }
    }
#pragma unroll
    for (int i = kN - 1; i >= 0; --i) {
      float t = d[i];
#pragma unroll
      for (int j = i + 1; j < kN; ++j) t = __fmaf_rn(-A[i][j], d[j], t);
      d[i] = __fdiv_rn(t, A[i][i]);
    }

    // ---- clip (bounds read again: registers are scarce), compare, damp ----
    float x_new[kN], dd = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float xlo = lo[v * kN + i], xhi = hi[v * kN + i];
      float y = __fadd_rn(x[i], d[i]);  // torch.clamp: NaN stays
      y = y < xlo ? xlo : y;
      x_new[i] = y > xhi ? xhi : y;
      dd = __fadd_rn(dd, __fmul_rn(d[i], d[i]));
    }
    const float l_new = fit_loss(fit, x_new);
    const bool better = l_new < loss;
    lam = better ? __fmul_rn(lam, 0.5f) : __fmul_rn(lam, 4.f);
    lam = lam < 1e-8f ? 1e-8f : (lam > 1e12f ? 1e12f : lam);
    if (better) {
#pragma unroll
      for (int i = 0; i < kN; ++i) x[i] = x_new[i];
      loss = l_new;
    }
    dn = __fsqrt_rn(dd);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) x_out[v * kN + i] = x[i];
    loss_out[v] = loss;
    steps_out[v] = it;
  }
}

}  // namespace

extern "C" {

// Threads of a block (one fit); the wrapper checks it.
int pbr3d_lm_fit_threads() { return kThreads; }

// Launches the fit of V cameras on `stream` without synchronising and
// returns cudaGetLastError().  x0, lo, hi (V, 9) float32; vox (V, K, 3),
// img (V, K, 2), mask (V, K) float32; l1 = 1 for the L1 objective; tol is
// cameramath._ISCLOSE_TOL; out x (V, 9), loss (V,) float32, steps (V,) int32.
int pbr3d_lm_fit(const float* x0, const float* vox, const float* img, const float* mask, const float* lo,
                 const float* hi, int V, int K, int l1, int max_iters, float tol, float* x, float* loss,
                 int* steps, cudaStream_t stream) {
  if (V <= 0 || K < 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  lm_fit_kernel<<<V, kThreads, 0, stream>>>(x0, vox, img, mask, lo, hi, K, l1, max_iters, tol, x, loss, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
