// Fused spherical-harmonics visibility kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel macarons_tpu/ops/pallas/sh_visibility.py
// (pallas_compute_visibilities / _vis_kernel), generalised to a batch:
//
//   out[b, c, l] = act( sum_k harm[b, l, k] * Y_k(dir(X_cam[b, c] - pts[b, l])) )
//
// with the 64 real spherical harmonics of degree < 8 in the JAX package's
// packing (l-major, m from -l to l, Condon-Shortley phase) and act = sigmoid
// or relu. The angles are algebraic: cos(theta) = y / r, sin(theta) =
// sqrt(1 - cos^2), cos(phi) = z / (r sin(theta)), sin(phi) = x / (r sin(theta)),
// with the clamps of the JAX kernel (r^2 >= 1e-20, sin(theta) >= 1e-10, clip
// to [-1, 1]). The associated Legendre values come from their recurrences and
// cos(m phi), sin(m phi) from the Chebyshev recurrence, all in registers; the
// (B, C, L, 64) basis is never stored.
//
// Bound: each output costs ~460 float operations, and each point brings 268
// bytes (xyz + 64 coefficients). The H100 does ~20 float32 operations per
// byte of HBM bandwidth, so the per-candidate scorer (C = 1 camera per
// point set) is bound by bytes and the shared scorer (C ~ 50 cameras per
// point) by float32 operations. Design: one thread
// per output; a block covers 128 points of one (batch, camera) pair and first
// stages the block's (128, 64) harmonics tile in shared memory with coalesced
// loads (row stride 65 floats, so the per-thread reads that follow hit 32
// distinct banks). Blocks of different cameras re-read the same tile, which
// the 50 MB L2 serves.
//
// The backward kernel gives the gradient of the coefficients only (the points
// and camera centres are not differentiated):
//
//   grad_harm[b, l, k] = sum_c g[b, c, l] act'(out[b, c, l]) Y_k(dir(X_cam[b, c] - pts[b, l]))
//
// with act' = out (1 - out) for sigmoid and (out > 0) for relu. One thread per
// (batch, point) loops over the cameras, recomputes the 64 basis terms with
// the forward's recurrences and clamps, and accumulates 64 sums in registers;
// the block stages its (128, 64) result in shared memory and writes it with
// coalesced stores, each output once and without atomics.
//
// The interface is plain C: the Python wrapper passes raw device pointers and
// the current CUDA stream, and checks the returned cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxL = 8;
constexpr int kNHarm = kMaxL * kMaxL;
constexpr int kBlock = 128;
constexpr int kRow = kNHarm + 1;

// N_l0 = sqrt((2l+1)/(4 pi)) and N_lm = N_l0 * sqrt(2 (l-|m|)! / (l+|m|)!)
// for m != 0, computed in float64 and rounded to float32, in the packing
// order (l-major, m from -l to l).
__constant__ float c_norm[kNHarm] = {
    // l = 0
    0.282094806f,
    // l = 1
    0.488602519f, 0.488602519f, 0.488602519f,
    // l = 2
    0.1820914f, 0.3641828f, 0.630783141f, 0.3641828f, 0.1820914f,
    // l = 3
    0.0393362381f, 0.0963537171f, 0.304697186f, 0.746352673f, 0.304697186f,
    0.0963537171f, 0.0393362381f,
    // l = 4
    0.00596034015f, 0.0168583877f, 0.0630783141f, 0.267618626f,
    0.846284389f, 0.267618626f, 0.0630783141f, 0.0168583877f,
    0.00596034015f,
    // l = 5
    0.00069458416f, 0.00219646795f, 0.00931882486f, 0.0456527323f,
    0.241571546f, 0.935602605f, 0.241571546f, 0.0456527323f, 0.00931882486f,
    0.00219646795f, 0.00069458416f,
    // l = 6
    6.57223791e-05f, 0.000227668992f, 0.00106786226f, 0.0058489223f,
    0.0350935347f, 0.221950993f, 1.01710725f, 0.221950993f, 0.0350935347f,
    0.0058489223f, 0.00106786226f, 0.000227668992f, 6.57223791e-05f,
    // l = 7
    5.23300923e-06f, 1.95801276e-05f, 9.98394607e-05f, 0.00059903675f,
    0.00397356041f, 0.0280973129f, 0.206472248f, 1.09254849f, 0.206472248f,
    0.0280973129f, 0.00397356041f, 0.00059903675f, 9.98394607e-05f,
    1.95801276e-05f, 5.23300923e-06f,
};

// (-1)^m (2m-1)!!, the factor of P_m^m = (-1)^m (2m-1)!! sin(theta)^m.
__constant__ float c_pmm[kMaxL] = {1.f, -1.f, 3.f, -15.f, 105.f, -945.f,
                                   10395.f, -135135.f};

// The 64 basis terms Y_k of the direction of (rx, ry, rz), in packing order,
// each handed to term(k, y). The algebraic angles and clamps are the JAX
// kernel's; both kernels call this, so they see the same basis.
template <typename Term>
__device__ __forceinline__ void for_each_basis_term(float rx, float ry,
                                                    float rz, Term term) {
  const float r2 = rx * rx + ry * ry + rz * rz;
  const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-20f));
  const float ct = fminf(fmaxf(ry * inv_r, -1.0f), 1.0f);
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float inv_rst = inv_r / fmaxf(st, 1e-10f);
  const float cphi = fminf(fmaxf(rz * inv_rst, -1.0f), 1.0f);
  const float sphi = fminf(fmaxf(rx * inv_rst, -1.0f), 1.0f);

  float cm[kMaxL];
  float sm[kMaxL];
  cm[0] = 1.0f;
  sm[0] = 0.0f;
  cm[1] = cphi;
  sm[1] = sphi;
#pragma unroll
  for (int m = 2; m < kMaxL; ++m) {
    cm[m] = cphi * cm[m - 1] - sphi * sm[m - 1];
    sm[m] = sphi * cm[m - 1] + cphi * sm[m - 1];
  }

  float P[kMaxL][kMaxL];
  P[0][0] = 1.0f;
  float stm = 1.0f;
#pragma unroll
  for (int m = 1; m < kMaxL; ++m) {
    stm *= st;
    P[m][m] = c_pmm[m] * stm;
  }
#pragma unroll
  for (int m = 0; m < kMaxL - 1; ++m) {
    P[m + 1][m] = static_cast<float>(2 * m + 1) * ct * P[m][m];
  }
#pragma unroll
  for (int m = 0; m < kMaxL; ++m) {
#pragma unroll
    for (int ll = m + 2; ll < kMaxL; ++ll) {
      P[ll][m] = (static_cast<float>(2 * ll - 1) * ct * P[ll - 1][m] -
                  static_cast<float>(ll + m - 1) * P[ll - 2][m]) /
                 static_cast<float>(ll - m);
    }
  }

  int k = 0;
#pragma unroll
  for (int ll = 0; ll < kMaxL; ++ll) {
#pragma unroll
    for (int m = -ll; m <= ll; ++m) {
      float y;
      if (m == 0) {
        y = c_norm[k] * P[ll][0];
      } else if (m > 0) {
        y = c_norm[k] * cm[m] * P[ll][m];
      } else {
        y = c_norm[k] * sm[-m] * P[ll][-m];
      }
      term(k, y);
      ++k;
    }
  }
}

// sum_k h[k] Y_k(dir(rx, ry, rz)), summed in packing order.
__device__ __forceinline__ float basis_dot(float rx, float ry, float rz,
                                           const float* h) {
  float acc = 0.0f;
  for_each_basis_term(rx, ry, rz, [&](int k, float y) { acc += h[k] * y; });
  return acc;
}

__global__ void __launch_bounds__(kBlock)
sh_visibility_kernel(const float* __restrict__ pts, int pts_stride,
                     const float* __restrict__ harm,
                     const float* __restrict__ cam, float* __restrict__ out,
                     int C, int L, int use_sigmoid) {
  __shared__ float tile[kBlock * kRow];
  const int b = blockIdx.z;
  const int c = blockIdx.y;
  const int l0 = blockIdx.x * kBlock;
  const int n = min(kBlock, L - l0);

  const float* hb = harm + (static_cast<size_t>(b) * L + l0) * kNHarm;
  for (int i = threadIdx.x; i < n * kNHarm; i += kBlock) {
    tile[(i / kNHarm) * kRow + (i % kNHarm)] = hb[i];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= n) return;
  const int l = l0 + t;
  const float* p = pts + (static_cast<size_t>(b) * L + l) * pts_stride;
  const float* xc = cam + (static_cast<size_t>(b) * C + c) * 3;

  const float z = basis_dot(xc[0] - p[0], xc[1] - p[1], xc[2] - p[2],
                            tile + t * kRow);
  out[(static_cast<size_t>(b) * C + c) * L + l] =
      use_sigmoid ? 1.0f / (1.0f + expf(-z)) : fmaxf(z, 0.0f);
}

__global__ void __launch_bounds__(kBlock)
sh_visibility_backward_kernel(const float* __restrict__ pts, int pts_stride,
                              const float* __restrict__ cam,
                              const float* __restrict__ out,
                              const float* __restrict__ gout,
                              float* __restrict__ gharm, int C, int L,
                              int use_sigmoid) {
  __shared__ float tile[kBlock * kRow];
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * kBlock;
  const int n = min(kBlock, L - l0);
  const int t = threadIdx.x;

  float acc[kNHarm];
#pragma unroll
  for (int k = 0; k < kNHarm; ++k) acc[k] = 0.0f;

  if (t < n) {
    const int l = l0 + t;
    const float* p = pts + (static_cast<size_t>(b) * L + l) * pts_stride;
    const float px = p[0], py = p[1], pz = p[2];
    for (int c = 0; c < C; ++c) {
      const size_t o = (static_cast<size_t>(b) * C + c) * L + l;
      const float v = out[o];
      const float dact = use_sigmoid ? v * (1.0f - v) : (v > 0.0f ? 1.0f : 0.0f);
      const float gz = gout[o] * dact;
      const float* xc = cam + (static_cast<size_t>(b) * C + c) * 3;
      for_each_basis_term(xc[0] - px, xc[1] - py, xc[2] - pz,
                          [&](int k, float y) { acc[k] += gz * y; });
    }
  }
#pragma unroll
  for (int k = 0; k < kNHarm; ++k) tile[t * kRow + k] = acc[k];
  __syncthreads();

  float* gb = gharm + (static_cast<size_t>(b) * L + l0) * kNHarm;
  for (int i = t; i < n * kNHarm; i += kBlock) {
    gb[i] = tile[(i / kNHarm) * kRow + (i % kNHarm)];
  }
}

}  // namespace

extern "C" int macarons_sh_visibility(const float* pts, int pts_stride,
                                      const float* harm, const float* cam,
                                      float* out, int B, int C, int L,
                                      int use_sigmoid, void* stream) {
  if (B == 0 || C == 0 || L == 0) return 0;
  const dim3 grid((L + kBlock - 1) / kBlock, C, B);
  sh_visibility_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pts, pts_stride, harm, cam, out, C, L, use_sigmoid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int macarons_sh_visibility_backward(const float* pts,
                                               int pts_stride,
                                               const float* cam,
                                               const float* out,
                                               const float* gout, float* gharm,
                                               int B, int C, int L,
                                               int use_sigmoid, void* stream) {
  if (B == 0 || L == 0) return 0;
  const dim3 grid((L + kBlock - 1) / kBlock, B);
  sh_visibility_backward_kernel<<<grid, kBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      pts, pts_stride, cam, out, gout, gharm, C, L, use_sigmoid);
  return static_cast<int>(cudaGetLastError());
}
