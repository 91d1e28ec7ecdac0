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
// with act' = out (1 - out) for sigmoid and (out > 0) for relu. Bound: it
// reads 12 bytes of point, 8 of (out, g) per camera and writes 256 bytes of
// gradient per point, so at the SCONE step's (4, 1, 2048) the bytes bound it
// below a microsecond: its time is the launch and one short wave, so the
// design spreads each point over many threads and keeps each thread short.
// A point's 64 terms are split by order |m| between the block's 4 warps,
// (0, 4), (1, 7), (2, 6) and (3, 5): 16 terms each (|m| = 0 has 8 terms,
// |m| = j > 0 has 2 (8 - j)), so each warp runs one code path, keeps 16 sums
// and replays only the prefix of the forward's Chebyshev and sin^m chains
// that its orders need; the Legendre values of an order follow their own
// recurrence from P_m^m. Every step is the forward's expression (the helpers
// below serve both kernels), so both see the basis bit for bit. A warp's 32
// lanes are 32 (point, camera slice) units: with C > 1 a point's cameras are
// dealt to up to 8 slices, whose partial sums the block adds in a fixed order
// (no atomics). The block's (n, 64) gradient tile is staged in shared memory
// and written with coalesced 16-byte stores, each output once. 128-thread
// blocks of 32 units: 256 blocks at both SCONE-step shapes, so every SM has
// work.
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

// The basis's sums of products are spelt with round-to-nearest intrinsics,
// which the compiler never fuses into an FMA: each kernel then computes every
// basis term with the same roundings, whatever it contracts around them.

// The angles of the direction (rx, ry, rz): cos and sin of theta (from the y
// axis) and of phi, algebraic, with the JAX kernel's clamps.
__device__ __forceinline__ void basis_angles(float rx, float ry, float rz,
                                             float& ct, float& st,
                                             float& cphi, float& sphi) {
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                             __fmul_rn(rz, rz));
  const float inv_r = 1.0f / sqrtf(fmaxf(r2, 1e-20f));
  ct = fminf(fmaxf(ry * inv_r, -1.0f), 1.0f);
  st = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(ct, ct)), 0.0f));
  const float inv_rst = inv_r / fmaxf(st, 1e-10f);
  cphi = fminf(fmaxf(rz * inv_rst, -1.0f), 1.0f);
  sphi = fminf(fmaxf(rx * inv_rst, -1.0f), 1.0f);
}

// (cos(m phi), sin(m phi)) -> (cos((m + 1) phi), sin((m + 1) phi)).
__device__ __forceinline__ void chebyshev_next(float cphi, float sphi,
                                               float& c, float& s) {
  const float c_next = __fsub_rn(__fmul_rn(cphi, c), __fmul_rn(sphi, s));
  s = __fadd_rn(__fmul_rn(sphi, c), __fmul_rn(cphi, s));
  c = c_next;
}

// P_l^m from P_{l-1}^m and P_{l-2}^m.
__device__ __forceinline__ float legendre_next(int ll, int m, float ct,
                                               float p1, float p2) {
  return __fsub_rn(__fmul_rn(static_cast<float>(2 * ll - 1) * ct, p1),
                   __fmul_rn(static_cast<float>(ll + m - 1), p2)) /
         static_cast<float>(ll - m);
}

// The 64 basis terms Y_k of the direction of (rx, ry, rz), in packing order,
// each handed to term(k, y). The algebraic angles and clamps are the JAX
// kernel's.
template <typename Term>
__device__ __forceinline__ void for_each_basis_term(float rx, float ry,
                                                    float rz, Term term) {
  float ct, st, cphi, sphi;
  basis_angles(rx, ry, rz, ct, st, cphi, sphi);

  float cm[kMaxL];
  float sm[kMaxL];
  cm[0] = 1.0f;
  sm[0] = 0.0f;
  cm[1] = cphi;
  sm[1] = sphi;
#pragma unroll
  for (int m = 2; m < kMaxL; ++m) {
    cm[m] = cm[m - 1];
    sm[m] = sm[m - 1];
    chebyshev_next(cphi, sphi, cm[m], sm[m]);
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
      P[ll][m] = legendre_next(ll, m, ct, P[ll - 1][m], P[ll - 2][m]);
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

// The terms of order |m| = M, each handed to term(j, y) with j its place
// among the order's terms (M = 0: j = l; M > 0: j = 2 (l - M) for +M and
// 2 (l - M) + 1 for -M; store_order maps j to the packing index), by the
// steps for_each_basis_term takes for them: the Chebyshev and sin^m chains
// up to M, then the Legendre recurrence in l.
template <int M, typename Term>
__device__ __forceinline__ void for_each_term_of_order(float ct, float st,
                                                       float cphi, float sphi,
                                                       Term term) {
  float c = M == 0 ? 1.0f : cphi;
  float s = M == 0 ? 0.0f : sphi;
#pragma unroll
  for (int m = 2; m <= M; ++m) chebyshev_next(cphi, sphi, c, s);
  float p_mm = 1.0f;
  if (M > 0) {
    float stm = 1.0f;
#pragma unroll
    for (int m = 1; m <= M; ++m) stm *= st;
    p_mm = c_pmm[M] * stm;
  }
  float p2 = 0.0f;
  float p1 = p_mm;
#pragma unroll
  for (int ll = M; ll < kMaxL; ++ll) {
    float p = p_mm;
    if (ll == M + 1) {
      p = static_cast<float>(2 * M + 1) * ct * p_mm;
    } else if (ll > M + 1) {
      p = legendre_next(ll, M, ct, p1, p2);
    }
    if (ll > M) {
      p2 = p1;
      p1 = p;
    }
    const int k0 = ll * ll + ll;
    if (M == 0) {
      term(ll, c_norm[k0] * p);
    } else {
      term(2 * (ll - M), c_norm[k0 + M] * c * p);
      term(2 * (ll - M) + 1, c_norm[k0 - M] * s * p);
    }
  }
}

constexpr int terms_of_order(int m) {
  return m == 0 ? kMaxL : 2 * (kMaxL - m);
}

// The sums acc[j] of the terms of order M to their packing indices in row.
template <int M>
__device__ __forceinline__ void store_order(const float* acc, float* row) {
#pragma unroll
  for (int ll = M; ll < kMaxL; ++ll) {
    const int k0 = ll * ll + ll;
    if (M == 0) {
      row[k0] = acc[ll];
    } else {
      row[k0 + M] = acc[2 * (ll - M)];
      row[k0 - M] = acc[2 * (ll - M) + 1];
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

// The backward's block: 4 warps, one per pair of orders, over 32 (point,
// camera slice) units. Its staging rows are 68 floats apart: 16-byte
// aligned, so a phase of 8 lanes reads 8 float4s from 32 distinct banks,
// while the warps' row-wise scalar writes meet at most 4 to a bank.
constexpr int kUnits = 32;
constexpr int kBackBlock = 4 * kUnits;
constexpr int kMaxSlices = 8;
constexpr int kBackRow = kNHarm + 4;

// One unit's sums for the orders MA and MB over its cameras c = slice,
// slice + slices, ..., written to its row of the block's staging tile.
template <int MA, int MB>
__device__ __forceinline__ void backward_unit(
    const float* __restrict__ pt, const float* __restrict__ cam,
    const float* __restrict__ out, const float* __restrict__ gout, int b,
    int l, int C, int L, int slice, int slices, int use_sigmoid,
    float* __restrict__ row) {
  constexpr int kA = terms_of_order(MA);
  float acc[kA + terms_of_order(MB)];
#pragma unroll
  for (int j = 0; j < kA + terms_of_order(MB); ++j) acc[j] = 0.0f;
  if (pt != nullptr) {
    const float px = pt[0], py = pt[1], pz = pt[2];
    for (int c = slice; c < C; c += slices) {
      const size_t o = (static_cast<size_t>(b) * C + c) * L + l;
      const float v = out[o];
      const float dact =
          use_sigmoid ? v * (1.0f - v) : (v > 0.0f ? 1.0f : 0.0f);
      const float gz = gout[o] * dact;
      const float* xc = cam + (static_cast<size_t>(b) * C + c) * 3;
      float ct, st, cphi, sphi;
      basis_angles(xc[0] - px, xc[1] - py, xc[2] - pz, ct, st, cphi, sphi);
      for_each_term_of_order<MA>(ct, st, cphi, sphi, [&](int j, float y) {
        acc[j] += gz * y;
      });
      for_each_term_of_order<MB>(ct, st, cphi, sphi, [&](int j, float y) {
        acc[kA + j] += gz * y;
      });
    }
  }
  store_order<MA>(acc, row);
  store_order<MB>(acc + kA, row);
}

__global__ void __launch_bounds__(kBackBlock)
sh_visibility_backward_kernel(const float* __restrict__ pts, int pts_stride,
                              const float* __restrict__ cam,
                              const float* __restrict__ out,
                              const float* __restrict__ gout,
                              float* __restrict__ gharm, int C, int L,
                              int n_points, int slices, int use_sigmoid) {
  __shared__ __align__(16) float tile[kUnits * kBackRow];
  const int per_block = kUnits / slices;
  const int p0 = blockIdx.x * per_block;
  const int unit = threadIdx.x % kUnits;
  const int p = p0 + unit / slices;
  const int b = p / L;
  const float* pt = p < n_points ? pts + static_cast<size_t>(p) * pts_stride
                                 : nullptr;
  float* row = tile + unit * kBackRow;
  const int slice = unit % slices;
  const int l = p - b * L;
  switch (threadIdx.x / kUnits) {
    case 0:
      backward_unit<0, 4>(pt, cam, out, gout, b, l, C, L, slice, slices,
                          use_sigmoid, row);
      break;
    case 1:
      backward_unit<1, 7>(pt, cam, out, gout, b, l, C, L, slice, slices,
                          use_sigmoid, row);
      break;
    case 2:
      backward_unit<2, 6>(pt, cam, out, gout, b, l, C, L, slice, slices,
                          use_sigmoid, row);
      break;
    default:
      backward_unit<3, 5>(pt, cam, out, gout, b, l, C, L, slice, slices,
                          use_sigmoid, row);
  }
  __syncthreads();

  // The block's points are consecutive rows of grad_harm: one contiguous
  // tile, each entry the sum of its point's slices in slice order, stored
  // 16 bytes a lane.
  constexpr int kQuads = kNHarm / 4;
  const int n = min(per_block, n_points - p0);
  float4* g = reinterpret_cast<float4*>(gharm + static_cast<size_t>(p0) *
                                                    kNHarm);
  for (int i = threadIdx.x; i < n * kQuads; i += kBackBlock) {
    const float* src = tile + (i / kQuads) * slices * kBackRow +
                       (i % kQuads) * 4;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int t = 1; t < slices; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(src + t * kBackRow);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    g[i] = sum;
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
  int slices = 1;
  while (slices < kMaxSlices && 2 * slices <= C) slices *= 2;
  const int n_points = B * L;
  const int per_block = kUnits / slices;
  const int blocks = (n_points + per_block - 1) / per_block;
  sh_visibility_backward_kernel<<<blocks, kBackBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      pts, pts_stride, cam, out, gout, gharm, C, L, n_points, slices,
      use_sigmoid);
  return static_cast<int>(cudaGetLastError());
}
