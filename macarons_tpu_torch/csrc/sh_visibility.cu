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
// to [-1, 1]). The normalised associated Legendre values come from their
// recurrences and cos(m phi), sin(m phi) from the Chebyshev recurrence, all
// in registers; the (B, C, L, 64) basis is never stored.
//
// Forward. Bound: each output costs 324 float operations (an FMA counts
// two), and each point brings 268 bytes (xyz + 64 coefficients). The H100
// does ~20 float32 operations per byte of HBM bandwidth, so with one camera
// per point set (the per-candidate scorer, the SCONE step) the bytes bound
// it, and with ~50 cameras per point (the shared scorer, the vis pretrainer,
// the ShapeNet tester) the float32 operations. Design: a block takes
// consecutive points of one batch and every camera of that batch: it stages
// the points' coefficient rows once (coalesced 16-byte loads) and each
// thread copies its point's 64 coefficients to registers, so a row crosses
// L2 once per block whatever C is. A point's cameras are dealt to slices
// (threads) so that few points still fill the card; each output is one
// thread's, summed in one fixed order (no atomics). The sum runs by order m:
// for m > 0 the coefficients of +m and -m are summed against Pbar_l^m over l
// first and multiplied by cos(m phi) and sin(m phi) once, so a basis term
// costs one FMA. With ~50 cameras the H100 runs it at about half its issue
// rate, neither bound reached: each output is one dependent chain, and the
// 64 coefficients held in registers leave room for at most ~20 warps per SM
// to hide its latency.
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
// recurrence from Pbar_m^m. Every step is the forward's expression (the
// helpers below serve both kernels), so both see the basis bit for bit: the
// forward's Y_lm is its cos(m phi) times Pbar_l^m, the backward's
// Pbar_l^m times cos(m phi), one rounded product of the same two floats. A
// warp's 32 lanes are 32 (point, camera slice) units: with C > 1 a point's
// cameras are dealt to up to 8 slices, whose partial sums the block adds in
// a fixed order (no atomics). The block's (n, 64) gradient tile is staged in
// shared memory and written with coalesced 16-byte stores, each output
// once. 128-thread blocks of 32 units: 256 blocks at both SCONE-step
// shapes, so every SM has work.
//
// The interface is plain C: the Python wrapper passes raw device pointers,
// the forward's launch plan and the current CUDA stream, and checks the
// returned cudaError_t.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxL = 8;
constexpr int kNHarm = kMaxL * kMaxL;

// The basis is the JAX kernel's with each normalisation N_lm folded into
// the Legendre recurrences: with Pbar_l^m = N_lm P_l^m, where
// N_l0 = sqrt((2l+1)/(4 pi)) and N_lm = N_l0 sqrt(2 (l-m)! / (l+m)!) for
// m > 0, Y_l0 = Pbar_l^0, Y_lm = Pbar_l^m cos(m phi) and
// Y_l,-m = Pbar_l^m sin(m phi). The constants are computed in float64 and
// rounded to float32.
//
// Pbar_m^m = c_pmm[m] sin(theta)^m, c_pmm[m] = N_mm (-1)^m (2m-1)!!.
__constant__ float c_pmm[kMaxL] = {
    0.282094806f, -0.488602519f, 0.546274245f, -0.590043604f, 0.625835717f,
    -0.656382084f, 0.683184087f, -0.707162738f};

// Pbar_{m+1}^m = c_first[m] cos(theta) Pbar_m^m, c_first[m] =
// (2m+1) N_{m+1,m} / N_mm for m < 7.
__constant__ float c_first[kMaxL] = {
    1.73205078f, 2.23606801f, 2.64575124f, 3.0f, 3.31662488f, 3.60555124f,
    3.87298346f, 0.0f};

// For l >= m + 2, Pbar_l^m = c_rec_a[l][m] cos(theta) Pbar_{l-1}^m -
// c_rec_b[l][m] Pbar_{l-2}^m, with c_rec_a = (2l-1) N_lm / ((l-m) N_{l-1,m})
// and c_rec_b = (l+m-1) N_lm / ((l-m) N_{l-2,m}); 0 elsewhere.
__constant__ float c_rec_a[kMaxL][kMaxL] = {
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.93649173f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.97202659f, 2.09165001f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.98431349f, 2.04939008f, 2.2912879f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.98997486f, 2.03100967f, 2.17124057f, 2.48746848f, 0.0f, 0.0f, 0.0f,
     0.0f},
    {1.99304342f, 2.0213151f, 2.11394191f, 2.30136824f, 2.67394829f, 0.0f, 0.0f,
     0.0f},
    {1.99489141f, 2.01556444f, 2.08166599f, 2.2079401f, 2.43086219f,
     2.85043859f, 0.0f, 0.0f},
};
__constant__ float c_rec_b[kMaxL][kMaxL] = {
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.11803401f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.01835012f, 0.935414374f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.00623059f, 0.979795873f, 0.866025388f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {1.00285304f, 0.991031229f, 0.9476071f, 0.82915622f, 0.0f, 0.0f, 0.0f,
     0.0f},
    {1.00154197f, 0.995226681f, 0.973610103f, 0.925184906f, 0.806225777f, 0.0f,
     0.0f, 0.0f},
    {1.00092721f, 0.99715507f, 0.984731913f, 0.959403217f, 0.909090936f,
     0.790569425f, 0.0f, 0.0f},
};

// The basis's products and sums are spelt with round-to-nearest intrinsics
// (__fmul_rn, __fmaf_rn), which the compiler neither contracts nor splits:
// each kernel then computes every basis term with the same roundings,
// whatever it contracts around them.

// The angles of the direction (rx, ry, rz): cos and sin of theta (from the y
// axis) and of phi, algebraic, with the JAX kernel's clamps. The reciprocal
// square roots and the division are the hardware's approximations (a few
// ulps; no branch to an exact slow path).
__device__ __forceinline__ void basis_angles(float rx, float ry, float rz,
                                             float& ct, float& st,
                                             float& cphi, float& sphi) {
  const float r2 = __fmaf_rn(rx, rx, __fmaf_rn(ry, ry, __fmul_rn(rz, rz)));
  const float inv_r = rsqrtf(fmaxf(r2, 1e-20f));
  ct = fminf(fmaxf(ry * inv_r, -1.0f), 1.0f);
  const float st2 = fmaxf(__fmaf_rn(-ct, ct, 1.0f), 0.0f);
  st = st2 * rsqrtf(fmaxf(st2, 1e-37f));
  const float inv_rst = __fdividef(inv_r, fmaxf(st, 1e-10f));
  cphi = fminf(fmaxf(rz * inv_rst, -1.0f), 1.0f);
  sphi = fminf(fmaxf(rx * inv_rst, -1.0f), 1.0f);
}

// The chains of order m from those of order m - 1 (m >= 1): c, s =
// cos(m phi), sin(m phi) by the Chebyshev recurrence, stm = sin(theta)^m.
__device__ __forceinline__ void next_order(int m, float st, float cphi,
                                           float sphi, float& c, float& s,
                                           float& stm) {
  if (m == 1) {
    c = cphi;
    s = sphi;
    stm = st;
  } else {
    const float c_next = __fmaf_rn(cphi, c, __fmul_rn(-sphi, s));
    s = __fmaf_rn(sphi, c, __fmul_rn(cphi, s));
    c = c_next;
    stm = __fmul_rn(stm, st);
  }
}

// Pbar_l^M for l = M, ..., 7, each handed to f(l, p), from stm =
// sin(theta)^M (1 for M = 0).
template <int M, typename F>
__device__ __forceinline__ void legendre_of_order(float ct, float stm, F f) {
  const float p_mm = M == 0 ? c_pmm[0] : __fmul_rn(c_pmm[M], stm);
  f(M, p_mm);
  float p2 = p_mm;
  float p1 = p_mm;
#pragma unroll
  for (int ll = M + 1; ll < kMaxL; ++ll) {
    const float p =
        ll == M + 1
            ? __fmul_rn(__fmul_rn(c_first[M], ct), p_mm)
            : __fmaf_rn(__fmul_rn(c_rec_a[ll][M], ct), p1,
                        __fmul_rn(-c_rec_b[ll][M], p2));
    p2 = p1;
    p1 = p;
    f(ll, p);
  }
}

// The terms of order |m| = M, each handed to term(j, y) with j its place
// among the order's terms (M = 0: j = l; M > 0: j = 2 (l - M) for +M and
// 2 (l - M) + 1 for -M; store_order maps j to the packing index), by the
// forward's steps: the chains up to M, then the Legendre recurrence in l.
template <int M, typename Term>
__device__ __forceinline__ void for_each_term_of_order(float ct, float st,
                                                       float cphi, float sphi,
                                                       Term term) {
  float c = 1.0f, s = 0.0f, stm = 1.0f;
#pragma unroll
  for (int m = 1; m <= M; ++m) next_order(m, st, cphi, sphi, c, s, stm);
  legendre_of_order<M>(ct, stm, [&](int ll, float p) {
    if (M == 0) {
      term(ll, p);
    } else {
      term(2 * (ll - M), __fmul_rn(p, c));
      term(2 * (ll - M) + 1, __fmul_rn(p, s));
    }
  });
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

// The orders M, ..., 7 of sum_k h[k] Y_k added to acc: per order, the sums
// over l of h[l, +M] Pbar_l^M and h[l, -M] Pbar_l^M, times cos(M phi) and
// sin(M phi).
template <int M>
__device__ __forceinline__ void add_orders(float ct, float st, float cphi,
                                           float sphi, float c, float s,
                                           float stm,
                                           const float (&h)[kNHarm],
                                           float& acc) {
  next_order(M, st, cphi, sphi, c, s, stm);
  float a = 0.0f, b = 0.0f;
  legendre_of_order<M>(ct, stm, [&](int ll, float p) {
    a = __fmaf_rn(h[ll * ll + ll + M], p, a);
    b = __fmaf_rn(h[ll * ll + ll - M], p, b);
  });
  acc = __fmaf_rn(c, a, acc);
  acc = __fmaf_rn(s, b, acc);
  if constexpr (M + 1 < kMaxL) {
    add_orders<M + 1>(ct, st, cphi, sphi, c, s, stm, h, acc);
  }
}

// act(sum_k h[k] Y_k(dir(rx, ry, rz))), order by order.
__device__ __forceinline__ float visibility(float rx, float ry, float rz,
                                            const float (&h)[kNHarm],
                                            int use_sigmoid) {
  float ct, st, cphi, sphi;
  basis_angles(rx, ry, rz, ct, st, cphi, sphi);
  float acc = 0.0f;
  legendre_of_order<0>(ct, 1.0f, [&](int ll, float p) {
    acc = __fmaf_rn(h[ll * ll + ll], p, acc);
  });
  add_orders<1>(ct, st, cphi, sphi, 1.0f, 0.0f, 1.0f, h, acc);
  return use_sigmoid ? __fdividef(1.0f, 1.0f + __expf(-acc))
                     : fmaxf(acc, 0.0f);
}

// The forward's block: `points` consecutive points of one batch, each dealt
// to `slices` threads (thread t: point t % points, slice t / points), so a
// warp holds runs of consecutive points of one slice and its stores run
// along l. The block stages its points' coefficient rows once (coalesced
// 16-byte loads, rows 68 floats apart as in the backward), and each thread
// copies its row to registers; the batch's camera centres are staged in
// chunks of `chunk` cameras (a multiple of `slices`). Slice s takes the
// cameras c = s, s + slices, ... of every chunk.
constexpr int kMaxForwardThreads = 256;
constexpr int kRow = kNHarm + 4;
constexpr int kQuads = kNHarm / 4;

__global__ void __launch_bounds__(kMaxForwardThreads)
sh_visibility_kernel(const float* __restrict__ pts, int pts_stride,
                     const float* __restrict__ harm,
                     const float* __restrict__ cam, float* __restrict__ out,
                     int C, int L, int tiles, int points, int slices,
                     int chunk, int use_sigmoid) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* cams = smem + points * kRow;
  const int b = blockIdx.x / tiles;
  const int l0 = (blockIdx.x - b * tiles) * points;
  const int n = min(points, L - l0);

  // The rows' 16-byte pieces go to shared memory asynchronously, all in
  // flight at once.
  const float4* hb = reinterpret_cast<const float4*>(
      harm + (static_cast<size_t>(b) * L + l0) * kNHarm);
  for (int i = threadIdx.x; i < n * kQuads; i += blockDim.x) {
    __pipeline_memcpy_async(tile + (i / kQuads) * kRow + (i % kQuads) * 4,
                            hb + i, 16);
  }
  __pipeline_commit();
  const float* cb = cam + static_cast<size_t>(b) * C * 3;
  for (int i = threadIdx.x; i < 3 * min(chunk, C); i += blockDim.x) {
    cams[i] = cb[i];
  }

  const int slice = threadIdx.x / points;
  const int j = threadIdx.x - slice * points;
  const bool live = j < n;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (live) {
    const float* p = pts + (static_cast<size_t>(b) * L + l0 + j) * pts_stride;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  float h[kNHarm];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 v = reinterpret_cast<const float4*>(tile + j * kRow)[q];
    h[4 * q] = v.x;
    h[4 * q + 1] = v.y;
    h[4 * q + 2] = v.z;
    h[4 * q + 3] = v.w;
  }

  float* ob = out + static_cast<size_t>(b) * C * L + l0 + j;
  for (int c0 = 0;;) {
    const int m = min(chunk, C - c0);
    if (live) {
      for (int c = slice; c < m; c += slices) {
        const float* xc = cams + 3 * c;
        ob[static_cast<size_t>(c0 + c) * L] = visibility(
            xc[0] - px, xc[1] - py, xc[2] - pz, h, use_sigmoid);
      }
    }
    c0 += chunk;
    if (c0 >= C) break;
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * min(chunk, C - c0); i += blockDim.x) {
      cams[i] = cb[3 * c0 + i];
    }
    __syncthreads();
  }
}

// The backward's block: 4 warps, one per pair of orders, over 32 (point,
// camera slice) units. Its staging rows are 68 floats apart: 16-byte
// aligned, so a phase of 8 lanes reads 8 float4s from 32 distinct banks,
// while the warps' row-wise scalar writes meet at most 4 to a bank.
constexpr int kUnits = 32;
constexpr int kBackBlock = 4 * kUnits;
constexpr int kMaxSlices = 8;

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
  __shared__ __align__(16) float tile[kUnits * kRow];
  const int per_block = kUnits / slices;
  const int p0 = blockIdx.x * per_block;
  const int unit = threadIdx.x % kUnits;
  const int p = p0 + unit / slices;
  const int b = p / L;
  const float* pt = p < n_points ? pts + static_cast<size_t>(p) * pts_stride
                                 : nullptr;
  float* row = tile + unit * kRow;
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
  const int n = min(per_block, n_points - p0);
  float4* g = reinterpret_cast<float4*>(gharm + static_cast<size_t>(p0) *
                                                    kNHarm);
  for (int i = threadIdx.x; i < n * kQuads; i += kBackBlock) {
    const float* src = tile + (i / kQuads) * slices * kRow +
                       (i % kQuads) * 4;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int t = 1; t < slices; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(src + t * kRow);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    g[i] = sum;
  }
}

}  // namespace

// The forward's launch plan (points, slices, chunk) comes from the Python
// wrapper's forward_plan.
extern "C" int macarons_sh_visibility(const float* pts, int pts_stride,
                                      const float* harm, const float* cam,
                                      float* out, int B, int C, int L,
                                      int points, int slices, int chunk,
                                      int use_sigmoid, void* stream) {
  if (B == 0 || C == 0 || L == 0) return 0;
  const int threads = points * slices;
  const size_t smem = (static_cast<size_t>(points) * kRow + 3 * chunk) *
                      sizeof(float);
  if (points < 1 || slices < 1 || threads > kMaxForwardThreads ||
      chunk % slices != 0 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (L + points - 1) / points;
  sh_visibility_kernel<<<B * tiles, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      pts, pts_stride, harm, cam, out, C, L, tiles, points, slices, chunk,
      use_sigmoid);
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
