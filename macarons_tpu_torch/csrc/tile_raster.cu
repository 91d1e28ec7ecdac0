// Tile rasterizer kernels for NVIDIA Hopper (sm_90a): the per-tile stage of
// the port's binned capture path.
//
// Replaces the two Pallas TPU kernels of macarons_tpu/ops/pallas/tile_raster.py:
//
//   raster_pairs_kernel  <- pallas_rasterize_pairs (_pair_row_kernel, B1):
//       each grid row (camera, screen tile) tests the first min(count, k_cap)
//       pairs of its contiguous segment [start, start + count) of a
//       tile-sorted (tile, face) pair array, pfv (NFE, 9) float32 rows
//       x0 y0 z0 x1 y1 z1 x2 y2 z2 (NDC x/y, view z) and pface (NFE,) int32
//       face ids; outputs the winning face id.
//   raster_tiles_kernel  <- pallas_rasterize_tiles (_tile_kernel, B2):
//       each grid row tests the lanes of its dense face list, tile_fv
//       (R, 9, K) float32 and tile_valid (R, K) float32 (> 0 = real face),
//       up to its count rounded up to whole k_chunk chunks (the chunks the
//       TPU kernel skips hold no work); outputs the winning lane (slot).
//
// Per (pixel, face) both compute the JAX kernels' arithmetic in their order:
// PyTorch3D NDC pixel centres x = W/s - 2 col/(s - 1) (W/s rounded once to
// float32 on the host), signed area and inv_area = 1/area for
// |area| > eps, edge-function barycentrics times inv_area, the inside test,
// perspective correction with the denominator guarded to eps,
// z = b0 z0 + b1 z1 + (1 - b0 - b1) z2, and the z > eps gate. The nearest
// face wins; on a z tie the earlier one (smaller face id in a pair segment,
// smaller lane in a dense list), which a strict < over faces in ascending
// order gives. The file is built with -fmad=false and IEEE division, so each
// step rounds as the plain PyTorch twin's tensor ops do and the two agree
// bit for bit.
//
// Design: one thread block per grid row, one thread per pixel of the
// tile x tile screen tile. The row's faces are staged through shared memory
// kChunk at a time (vertex data, 1/area and the face id; degenerate and
// invalid faces are marked -1 and skipped), and every thread walks the chunk
// keeping its running (z, id, b0, b1) in registers. Outputs are written once.
// Bound: at the capture path's shapes the work is ~40 float operations per
// (pixel, face tested) against ~40 bytes read per face and 16 written per
// pixel, so the kernel is bound by operations (float32 outside the tensor
// cores); the divisions of the perspective correction dominate them.
//
// The interface is plain C: the Python wrapper passes raw device pointers and
// the current CUDA stream, and checks the returned cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 256;
constexpr float kBig = 3.0e38f;

struct Geometry {
  int n_tiles;  // tiles per image: row r is tile r % n_tiles of its camera
  int tile;
  int tw;       // tiles per image row
  int h, w;
  float ws;     // W / s rounded to float32, s = min(H, W)
  float hs;     // H / s rounded to float32
  float sm1;    // s - 1
  int persp;
  float eps;
};

struct Best {
  float z = kBig;
  int id = -1;
  float b0 = 0.0f;
  float b1 = 0.0f;
};

// Stage face k of the chunk: vertex rows, 1/area, and its id (-1 when the
// face is invalid or degenerate).
__device__ __forceinline__ void stage_face(float (*s_fv)[kChunk], float* s_inv,
                                           int* s_id, int k, const float* v,
                                           int id, float eps) {
#pragma unroll
  for (int c = 0; c < 9; ++c) s_fv[c][k] = v[c];
  const float area = (v[3] - v[0]) * (v[7] - v[1]) - (v[6] - v[0]) * (v[4] - v[1]);
  const bool nondegen = fabsf(area) > eps;
  s_inv[k] = nondegen ? 1.0f / area : 0.0f;
  s_id[k] = nondegen ? id : -1;
}

// Test the m staged faces against one pixel, in ascending order.
__device__ __forceinline__ void test_chunk(const float (*s_fv)[kChunk],
                                           const float* s_inv, const int* s_id,
                                           int m, float px, float py,
                                           const Geometry& g, Best& best) {
  for (int k = 0; k < m; ++k) {
    const int id = s_id[k];
    if (id < 0) continue;
    const float x0 = s_fv[0][k], y0 = s_fv[1][k], z0 = s_fv[2][k];
    const float x1 = s_fv[3][k], y1 = s_fv[4][k], z1 = s_fv[5][k];
    const float x2 = s_fv[6][k], y2 = s_fv[7][k], z2 = s_fv[8][k];
    const float inv_area = s_inv[k];
    const float w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area;
    const float w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area;
    const float w2 = 1.0f - w0 - w1;
    if (!(w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) continue;
    float b0, b1, z;
    if (g.persp) {
      const float iw0 = w0 / z0;
      const float iw1 = w1 / z1;
      const float iw2 = w2 / z2;
      float denom = iw0 + iw1 + iw2;
      denom = fabsf(denom) > g.eps ? denom : g.eps;
      b0 = iw0 / denom;
      b1 = iw1 / denom;
      z = b0 * z0 + b1 * z1 + (1.0f - b0 - b1) * z2;
    } else {
      b0 = w0;
      b1 = w1;
      z = w0 * z0 + w1 * z1 + w2 * z2;
    }
    if (z > g.eps && z < best.z) {
      best.z = z;
      best.id = id;
      best.b0 = b0;
      best.b1 = b1;
    }
  }
}

// Pixel centre of this thread in NDC, and whether it lies in the image (the
// last tile row and column may hang past it).
__device__ __forceinline__ bool pixel(const Geometry& g, float& px, float& py) {
  const int t = blockIdx.x % g.n_tiles;
  const int p = threadIdx.x;
  const float row = static_cast<float>((t / g.tw) * g.tile + p / g.tile);
  const float col = static_cast<float>((t % g.tw) * g.tile + p % g.tile);
  px = g.ws - 2.0f * col / g.sm1;
  py = g.hs - 2.0f * row / g.sm1;
  return row < static_cast<float>(g.h) && col < static_cast<float>(g.w);
}

__device__ __forceinline__ void write_out(const Best& best, float* zbuf, int* id,
                                         float* b0, float* b1) {
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  zbuf[o] = best.id >= 0 ? best.z : -1.0f;
  id[o] = best.id;
  b0[o] = best.b0;
  b1[o] = best.b1;
}

__global__ void __launch_bounds__(1024)
raster_pairs_kernel(const float* __restrict__ pfv, const int* __restrict__ pface,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts, int nfe, int k_cap,
                    Geometry g, float* __restrict__ zbuf, int* __restrict__ fid,
                    float* __restrict__ b0, float* __restrict__ b1) {
  __shared__ float s_fv[9][kChunk];
  __shared__ float s_inv[kChunk];
  __shared__ int s_id[kChunk];
  float px, py;
  const bool pix_ok = pixel(g, px, py);
  const int start = starts[blockIdx.x];
  const int n = max(0, min(min(counts[blockIdx.x], k_cap), nfe - start));
  Best best;
  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const size_t e = static_cast<size_t>(start) + base + k;
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) v[c] = pfv[e * 9 + c];
      stage_face(s_fv, s_inv, s_id, k, v, pface[e], g.eps);
    }
    __syncthreads();
    if (pix_ok) test_chunk(s_fv, s_inv, s_id, m, px, py, g, best);
  }
  write_out(best, zbuf, fid, b0, b1);
}

__global__ void __launch_bounds__(1024)
raster_tiles_kernel(const float* __restrict__ tile_fv,
                    const float* __restrict__ tile_valid,
                    const int* __restrict__ tile_counts, int K, int k_chunk,
                    Geometry g, float* __restrict__ zbuf, int* __restrict__ slot,
                    float* __restrict__ b0, float* __restrict__ b1) {
  __shared__ float s_fv[9][kChunk];
  __shared__ float s_inv[kChunk];
  __shared__ int s_id[kChunk];
  float px, py;
  const bool pix_ok = pixel(g, px, py);
  const int count = max(0, tile_counts[blockIdx.x]);
  const int n = min(K, (count + k_chunk - 1) / k_chunk * k_chunk);
  const float* fv = tile_fv + static_cast<size_t>(blockIdx.x) * 9 * K;
  const float* valid = tile_valid + static_cast<size_t>(blockIdx.x) * K;
  Best best;
  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const int lane = base + k;
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) v[c] = fv[static_cast<size_t>(c) * K + lane];
      stage_face(s_fv, s_inv, s_id, k, v, valid[lane] > 0.0f ? lane : -1,
                 g.eps);
    }
    __syncthreads();
    if (pix_ok) test_chunk(s_fv, s_inv, s_id, m, px, py, g, best);
  }
  write_out(best, zbuf, slot, b0, b1);
}

Geometry make_geometry(int n_tiles, int tile, int tw, int h, int w, float ws,
                       float hs, int persp, float eps) {
  const int s = h < w ? h : w;
  return Geometry{n_tiles, tile, tw, h, w, ws, hs,
                  static_cast<float>(s - 1), persp, eps};
}

}  // namespace

extern "C" int macarons_raster_pairs(const float* pfv, const int* pface,
                                     const int* starts, const int* counts,
                                     int rows, int nfe, int k_cap, int n_tiles,
                                     int tile, int tw, int h, int w, float ws,
                                     float hs, int persp, float eps,
                                     float* zbuf, int* fid, float* b0,
                                     float* b1, void* stream) {
  if (rows == 0) return 0;
  const Geometry g = make_geometry(n_tiles, tile, tw, h, w, ws, hs, persp, eps);
  raster_pairs_kernel<<<rows, tile * tile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pfv, pface, starts, counts, nfe, k_cap, g, zbuf, fid, b0, b1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int macarons_raster_tiles(const float* tile_fv,
                                     const float* tile_valid,
                                     const int* tile_counts, int rows, int K,
                                     int k_chunk, int n_tiles, int tile,
                                     int tw, int h, int w, float ws, float hs,
                                     int persp, float eps, float* zbuf,
                                     int* slot, float* b0, float* b1,
                                     void* stream) {
  if (rows == 0) return 0;
  const Geometry g = make_geometry(n_tiles, tile, tw, h, w, ws, hs, persp, eps);
  raster_tiles_kernel<<<rows, tile * tile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tile_fv, tile_valid, tile_counts, K, k_chunk, g, zbuf, slot, b0, b1);
  return static_cast<int>(cudaGetLastError());
}
