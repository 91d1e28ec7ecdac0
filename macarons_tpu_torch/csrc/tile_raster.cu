// Tile rasterizer kernel for NVIDIA Hopper (sm_90a): the per-tile stage of
// the port's tiled capture path, one load-balanced launch for both passes.
//
// Replaces the two Pallas TPU kernels of
// macarons_tpu/ops/pallas/tile_raster.py:
//
//   pallas_rasterize_pairs (_pair_row_kernel, B1): each (camera, screen tile)
//       row tests the first min(count, k_cap) pairs of its segment of a
//       tile-sorted (tile, face) pair list and keeps the nearest face id;
//   pallas_rasterize_tiles (_tile_kernel, B2): each row tests the valid
//       lanes of its dense face list, up to its count rounded up to whole
//       k_chunk chunks, and keeps the nearest lane.
//
// raster_tiled_kernel serves both, alone or fused (the capture path's pair
// list and big-face lanes in one launch), in three modes:
//
//   kPairs  faces are pfv (NFE, 9) rows; key = the pair's index e in pfv,
//           output id = pface[e]                      (rasterize_pairs, B1)
//   kLanes  faces are tile_fv (R, 9, K) columns; key = output = the lane
//                                                     (rasterize_tiles, B2)
//   kFused  faces are read by id from faces (N, F, 9); key = output = the
//           face id, from pface (pair items) or lane_face (lane items)
//                                                     (rasterize_tiled)
//
// Per (pixel, face) the arithmetic is the JAX kernels', in their order:
// PyTorch3D NDC pixel centres x = W/s - 2 col/(s - 1) (W/s rounded once to
// float32 on the host), signed area and inv_area = 1/area for |area| > eps,
// edge-function barycentrics times inv_area, the inside test, perspective
// correction with the denominator guarded to eps,
// z = b0 z0 + b1 z1 + (1 - b0 - b1) z2, and the z > eps gate. The file is
// built with -fmad=false and IEEE division, so each step rounds as the plain
// PyTorch twin's tensor ops do and the two agree bit for bit. The tensor
// cores (wgmma) do not apply: the test is exact float32 in a fixed rounding
// order, not a matrix product.
//
// The winner of a pixel is the lexicographic minimum of (z, key) over all
// faces its row tests. With keys ascending in list order that is the first
// nearest face (the twins' argmin), and in kFused the smaller face id on a
// z tie across the two passes (the merge of the two-pass composition).
//
// Design. The bound is operations: ~21 float operations per (pixel, face
// tested) against 40 bytes per face and 16 per output pixel. Without FMA
// contraction the inside test runs ~17 instructions per (pixel, face), so
// the instruction rate, not the memory, is the limit. A row's work varies
// from 0 to k_cap faces (at scene scale 5 % of the rows hold half the
// pairs), so one block per row leaves most SMs idle behind the longest rows.
// Instead raster_items_kernel cuts each row's faces into items of at most
// `item` faces (its pairs, then its valid lanes compacted) and counts them;
// a prefix sum gives item_cum (R + 1), and a persistent grid (as many
// blocks as fit on the card) walks the items: block b takes a contiguous,
// equal share. A thread covers 2 x 2 pixels of the 16 x 16 tile, so that
// the edge terms x - px and y - py of a face are computed once per column
// and row of its quad. Faces are staged into double-buffered shared memory
// with cp.async, so the next item's faces load while the current one is
// tested; the thread that copies a face computes its 1/area once it has
// landed (NaN for a degenerate face, which no pixel is then inside). A
// thread first runs the inside test of 32 faces against its quad, keeping a
// bit per (pixel, face), and only then the perspective correction and depth
// (five IEEE divisions) of the faces each of its pixels is inside: the
// divergent part costs a warp the covered faces of its busiest lane, not a
// pass for every face that any of its lanes covers. Each thread keeps its
// pixels' best (z, key) in registers across the block's consecutive items
// of a row, and when the row ends merges them into a (R, P) scratch with
// 64-bit atomicMin of (float bits of z) << 32 | key (monotonic: a winner
// has z > eps >= 0; a NaN z fails the gate and is never packed). The result
// does not depend on block scheduling. raster_tiled_epilogue then writes
// the outputs: per pixel it unpacks the winner and recomputes b0, b1 for
// that face with the same instructions.
//
// The interface is plain C: the Python wrapper passes raw device pointers and
// the current CUDA stream, and checks the returned cudaError_t.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxItem = 128;
// Pixels of a thread: kQR rows by kQC columns of its tile.
constexpr int kQR = 2;
constexpr int kQC = 2;
constexpr float kBig = 3.0e38f;
constexpr unsigned long long kEmpty = ~0ull;

enum Mode { kPairs = 0, kLanes = 1, kFused = 2 };

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

struct Inputs {
  const float* pfv;        // (NFE, 9) pair rows (kPairs)
  const int* pface;        // (NFE,) face ids of the pairs
  const int* starts;       // (R,) segment starts
  const int* n_pairs;      // (R,) pairs tested per row
  const float* tile_fv;    // (R, 9, K) lane columns (kLanes)
  const int* lane_idx;     // (R, K) tested lanes, compacted, ascending
  const int* lane_face;    // (R, K) face ids of the lanes (kFused)
  const int* n_lanes;      // (R,) lanes tested per row
  int K;
  const float* faces;      // (N, F, 9) faces by id (kFused)
  int F;
  const int* item_cum;     // (R + 1,) items before each row
  int rows;
  int item;                // faces per item, at most kMaxItem
};

// A face staged in shared memory: 9 vertex values, 1/area and its key
// (-1 when degenerate), 16-byte aligned so a thread reads it in 3 loads.
struct __align__(16) SFace {
  float v[9];
  float inv;
  int key;
  int pad;
};

struct Item {
  int row;
  int lanes;  // 0: pairs of the row's segment, 1: its compacted lanes
  int begin;  // first position in the row's pair segment or lane list
  int m;      // faces in the item
};

__device__ __forceinline__ int pair_count(const Inputs& in, int r) {
  return in.n_pairs != nullptr ? in.n_pairs[r] : 0;
}

__device__ __forceinline__ int lane_count(const Inputs& in, int r) {
  return in.n_lanes != nullptr ? in.n_lanes[r] : 0;
}

// Item j of row r: its pairs first, then its lanes, `item` faces at a time.
__device__ __forceinline__ Item make_item(const Inputs& in, int r, int j) {
  const int np = pair_count(in, r);
  const int ip = (np + in.item - 1) / in.item;
  Item it;
  it.row = r;
  it.lanes = j >= ip;
  it.begin = (it.lanes ? j - ip : j) * in.item;
  it.m = min(in.item, (it.lanes ? lane_count(in, r) : np) - it.begin);
  return it;
}

// The row of item i: the last r with item_cum[r] <= i, searched up from
// `r` (the previous item's row).
__device__ __forceinline__ int row_from(const Inputs& in, int r, int i) {
  while (in.item_cum[r + 1] <= i) ++r;
  return r;
}

__device__ __forceinline__ int row_search(const Inputs& in, int i) {
  int lo = 0, hi = in.rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (in.item_cum[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// Where face k of an item lives, its stride between vertex values and key.
template <int MODE>
__device__ __forceinline__ const float* face_source(const Inputs& in,
                                                    const Geometry& g,
                                                    const Item& it, int k,
                                                    int& stride, int& key) {
  const size_t cam = static_cast<size_t>(it.row / g.n_tiles);
  if (!it.lanes) {
    const int e = in.starts[it.row] + it.begin + k;
    stride = 1;
    if (MODE == kPairs) {
      key = e;
      return in.pfv + static_cast<size_t>(e) * 9;
    }
    key = in.pface[e];
    return in.faces + (cam * in.F + key) * 9;
  }
  const size_t rk = static_cast<size_t>(it.row) * in.K;
  const int lane = in.lane_idx[rk + it.begin + k];
  if (MODE == kLanes) {
    stride = in.K;
    key = lane;
    return in.tile_fv + rk * 9 + lane;
  }
  stride = 1;
  key = in.lane_face[rk + lane];
  return in.faces + (cam * in.F + key) * 9;
}

// Start the copies of an item's faces into `buf` (thread k copies face k).
template <int MODE>
__device__ __forceinline__ void stage(const Inputs& in, const Geometry& g,
                                      const Item& it, SFace* buf) {
  for (int k = threadIdx.x; k < it.m; k += blockDim.x) {
    int stride, key;
    const float* src = face_source<MODE>(in, g, it, k, stride, key);
#pragma unroll
    for (int c = 0; c < 9; ++c)
      __pipeline_memcpy_async(&buf[k].v[c], src + c * stride, sizeof(float));
    buf[k].key = key;
  }
}

__device__ __forceinline__ float signed_area(const float* v) {
  return (v[3] - v[0]) * (v[7] - v[1]) - (v[6] - v[0]) * (v[4] - v[1]);
}

// 1/area of the faces this thread copied, once its copies have landed; NaN
// for a degenerate face, so that no pixel is inside it.
__device__ __forceinline__ void finalize(SFace* buf, int m, float eps) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const float area = signed_area(buf[k].v);
    buf[k].inv = fabsf(area) > eps ? 1.0f / area : __int_as_float(0x7fffffff);
  }
}

// Depth and barycentrics of a pixel inside a face, from its edge weights.
__device__ __forceinline__ void depth(float w0, float w1, float w2,
                                      const float* v, const Geometry& g,
                                      float& z, float& b0, float& b1) {
  const float z0 = v[2], z1 = v[5], z2 = v[8];
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
}

struct Best {
  float z = kBig;
  int key = -1;
};

// A thread's kQR x kQC pixels: their NDC column and row centres (NaN past
// the image, so that no face covers them) and best faces.
struct Quad {
  float px[kQC], py[kQR];
  Best best[kQR][kQC];
};

// Keep face k of buf as the pixel's best when it is nearer (on a z tie, when
// its key is smaller). The pixel is inside the face: its edge weights are
// computed again here with the inside test's instructions.
__device__ __forceinline__ void resolve(const SFace* buf, int base,
                                        unsigned mask, float px, float py,
                                        const Geometry& g, Best& b) {
  while (mask != 0) {
    const SFace f = buf[base + __ffs(mask) - 1];
    mask &= mask - 1;
    const float w0 =
        ((f.v[3] - px) * (f.v[7] - py) - (f.v[6] - px) * (f.v[4] - py)) *
        f.inv;
    const float w1 =
        ((f.v[6] - px) * (f.v[1] - py) - (f.v[0] - px) * (f.v[7] - py)) *
        f.inv;
    float z, b0, b1;
    depth(w0, w1, 1.0f - w0 - w1, f.v, g, z, b0, b1);
    if (z > g.eps && (z < b.z || (z == b.z && f.key < b.key))) {
      b.z = z;
      b.key = f.key;
    }
  }
}

// Test an item's m staged faces against the thread's quad, 32 at a time:
// first the inside test of every (pixel, face), which only sets a bit per
// pixel, then the depth of the faces each pixel is inside (resolve). A
// warp runs the divisions of the depth once per face its lanes are inside
// of, not once per face any lane is inside of. The edge terms x - px and
// y - py are shared by the quad's columns and rows; each (pixel, face)
// computes w0 = ((x1 - px)(y2 - py) - (x2 - px)(y1 - py)) * inv_area and w1
// likewise in the twin's order, and tests w2 = 1 - w0 - w1 >= 0.
__device__ __forceinline__ void test_item(const SFace* buf, int m,
                                          const Geometry& g, Quad& q) {
  for (int base = 0; base < m; base += 32) {
    const int n = min(32, m - base);
    unsigned mask[kQR][kQC] = {};
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const SFace f = buf[base + j];
      float ax[kQC][3], by[kQR][3];
#pragma unroll
      for (int c = 0; c < kQC; ++c) {
        ax[c][0] = f.v[0] - q.px[c];
        ax[c][1] = f.v[3] - q.px[c];
        ax[c][2] = f.v[6] - q.px[c];
      }
#pragma unroll
      for (int rr = 0; rr < kQR; ++rr) {
        by[rr][0] = f.v[1] - q.py[rr];
        by[rr][1] = f.v[4] - q.py[rr];
        by[rr][2] = f.v[7] - q.py[rr];
      }
#pragma unroll
      for (int rr = 0; rr < kQR; ++rr) {
#pragma unroll
        for (int c = 0; c < kQC; ++c) {
          const float w0 =
              (ax[c][1] * by[rr][2] - ax[c][2] * by[rr][1]) * f.inv;
          const float w1 =
              (ax[c][2] * by[rr][0] - ax[c][0] * by[rr][2]) * f.inv;
          // w2 = (1 - w0) - w1 >= 0 exactly when 1 - w0 >= w1: with
          // gradual underflow the difference of two floats is 0 only when
          // they are equal, and w0, w1 >= 0 rule out inf - inf.
          if (w0 >= 0.0f && w1 >= 0.0f && 1.0f - w0 >= w1)
            mask[rr][c] |= 1u << j;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kQR; ++rr)
#pragma unroll
      for (int c = 0; c < kQC; ++c)
        resolve(buf, base, mask[rr][c], q.px[c], q.py[rr], g, q.best[rr][c]);
  }
}

// NDC centre of pixel p of row r's tile.
__device__ __forceinline__ void pixel(const Geometry& g, int r, int p,
                                      float& px, float& py) {
  const int t = r % g.n_tiles;
  const float row = static_cast<float>((t / g.tw) * g.tile + p / g.tile);
  const float col = static_cast<float>((t % g.tw) * g.tile + p % g.tile);
  px = g.ws - 2.0f * col / g.sm1;
  py = g.hs - 2.0f * row / g.sm1;
}

// The thread's pixel (kQR qr + rr, kQC qc + c) in its row's tile.
__device__ __forceinline__ int quad_pixel(const Geometry& g, int rr, int c) {
  const int across = g.tile / kQC;
  const int qr = threadIdx.x / across, qc = threadIdx.x % across;
  return (kQR * qr + rr) * g.tile + kQC * qc + c;
}

// Start row r: the quad's pixel centres, NaN for the last tile row's and
// column's pixels past the image.
__device__ __forceinline__ void start_quad(const Geometry& g, int r, Quad& q) {
  const float nan = __int_as_float(0x7fffffff);
  const int t = r % g.n_tiles;
  float px, py;
#pragma unroll
  for (int c = 0; c < kQC; ++c) {
    const int p = quad_pixel(g, 0, c);
    pixel(g, r, p, px, py);
    q.px[c] = (t % g.tw) * g.tile + p % g.tile < g.w ? px : nan;
  }
#pragma unroll
  for (int rr = 0; rr < kQR; ++rr) {
    const int p = quad_pixel(g, rr, 0);
    pixel(g, r, p, px, py);
    q.py[rr] = (t / g.tw) * g.tile + p / g.tile < g.h ? py : nan;
  }
#pragma unroll
  for (int rr = 0; rr < kQR; ++rr)
#pragma unroll
    for (int c = 0; c < kQC; ++c) q.best[rr][c] = Best();
}

__device__ __forceinline__ void flush(const Geometry& g, int r, Quad& q,
                                      unsigned long long* scratch) {
  const int P = g.tile * g.tile;
#pragma unroll
  for (int rr = 0; rr < kQR; ++rr)
#pragma unroll
    for (int c = 0; c < kQC; ++c) {
      Best& b = q.best[rr][c];
      if (b.key >= 0) {
        const unsigned long long packed =
            (static_cast<unsigned long long>(__float_as_uint(b.z)) << 32) |
            static_cast<unsigned>(b.key);
        atomicMin(scratch + static_cast<size_t>(r) * P + quad_pixel(g, rr, c),
                  packed);
      }
      b = Best();
    }
}

// Block b walks the items [b * total / grid, (b + 1) * total / grid), one
// thread per 2 x 2 pixels of the 16 x 16 tile; its dynamic shared memory
// holds two buffers of `item` faces.
template <int MODE>
__global__ void __launch_bounds__(256)
raster_tiled_kernel(Inputs in, Geometry g,
                    unsigned long long* __restrict__ scratch) {
  extern __shared__ SFace s_face[];
  const long long total = in.item_cum[in.rows];
  const int i0 = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  if (i0 >= i1) return;
  const int r0 = row_search(in, i0);
  Item cur = make_item(in, r0, i0 - in.item_cum[r0]);
  stage<MODE>(in, g, cur, s_face);
  __pipeline_commit();
  Quad q;
  start_quad(g, cur.row, q);
  for (int i = i0; i < i1; ++i) {
    const bool more = i + 1 < i1;
    Item next = cur;
    if (more) {
      const int r = row_from(in, cur.row, i + 1);
      next = make_item(in, r, i + 1 - in.item_cum[r]);
      stage<MODE>(in, g, next, s_face + ((i + 1 - i0) & 1) * in.item);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    SFace* buf = s_face + ((i - i0) & 1) * in.item;
    finalize(buf, cur.m, g.eps);
    __syncthreads();
    test_item(buf, cur.m, g, q);
    if (!more || next.row != cur.row) {
      flush(g, cur.row, q, scratch);
      if (more) start_quad(g, next.row, q);
    }
    __syncthreads();  // buf is refilled two items on
    cur = next;
  }
}

// One block per row, one thread per pixel: unpack the winner, recompute its
// barycentrics, write zbuf (-1 = empty), id (-1), b0, b1 (0).
template <int MODE>
__global__ void __launch_bounds__(1024)
raster_tiled_epilogue(Inputs in, Geometry g,
                      const unsigned long long* __restrict__ scratch,
                      float* __restrict__ zbuf, int* __restrict__ id,
                      float* __restrict__ b0, float* __restrict__ b1) {
  const int r = blockIdx.x;
  const size_t o = static_cast<size_t>(r) * blockDim.x + threadIdx.x;
  const unsigned long long packed = scratch[o];
  if (packed == kEmpty) {
    zbuf[o] = -1.0f;
    id[o] = -1;
    b0[o] = 0.0f;
    b1[o] = 0.0f;
    return;
  }
  const int key = static_cast<int>(packed & 0xffffffffu);
  const float* src;
  int stride = 1;
  if (MODE == kPairs) {
    src = in.pfv + static_cast<size_t>(key) * 9;
  } else if (MODE == kLanes) {
    src = in.tile_fv + static_cast<size_t>(r) * 9 * in.K + key;
    stride = in.K;
  } else {
    src = in.faces +
          (static_cast<size_t>(r / g.n_tiles) * in.F + key) * 9;
  }
  float v[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) v[c] = src[c * stride];
  float px, py, z, bb0, bb1;
  pixel(g, r, threadIdx.x, px, py);
  const float inv_area = 1.0f / signed_area(v);
  const float w0 = ((v[3] - px) * (v[7] - py) - (v[6] - px) * (v[4] - py)) *
                   inv_area;
  const float w1 = ((v[6] - px) * (v[1] - py) - (v[0] - px) * (v[7] - py)) *
                   inv_area;
  depth(w0, w1, 1.0f - w0 - w1, v, g, z, bb0, bb1);
  zbuf[o] = __uint_as_float(static_cast<unsigned>(packed >> 32));
  id[o] = MODE == kPairs ? in.pface[key] : key;
  b0[o] = bb0;
  b1[o] = bb1;
}

// One warp per row: the pairs it tests, its tested lanes compacted, its
// item count into per_row[r + 1] (per_row[0] = 0, so that an inclusive
// scan of per_row is the item table), and its scratch set to empty.
__global__ void __launch_bounds__(256)
raster_items_kernel(const int* __restrict__ starts,
                    const int* __restrict__ counts, int nfe, int k_cap,
                    const unsigned char* __restrict__ lane_valid,
                    const int* __restrict__ lane_counts, int K, int k_chunk,
                    int rows, int item, int P, int* __restrict__ n_pairs,
                    int* __restrict__ lane_idx, int* __restrict__ n_lanes,
                    int* __restrict__ per_row,
                    unsigned long long* __restrict__ scratch) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  int np = 0, nl = 0;
  if (counts != nullptr)
    np = max(0, min(min(counts[r], k_cap), nfe - starts[r]));
  if (lane_valid != nullptr) {
    const int kc = min(k_chunk, K);
    const int c = max(0, lane_counts[r]);
    const int n_tile = min(K, (c + kc - 1) / kc * kc);
    const size_t rk = static_cast<size_t>(r) * K;
    for (int base = 0; base < K; base += 32) {
      const int l = base + lane;
      const bool ok = l < n_tile && lane_valid[rk + l] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) lane_idx[rk + nl + __popc(mask & ((1u << lane) - 1u))] = l;
      nl += __popc(mask);
    }
  }
  if (lane == 0) {
    if (counts != nullptr) n_pairs[r] = np;
    if (lane_valid != nullptr) n_lanes[r] = nl;
    per_row[r + 1] = (np + item - 1) / item + (nl + item - 1) / item;
    if (r == 0) per_row[0] = 0;
  }
  if (scratch != nullptr)
    for (int p = lane; p < P; p += 32)
      scratch[static_cast<size_t>(r) * P + p] = kEmpty;
}

template <int MODE>
int launch(const Inputs& in, const Geometry& g, unsigned long long* scratch,
           float* zbuf, int* id, float* b0, float* b1, cudaStream_t stream) {
  const int P = g.tile * g.tile;
  const size_t smem = 2 * in.item * sizeof(SFace);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = P / (kQR * kQC);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, raster_tiled_kernel<MODE>, threads, smem);
  const int grid = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  raster_tiled_kernel<MODE><<<grid, threads, smem, stream>>>(in, g, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_tiled_epilogue<MODE><<<in.rows, P, 0, stream>>>(in, g, scratch, zbuf,
                                                         id, b0, b1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int macarons_raster_items(
    const int* starts, const int* counts, int nfe, int k_cap,
    const unsigned char* lane_valid, const int* lane_counts, int K,
    int k_chunk, int rows, int item, int P, int* n_pairs, int* lane_idx,
    int* n_lanes, int* per_row, unsigned long long* scratch, void* stream) {
  if (rows == 0) return 0;
  const int warps = 256 / 32;
  raster_items_kernel<<<(rows + warps - 1) / warps, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      starts, counts, nfe, k_cap, lane_valid, lane_counts, K, k_chunk, rows,
      item, P, n_pairs, lane_idx, n_lanes, per_row, scratch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int macarons_raster_tiled(
    int mode, const float* pfv, const int* pface, const int* starts,
    const int* n_pairs, const float* tile_fv, const int* lane_idx,
    const int* lane_face, const int* n_lanes, int K, const float* faces, int F,
    const int* item_cum, int rows, int item, int n_tiles, int tile, int tw,
    int h, int w, float ws, float hs, int persp, float eps,
    unsigned long long* scratch, float* zbuf, int* id, float* b0, float* b1,
    void* stream) {
  if (rows == 0) return 0;
  if (item < 1 || item > kMaxItem || tile % kQR != 0 || tile % kQC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int s = h < w ? h : w;
  const Geometry g{n_tiles, tile, tw, h, w, ws, hs,
                   static_cast<float>(s - 1), persp, eps};
  const Inputs in{pfv, pface, starts, n_pairs, tile_fv, lane_idx, lane_face,
                  n_lanes, K, faces, F, item_cum, rows, item};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPairs: return launch<kPairs>(in, g, scratch, zbuf, id, b0, b1, st);
    case kLanes: return launch<kLanes>(in, g, scratch, zbuf, id, b0, b1, st);
    case kFused: return launch<kFused>(in, g, scratch, zbuf, id, b0, b1, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
