// v5 chunk-binned disc rasterizer for Hopper (sm_90a): one CTA per tile
// of 1024 pixels (tile_h x tile_w, tile_w in {16, 32, 64, 128}).  Two
// kernels share one template:
//   * csr5_raster  -> depth and index;
//   * csr5_shaded  -> depth, index and the shaded rgb: the merge carries
//     the winner's px, py, rflag and rgb, and the tile's epilogue
//     evaluates the sphere-Lambert shade.
// Both replace pallas_csr5._make_kernel5 (pointcloud_render_tpu/raster/
// pallas_csr5.py), the chunk-binned disc walk over Morton-ordered clouds.
//
// Binning (raster/csr5.py's bin_chunks5, the JAX package's _bin_chunks5):
// runs of k consecutive prims are chunks; a chunk whose discs span at most
// max_span^2 tiles gets one (tile, z-bucket of its depth minimum) entry per
// covered tile; discs of wider chunks get singleton rows (the prim in slot
// 0, pad slots after it) binned on their own 2x2 tiles.  The chunk table
// holds one superrow of k slots [px, py, z, r, idf, c0, c1, c2] per chunk
// (non-binnable slots: r = 0, z = +inf, their id lane kept), then the
// singleton rows, then a pad row; a tile's entries are the chunk ids
// chunks[starts[t] .. starts[t+1]), ascending in bucket.  Capsules,
// triangles and discs that fit nowhere ride the big list: (17, big_cap)
// rows [12 params, id, r, g, b, rflag] and their kinds.
//
// A tile walks the big list first, each row through the triangle body
// (kind 2) or the capsule body (a disc is a capsule with a zero axis) of
// raster_pairs.cuh, merged with the full (depth, id) compare (pallas_csr.
// _eval_scalar with the merge of pallas_csr5.py:334).  Then its run of
// chunk ids: the superrows are read straight from the chunk table by id,
// staged through shared memory (no gathered copy of the entries exists),
// and at each pixel the k slots are taken in id order with a strict <
// (dx*dx + dy*dy <= r*r, z < the row's depth): the lowest slot wins an
// equal depth.  The row winner (z, base id + slot, base id = slot 0's id
// lane) merges into the tile's winner with the full lexicographic compare
// (pallas_csr5.py:399-401), so the result does not depend on the order of
// the entries.  Under csr5_shaded the winning slot's px, py, r and rgb are
// read from the staged row at the merge (the uniform color of `meta` for
// binned winners under `uniform`).
//
// The exit (pallas_csr5.py:422-463): entries ascend in the bucket of
// their chunk's depth minimum, and a superrow's depth minimum over its
// slots is that minimum (inert slots hold +inf), so after every
// `check_every` superrows every later prim lies at or past
// zmin + max(floor((zrow - zmin) * s) - 1, 0) * thr_scale, zrow the last
// superrow's depth minimum.  The tile stops when that bound is strictly
// greater than every in-image pixel's winning depth (strict: an equal
// depth with a lower id could still win); the CTA decides it in one
// __syncthreads_and (an empty pixel's +inf keeps the walk going).  The
// exit never changes a winner; allow_exit = 0 walks every entry.
// `walked` reports the superrows each tile evaluated before its exit.
//
// The epilogue (pallas_csr5.py:496-520, the formula of
// shading.shade_framebuffer): inv_r = 1 / max(rf, 1e-6),
// u = (qx - px) * inv_r, v = -(qy - py) * inv_r,
// nz = -sqrt(max(0, 1 - u*u - v*v)), lit = ambient + diffuse *
// max(u*lx + v*ly + nz*lz, 0); rgb = c * lit where rf > 0 (a disc), the
// preshaded c otherwise, the background where empty, clipped to [0, 1].
// Exactness needs IEEE float32 per operation: build with -fmad=false and
// without --use_fast_math; the divide and the root are __fdiv_rn and
// __fsqrt_rn.
//
// What bounds it on an H100: per-pair arithmetic.  Every entry streams
// all k slots of its superrow to the tile's 1024 pixels; a slot pair must
// execute 4 float32 operations (dy, dy * dy, + dx * dx, <= r * r; dx * dx
// and r * r are per slot and column), the strict < on depth only where
// covered; the row merge is per superrow and pixel.  A superrow is 512 B
// (k = 16), read once per entry.  Design: 256 threads, 4 pixels each (one
// column per thread), superrows staged through shared memory (all threads
// read the same slot: a broadcast), the row winner kept as (depth, slot)
// in registers.  Not done yet: asynchronous staging (cp.async / TMA) and
// load balancing of dense tiles.

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // clip01, capsule_pair, tri_pair

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 1024 / kThreads;  // pixels per thread
constexpr int kBigF = 17;              // big row: 12 params, id, rgb, rflag
constexpr int kBigChunk = kThreads;    // big rows per stage
constexpr int kStageF = kBigF * kBigChunk;  // staged floats (17 KB)
constexpr int kRowF = 8;                    // floats per slot
constexpr float kEmpty = 16777216.0f;       // 2^24 > every prim id

// jnp.minimum: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
csr5_tile_kernel(const float* __restrict__ tab, const int* __restrict__ chunks,
                 const int* __restrict__ starts,
                 const float* __restrict__ big_params,
                 const int* __restrict__ big_kinds,
                 const int* __restrict__ big_n_ptr,
                 const float* __restrict__ meta, float* __restrict__ depth_out,
                 int* __restrict__ index_out, float* __restrict__ rgb_out,
                 int* __restrict__ walked, int big_cap, int width, int height,
                 int tiles_x, int tile_h, int tile_w, int k, int check_every,
                 int allow_exit, int uniform) {
  __shared__ __align__(16) float sh[kStageF];
  __shared__ int sh_kind[kBigChunk];
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  // Pixel tid + 256 j of the tile: column tid % tile_w (tile_w divides
  // 256, so the same for every j), row (tid + 256 j) / tile_w.
  const int x = tx * tile_w + tid % tile_w;
  const float qx = static_cast<float>(x) + 0.5f;
  float qy[kPix], d[kPix], di[kPix];
  bool in_img[kPix];
  float apx[kPix], apy[kPix], arf[kPix], acr[kPix], acg[kPix], acb[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int y = ty * tile_h + (tid + kThreads * j) / tile_w;
    qy[j] = static_cast<float>(y) + 0.5f;
    in_img[j] = x < width && y < height;
    d[j] = inf;
    di[j] = kEmpty;
    apx[j] = apy[j] = acr[j] = acg[j] = acb[j] = 0.0f;
    arf[j] = -1.0f;
  }

  // Big list: capsules, triangles and wide discs, the full compare.
  const int big_n = min(*big_n_ptr, big_cap);
  for (int base = 0; base < big_n; base += kBigChunk) {
    const int cnt = min(kBigChunk, big_n - base);
    __syncthreads();
    if (tid < cnt) {
#pragma unroll
      for (int r = 0; r < kBigF; ++r)
        sh[r * kBigChunk + tid] =
            big_params[static_cast<long long>(r) * big_cap + base + tid];
      sh_kind[tid] = big_kinds[base + tid];
    }
    __syncthreads();
    for (int b = 0; b < cnt; ++b) {
      float p[12];
#pragma unroll
      for (int r = 0; r < 12; ++r) p[r] = sh[r * kBigChunk + b];
      const float idf = sh[12 * kBigChunk + b];
      // The same row for every thread: the kind branch does not diverge.
      const bool tri = sh_kind[b] == 2;
      const float dx = qx - p[0];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float z;
        const bool cov =
            tri ? tri_pair(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                           p[8], p[9], p[10], p[11], qx, qy[j], &z)
                : capsule_pair(dx, qy[j] - p[1], p[2], p[3], p[4], p[5],
                               p[6], p[7], p[8], &z);
        if (cov && ((z < d[j]) || ((z == d[j]) && (idf < di[j])))) {
          d[j] = z;
          di[j] = idf;
          if constexpr (kFused) {
            apx[j] = p[0];
            apy[j] = p[1];
            arf[j] = sh[16 * kBigChunk + b];
            acr[j] = sh[13 * kBigChunk + b];
            acg[j] = sh[14 * kBigChunk + b];
            acb[j] = sh[15 * kBigChunk + b];
          }
        }
      }
    }
  }

  // The tile's run of chunk entries, superrows staged by chunk id.
  const int s0 = starts[tile];
  const int n = starts[tile + 1] - s0;
  const int row_f = k * kRowF;
  const int row_f4 = row_f / 4;
  const int stage_rows = kStageF / row_f;
  const float zmin = meta[0], zs = meta[1], thr = meta[2];
  const float ucr = meta[11], ucg = meta[12], ucb = meta[13];
  int done = n;  // superrows evaluated before the exit
  bool stop = false;
  for (int base = 0; base < n && !stop; base += stage_rows) {
    const int cnt = min(stage_rows, n - base);
    __syncthreads();
    float4* sh4 = reinterpret_cast<float4*>(sh);
    for (int i = tid; i < cnt * row_f4; i += kThreads) {
      const int r = i / row_f4;
      const float4* src = reinterpret_cast<const float4*>(
          tab + static_cast<long long>(chunks[s0 + base + r]) * row_f);
      sh4[i] = src[i - r * row_f4];
    }
    __syncthreads();
    for (int r = 0; r < cnt; ++r) {
      const float* row = sh + r * row_f;
      float rz[kPix];
      int rs[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        rz[j] = inf;
        rs[j] = k;
      }
      for (int u = 0; u < k; ++u) {
        const float* slot = row + u * kRowF;
        const float z = slot[2], rad = slot[3];
        const float dx = qx - slot[0];
        const float dx2 = dx * dx;
        const float r2 = rad * rad;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float dy = qy[j] - slot[1];
          if ((dx2 + dy * dy <= r2) && z < rz[j]) {
            rz[j] = z;
            rs[j] = u;
          }
        }
      }
      const float base_idf = row[4];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (rs[j] == k) continue;  // no slot covered this pixel
        const float idf = base_idf + static_cast<float>(rs[j]);
        if ((rz[j] < d[j]) || ((rz[j] == d[j]) && (idf < di[j]))) {
          d[j] = rz[j];
          di[j] = idf;
          if constexpr (kFused) {
            const float* w = row + rs[j] * kRowF;
            apx[j] = w[0];
            apy[j] = w[1];
            arf[j] = w[3];
            acr[j] = uniform ? ucr : w[5];
            acg[j] = uniform ? ucg : w[6];
            acb[j] = uniform ? ucb : w[7];
          }
        }
      }
      const int g = base + r + 1;
      if (allow_exit && g < n && g % check_every == 0) {
        float zrow = row[2];
        for (int u = 1; u < k; ++u) zrow = min_nan(zrow, row[u * kRowF + 2]);
        float q = floorf((zrow - zmin) * zs) - 1.0f;
        q = q < 0.0f ? 0.0f : q;  // NaN stays NaN (jnp.maximum): no exit
        const float bound = zmin + q * thr;
        bool past = true;
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (in_img[j] && !(bound > d[j])) past = false;
        if (__syncthreads_and(past)) {  // the same in every thread
          done = g;
          stop = true;
          break;
        }
      }
    }
  }
  if (walked != nullptr && tid == 0) walked[tile] = done;

  float lx = 0.0f, ly = 0.0f, lz = 0.0f, amb = 0.0f, dif = 0.0f;
  float bg[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kFused) {
    lx = meta[3];
    ly = meta[4];
    lz = meta[5];
    amb = meta[6];
    dif = meta[7];
    bg[0] = meta[8];
    bg[1] = meta[9];
    bg[2] = meta[10];
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!in_img[j]) continue;
    const int y = ty * tile_h + (tid + kThreads * j) / tile_w;
    const long long o = static_cast<long long>(y) * width + x;
    depth_out[o] = d[j];
    if constexpr (!kFused) {
      index_out[o] = isinf(d[j]) ? -1 : static_cast<int>(di[j]);
    } else {
      index_out[o] = isfinite(d[j]) ? static_cast<int>(di[j]) : -1;
      const float rf = arf[j];
      const float inv_r = __fdiv_rn(1.0f, rf < 1e-6f ? 1e-6f : rf);
      const float u = (qx - apx[j]) * inv_r;
      const float v = -(qy[j] - apy[j]) * inv_r;
      float w2 = 1.0f - u * u - v * v;
      w2 = w2 < 0.0f ? 0.0f : w2;  // jnp.maximum: NaN stays NaN
      const float nz = -__fsqrt_rn(w2);
      const float ndotl = u * lx + v * ly + nz * lz;
      const float lit = amb + dif * (ndotl < 0.0f ? 0.0f : ndotl);
      const bool is_disc = rf > 0.0f;
      const bool hit = d[j] < inf;
      const float cc[3] = {acr[j], acg[j], acb[j]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float val = hit ? (is_disc ? cc[c] * lit : cc[c]) : bg[c];
        rgb_out[o * 3 + c] = clip01(val);
      }
    }
  }
}

int check_args(int tiles_x, int tiles_y, int tile_h, int tile_w, int k,
               int check_every) {
  if (tile_h * tile_w != 1024 ||
      (tile_w != 16 && tile_w != 32 && tile_w != 64 && tile_w != 128) ||
      k < 1 || k * kRowF > kStageF || check_every < 1 || tiles_x < 0 ||
      tiles_y < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// tab (C', 8k) f32 superrows; chunks (>= starts[T]) i32 chunk ids in key
// order; starts (T+1) i32 per-tile entry ranges; big_params (17, big_cap)
// f32 and big_kinds (big_cap) i32, the first *big_n live; big_n one i32 on
// the device; meta (16) f32 [zmin, s, thr_scale, light (3), ambient,
// diffuse, background (3), uniform color (3), 0, 0]; depth (H, W) f32;
// index (H, W) i32; walked null or (T) i32, each tile's superrows
// evaluated before its exit; allow_exit != 0 checks the exit every
// check_every superrows.
extern "C" int csr5_raster(const float* tab, const int* chunks,
                           const int* starts, const float* big_params,
                           const int* big_kinds, const int* big_n,
                           const float* meta, float* depth, int* index,
                           int* walked, int big_cap, int width, int height,
                           int tiles_x, int tiles_y, int tile_h, int tile_w,
                           int k, int check_every, int allow_exit,
                           void* stream) {
  const int bad = check_args(tiles_x, tiles_y, tile_h, tile_w, k,
                             check_every);
  if (bad) return bad;
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles == 0) return 0;
  csr5_tile_kernel<false><<<num_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      tab, chunks, starts, big_params, big_kinds, big_n, meta, depth, index,
      nullptr, walked, big_cap, width, height, tiles_x, tile_h, tile_w, k,
      check_every, allow_exit, 0);
  return static_cast<int>(cudaGetLastError());
}

// csr5_raster that also writes the shaded rgb (H, W, 3) f32; uniform != 0
// takes the binned winners' color from meta.
extern "C" int csr5_shaded(const float* tab, const int* chunks,
                           const int* starts, const float* big_params,
                           const int* big_kinds, const int* big_n,
                           const float* meta, float* depth, int* index,
                           float* rgb, int* walked, int big_cap, int width,
                           int height, int tiles_x, int tiles_y, int tile_h,
                           int tile_w, int k, int check_every, int allow_exit,
                           int uniform, void* stream) {
  const int bad = check_args(tiles_x, tiles_y, tile_h, tile_w, k,
                             check_every);
  if (bad) return bad;
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles == 0) return 0;
  csr5_tile_kernel<true><<<num_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      tab, chunks, starts, big_params, big_kinds, big_n, meta, depth, index,
      rgb, walked, big_cap, width, height, tiles_x, tile_h, tile_w, k,
      check_every, allow_exit, uniform);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csr5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
