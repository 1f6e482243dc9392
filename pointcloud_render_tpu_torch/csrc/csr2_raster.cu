// v1 and v2 strip-tile rasterizers for Hopper (sm_90a): one CTA per
// tile_h x tile_w pixel tile (8 x 128 by default).  Three kernels share
// one template:
//   * csr2_raster replaces pallas_csr2._make_kernel (v2) over its generic
//     16-float rows [params 0..11, id, kind, bucket_low, 0];
//   * csr2_disc8 replaces the same kernel over its discs_only 8-float
//     rows [px, py, z, r*r, id, bucket_low, 0, 0];
//   * csr1_raster replaces pallas_csr._make_kernel (v1): the generic rows
//     again, staged 128 at a time (v1's DMA chunk) instead of 512.
// Binning (raster/csr.py's bin_csr, the JAX package's _bin_csr): a prim
// whose bbox covers at most max_tiles_per_prim tiles is expanded into one
// entry per tile, and the (tile * 16 + depth bucket) keys are sorted
// stably, so a tile's rows are one contiguous range [starts[t],
// starts[t+1]) of the sorted rows, front to back by bucket; wider prims
// ride the big list, dense 16-float rows of every kind.
//
// A tile walks the big list first (through the triangle-aware body: a
// row whose kind is 2 takes the edge functions, any other the capsule
// body, as _eval_scalar does), then its range in chunks staged through
// shared memory (rows are in sorted order: a coalesced copy, no gather).
// Binned generic rows take the kind branch too, or the capsule body alone
// under no_triangles (triangles then ride the big list, as on the TPU);
// disc rows are covered where dx * dx + dy * dy <= r * r.  After each
// chunk the saturation exit of pallas_csr.py:182-192: once every pixel of
// the tile is covered and the chunk's last row's bucket_low is strictly
// greater than the deepest pixel, no later row can win a pixel (later
// rows sit in the same or later buckets, whose depths are at least that
// bound; strict: an equal depth with a lower id could still win), so the
// tile stops.  The exit never changes a winner, so the port may take it
// at its own granularity: here the whole CTA decides it after each chunk
// over the tile's pixels inside the image, and skips the block-wide max
// while any of them is still empty (__syncthreads_or).  A tile of more
// than 1024 pixels is walked in passes of 1024 pixels, each with its own
// exit.  `walked` reports the rows each tile evaluated before its exits
// (summed over its passes).
//
// Winner per pixel = lexicographic min of (depth, primitive id) with
// strict compares, so the walk order does not matter; index -1 where the
// depth is infinite.  The per-pair bodies are raster_pairs.cuh's, shared
// with csr6_raster.cu.  Exactness needs IEEE float32 per operation: build
// with -fmad=false and without --use_fast_math.
//
// What bounds it on an H100: per-pair arithmetic, as in csr6_raster.cu
// (17 float32 operations per capsule pair, 18 per triangle pair, 4 per
// disc pair; here dx is evaluated per pixel, not per column), over 1024
// pixels x the rows each tile walked before its exit, plus every pixel x
// every live big row.

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // clip01, capsule_pair, tri_pair, merge_pair

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPix = 1024;             // pixels per pass of a CTA
constexpr int kPix = kBlockPix / kThreads;  // pixels per thread per pass
constexpr float kEmptyId = 16777216.0f;     // 2^24 > every prim id

// One staged 16-float row [p0..p11, id, kind, bucket_low, 0] at this
// thread's pixels: the triangle body where kAnyKind and kind == 2, else
// the capsule body (a disc is a capsule with a zero axis).
template <bool kAnyKind>
__device__ __forceinline__ void eval_row16(const float4* row, const float* qx,
                                           const float* qy, float* d,
                                           float* di) {
  const float4 a = row[0];  // p0..p3: x0, y0, z0, r0
  const float4 b = row[1];  // p4..p7: sdx, sdy, sdz, sdr
  const float4 c = row[2];  // p8..p11: il2 (triangles: c2, w0, w1, w2)
  const float4 e = row[3];  // id, kind, bucket_low, 0
  // The row is the same for every thread (a shared-memory broadcast), so
  // the kind branch does not diverge.
  if (kAnyKind && e.y == 2.0f) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      float z;
      const bool cov = tri_pair(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x,
                                c.y, c.z, c.w, qx[k], qy[k], &z);
      merge_pair(cov, z, e.x, &d[k], &di[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      float z;
      const bool cov = capsule_pair(qx[k] - a.x, qy[k] - a.y, a.z, a.w, b.x,
                                    b.y, b.z, b.w, c.x, &z);
      merge_pair(cov, z, e.x, &d[k], &di[k]);
    }
  }
}

// One staged 8-float disc row [px, py, z, r*r, id, bucket_low, 0, 0]
// (pallas_csr2._eval_disc_row).
__device__ __forceinline__ void eval_row8(const float4* row, const float* qx,
                                          const float* qy, float* d,
                                          float* di) {
  const float4 a = row[0];  // px, py, z, r*r
  const float idf = row[1].x;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float dx = qx[k] - a.x;
    const float dy = qy[k] - a.y;
    merge_pair(dx * dx + dy * dy <= a.w, a.z, idf, &d[k], &di[k]);
  }
}

// rows (>= starts[T], kRowF) f32 in sorted order; big_rows (>= *big_n,
// 16) f32; staged kChunk rows at a time.
template <int kRowF, int kChunk, bool kAnyKind>
__global__ void __launch_bounds__(kThreads)
strip_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
             const float* __restrict__ big_rows,
             const int* __restrict__ big_n_ptr, float* __restrict__ depth_out,
             int* __restrict__ index_out, int* __restrict__ walked, int width,
             int height, int tiles_x, int tile_h, int tile_w,
             int allow_exit) {
  constexpr int kRowF4 = kRowF / 4;
  constexpr int kStage = kChunk * kRowF4;  // float4 slots of the staging
  constexpr int kBigChunk = kStage / 4;    // 16-float big rows per stage
  constexpr int kBoundLane = kRowF == 16 ? 14 : 5;
  __shared__ float4 sh[kStage];
  __shared__ float warp_max[kThreads / 32];
  const float inf = __int_as_float(0x7f800000);
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int npix = tile_h * tile_w;
  const int big_n = *big_n_ptr;
  const int s = starts[tile];
  const int n = starts[tile + 1] - s;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const float4* big4 = reinterpret_cast<const float4*>(big_rows);
  const float* shf = reinterpret_cast<const float*>(sh);
  int walked_sum = 0;
  for (int pb = 0; pb < npix; pb += kBlockPix) {
    float qx[kPix], qy[kPix], d[kPix], di[kPix];
    int out[kPix];  // the pixel's offset in the image, -1 outside it
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = pb + tid + k * kThreads;
      const int col = tx * tile_w + p % tile_w;
      const int row = ty * tile_h + p / tile_w;
      out[k] = (p < npix && col < width && row < height) ? row * width + col
                                                         : -1;
      qx[k] = static_cast<float>(col) + 0.5f;
      qy[k] = static_cast<float>(row) + 0.5f;
      d[k] = inf;
      di[k] = kEmptyId;
    }

    // The big list first: it fills what the binned rows leave empty,
    // which arms the exit.
    for (int base = 0; base < big_n; base += kBigChunk) {
      const int cnt = min(kBigChunk, big_n - base);
      __syncthreads();
      for (int i = tid; i < cnt * 4; i += kThreads)
        sh[i] = big4[static_cast<long long>(base) * 4 + i];
      __syncthreads();
      for (int r = 0; r < cnt; ++r)
        eval_row16<true>(sh + r * 4, qx, qy, d, di);
    }

    // The tile's range, front to back by depth bucket.
    int done = n;
    for (int base = 0; base < n; base += kChunk) {
      const int cnt = min(kChunk, n - base);
      __syncthreads();
      for (int i = tid; i < cnt * kRowF4; i += kThreads)
        sh[i] = rows4[static_cast<long long>(s + base) * kRowF4 + i];
      __syncthreads();
      for (int r = 0; r < cnt; ++r) {
        if constexpr (kRowF == 16)
          eval_row16<kAnyKind>(sh + r * 4, qx, qy, d, di);
        else
          eval_row8(sh + r * 2, qx, qy, d, di);
      }
      // The saturation exit, decided by the whole CTA.
      if (!allow_exit) continue;
      bool empty = false;
      float m = -inf;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (out[k] >= 0) {
          empty |= d[k] == inf;
          m = fmaxf(m, d[k]);
        }
      }
      if (__syncthreads_or(empty)) continue;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) warp_max[warp] = m;
      __syncthreads();
      float tmax = warp_max[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) tmax = fmaxf(tmax, warp_max[w]);
      if (shf[(cnt - 1) * kRowF + kBoundLane] > tmax) {  // the same for all
        done = base + cnt;
        break;
      }
    }
    walked_sum += done;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (out[k] >= 0) {
        depth_out[out[k]] = d[k];
        index_out[out[k]] = isinf(d[k]) ? -1 : static_cast<int>(di[k]);
      }
    }
  }
  if (walked != nullptr && tid == 0) walked[tile] = walked_sum;
}

template <int kRowF, int kChunk>
int launch(const float* rows, const int* starts, const float* big_rows,
           const int* big_n, float* depth, int* index, int* walked,
           int width, int height, int tiles_x, int tiles_y, int tile_h,
           int tile_w, int no_triangles, int allow_exit, void* stream) {
  if (tile_h < 1 || tile_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kRowF == 16 && !no_triangles)
    strip_kernel<kRowF, kChunk, true><<<num_tiles, kThreads, 0, st>>>(
        rows, starts, big_rows, big_n, depth, index, walked, width, height,
        tiles_x, tile_h, tile_w, allow_exit);
  else
    strip_kernel<kRowF, kChunk, false><<<num_tiles, kThreads, 0, st>>>(
        rows, starts, big_rows, big_n, depth, index, walked, width, height,
        tiles_x, tile_h, tile_w, allow_exit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// rows (>= starts[T], 16 or 8) f32 in sorted order; starts (T+1) i32 the
// tiles' row ranges (T = tiles_x * tiles_y, row-major); big_rows (>=
// *big_n, 16) f32; big_n one i32 on the device; depth (H, W) f32; index
// (H, W) i32; walked null or (T) i32, each tile's count of rows evaluated
// before its exit; no_triangles != 0 evaluates the binned 16-float rows
// through the capsule body alone; allow_exit == 0 walks every row.
extern "C" int csr2_raster(const float* rows, const int* starts,
                           const float* big_rows, const int* big_n,
                           float* depth, int* index, int* walked, int width,
                           int height, int tiles_x, int tiles_y, int tile_h,
                           int tile_w, int no_triangles, int allow_exit,
                           void* stream) {
  return launch<16, 512>(rows, starts, big_rows, big_n, depth, index, walked,
                         width, height, tiles_x, tiles_y, tile_h, tile_w,
                         no_triangles, allow_exit, stream);
}

// The discs_only walk of v2 over 8-float disc rows (no_triangles unused).
extern "C" int csr2_disc8(const float* rows, const int* starts,
                          const float* big_rows, const int* big_n,
                          float* depth, int* index, int* walked, int width,
                          int height, int tiles_x, int tiles_y, int tile_h,
                          int tile_w, int no_triangles, int allow_exit,
                          void* stream) {
  return launch<8, 512>(rows, starts, big_rows, big_n, depth, index, walked,
                        width, height, tiles_x, tiles_y, tile_h, tile_w,
                        no_triangles, allow_exit, stream);
}

// v1: the generic walk staged in chunks of 128 rows.
extern "C" int csr1_raster(const float* rows, const int* starts,
                           const float* big_rows, const int* big_n,
                           float* depth, int* index, int* walked, int width,
                           int height, int tiles_x, int tiles_y, int tile_h,
                           int tile_w, int no_triangles, int allow_exit,
                           void* stream) {
  return launch<16, 128>(rows, starts, big_rows, big_n, depth, index, walked,
                         width, height, tiles_x, tiles_y, tile_h, tile_w,
                         no_triangles, allow_exit, stream);
}

extern "C" const char* csr2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
