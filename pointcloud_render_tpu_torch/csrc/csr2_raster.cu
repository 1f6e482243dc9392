// v1 and v2 strip-tile rasterizers for Hopper (sm_90a) over tile_h x
// tile_w pixel tiles (8 x 128 by default).  Three kernels:
//   * csr2_raster replaces pallas_csr2._make_kernel (v2) over its generic
//     16-float rows [params 0..11, id, kind, bucket_low, 0] (the split
//     walk below);
//   * csr2_disc8 replaces the same kernel over its discs_only 8-float
//     rows [px, py, z, r*r, id, bucket_low, 0, 0];
//   * csr1_raster replaces pallas_csr._make_kernel (v1): the generic rows
//     again, staged 128 at a time (v1's DMA chunk) instead of 512.
// csr2_disc8 and csr1_raster run one CTA per tile (strip_kernel) and
// stage synchronously: moving them onto the split walk is not done yet.
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
// over the tile's pixels inside the image.  A tile of more than 1024
// pixels is walked in passes of 1024 pixels, each with its own exit.
// `walked` reports the rows each tile evaluated before its exits (summed
// over its passes).
//
// csr2_raster's split walk (split_walk.cuh: plan, persistent walk,
// merge).  One CTA per tile left a dense strip's whole range on one SM
// (traj_ball's cloud projects to the frame's centre).  A unit is one
// pass of 1024 pixels of a strip; split_plan_kernel cuts a unit of more
// than split_rows rows (its big rows, then its range) into work items;
// csr2_walk_kernel's persistent CTAs take them from a counter, and
// csr2_merge_kernel folds a split unit's per-item minima.  A strip's rows
// are one contiguous run of 64 B rows, 16-byte aligned, so a chunk of 256
// rows is one bulk copy (cp.async.bulk, the TMA unit's one-dimensional
// form) issued by one thread into a two-slot ring and completed on an
// mbarrier, the next chunk in flight while one is evaluated.  The exit
// across a split unit's items: each folds its minima into the unit's
// `front` depths (reset by the plan) by atomicMin after every chunk and
// tests the rule against them (never below the unit's final depths, so
// the rule stays sound: every in-image depth below the bound), one
// barrier per chunk; alone, an item holding a slice of a strip would see
// the pixels other items cover as empty and never leave.  The plan hands
// the items out in waves, front to back (see csr2_walk_kernel).  Where
// the strip width divides 256, a thread's 4 pixels share a column, so dx
// and dx * sdx are evaluated once per row (the expression order of
// capsule_pair unchanged); a triangle's 1 / iz only at covered pairs,
// where it is tri_pair's depth.
//
// Winner per pixel = lexicographic min of (depth, primitive id) with
// strict compares, so the walk order does not matter; index -1 where the
// depth is infinite.  The per-pair bodies are raster_pairs.cuh's, shared
// with csr6_raster.cu.  Exactness needs IEEE float32 per operation: build
// with -fmad=false and without --use_fast_math.
//
// What bounds it on an H100: per-pair arithmetic, as in csr6_raster.cu
// (17 float32 operations per capsule pair, 18 per triangle pair, 4 per
// disc pair; csr2_disc8 and csr1_raster evaluate dx per pixel, not per
// column), over 1024 pixels x the rows each tile walked before its exit,
// plus every pixel x every live big row.

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // clip01, capsule_pair, tri_pair, merge_pair
#include "split_walk.cuh"    // plan, item counter, staging, merge

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

// ---------------------------------------------------------------------------
// The split walk of csr2_raster (see the header).  A unit is one pass of
// 1024 pixels of a strip: unit u = strip * passes + pass.

constexpr int kWalkChunk = 256;               // 64 B rows per ring slot
constexpr int kWalkSlotF = kWalkChunk * 16;   // floats per slot (16 KB)
constexpr int kWalkRingBytes = 2 * kWalkSlotF * 4;

// The binned rows of unit u for split_plan_kernel: its strip's range.
struct StripRows {
  const int* starts;
  int passes;
  __device__ int operator()(int u) const {
    const int t = u / passes;
    return starts[t + 1] - starts[t];
  }
};

// The image offset of pixel p of strip (tx, ty), -1 outside the strip or
// the image.
__device__ __forceinline__ int strip_pixel(int p, int tx, int ty, int tile_h,
                                           int tile_w, int width,
                                           int height) {
  const int col = tx * tile_w + p % tile_w;
  const int row = ty * tile_h + p / tile_w;
  return (p < tile_h * tile_w && col < width && row < height)
             ? row * width + col
             : -1;
}

// Staged 16-float rows [0, count) at this thread's pixels: the triangle
// body where kAnyKind and the row's kind is 2 (1 / iz only at covered
// pairs, where iz > 0: tri_pair's depth), else the capsule body.  Under
// kSharedCol the thread's pixels share one column (qx[0]), so dx and
// dx * sdx are evaluated once per row.
template <bool kAnyKind, bool kSharedCol>
__device__ __forceinline__ void eval_strip_rows(const float4* sh, int count,
                                                const float* qx,
                                                const float* qy, float* d,
                                                float* di) {
  for (int r = 0; r < count; ++r) {
    const float4 a = sh[r * 4 + 0];  // p0..p3: x0, y0, z0, r0
    const float4 b = sh[r * 4 + 1];  // p4..p7: sdx, sdy, sdz, sdr
    const float4 c = sh[r * 4 + 2];  // p8..p11: il2 (triangles: c2, w0..w2)
    const float4 e = sh[r * 4 + 3];  // id, kind, bucket_low, 0
    // A broadcast row: the kind branch does not diverge.
    if (kAnyKind && e.y == 2.0f) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float iz;
        if (tri_cover(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z,
                      c.w, qx[kSharedCol ? 0 : k], qy[k], &iz))
          merge_pair(true, 1.0f / iz, e.x, &d[k], &di[k]);
      }
      continue;
    }
    const float dx0 = qx[0] - a.x;
    const float dxs0 = dx0 * b.x;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float dx = kSharedCol ? dx0 : qx[k] - a.x;
      const float dxs = kSharedCol ? dxs0 : dx * b.x;
      float z;
      const bool cov = capsule_pair_col(dx, dxs, qy[k] - a.y, a.z, a.w, b.x,
                                        b.y, b.z, b.w, c.x, &z);
      merge_pair(cov, z, e.x, &d[k], &di[k]);
    }
  }
}

// Persistent CTAs take work items from the plan; an item is the slice
// [lo, hi) of its unit's flat rows (the live big rows, then the strip's
// range), staged 256 rows at a time through two shared-memory slots, the
// next chunk in flight while one is evaluated.  The saturation exit after
// each binned chunk (allow_exit): every in-image pixel of the unit is
// covered and the chunk's last bucket_low is strictly above its deepest
// pixel, i.e. every in-image depth is below that bound.  The depths
// tested are the item's own, and for a split unit the minima its items
// fold into `front` by atomicMin after each chunk (never below the
// unit's final depths, so the rule stays sound).  An item that exits
// skips the rest of its slice; an item whose first row's bucket_low
// already lies past the shared depths skips all of it.  With the exit the
// plan hands the items out in waves (every unit's first item, then every
// unit's second, ...), so that a split unit's deep items start after its
// front ones have filled `front`: started at once, they walked 45% of
// the rows at traj_ball frame 120 against 31% for one CTA per strip.  A
// unit of one item writes the image, the
// items of a split unit their minima to `partial` (csr2_merge_kernel).
// walked (null or (T)) sums the binned rows evaluated per strip.
template <bool kAnyKind, bool kSharedCol>
__global__ void __launch_bounds__(kThreads, 2)
csr2_walk_kernel(const float* __restrict__ rows,
                 const int* __restrict__ starts,
                 const float* __restrict__ big_rows,
                 const int* __restrict__ big_n_ptr, int big_cap,
                 int* __restrict__ plan,
                 float* __restrict__ partial, float* __restrict__ depth_out,
                 int* __restrict__ index_out, int* __restrict__ walked,
                 int* __restrict__ front, int width, int height, int tiles_x,
                 int num_units, int passes, int tile_h, int tile_w,
                 int max_items, int allow_exit) {
  extern __shared__ __align__(16) float ring[];  // 2 x kWalkSlotF floats
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int* items_cum = plan;
  const int* item_unit = plan + num_units;
  int* sched = plan + num_units + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float inf = __int_as_float(0x7f800000);
  __shared__ __align__(8) unsigned long long full[2];  // a slot landed
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  unsigned parity = 0;  // bit s: the phase of full[s] waited for next

  for (;;) {
    const int ticket = next_item(sched, &s_item);  // also publishes `full`
    if (ticket >= n_items) break;
    // With the exit the plan hands the items out in waves (ticket_item).
    const int item = allow_exit ? sched[3 + ticket] : ticket;
    const int unit = item_unit[item];
    const int first = unit > 0 ? items_cum[unit - 1] : 0;
    const int n = items_cum[unit] - first;
    const int strip = unit / passes;
    const int pb = (unit - strip * passes) * kBlockPix;
    const int ty = strip / tiles_x;
    const int tx = strip - ty * tiles_x;
    const int s0 = starts[strip];
    int lo, hi;
    item_slice(static_cast<long long>(big_n) + starts[strip + 1] - s0, item,
               first, n, &lo, &hi);
    float qx[kPix], qy[kPix], d[kPix], di[kPix], bound_d[kPix];
    int out[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = pb + tid + k * kThreads;
      out[k] = strip_pixel(p, tx, ty, tile_h, tile_w, width, height);
      qx[k] = static_cast<float>(tx * tile_w + p % tile_w) + 0.5f;
      qy[k] = static_cast<float>(ty * tile_h + p / tile_w) + 0.5f;
      d[k] = inf;
      di[k] = kEmptyId;
      // The depths the exit tests besides this item's: the unit's shared
      // ones when it is split (+inf until then); -inf off the image.
      bound_d[k] = out[k] >= 0 ? inf : -inf;
    }
    int* unit_front = allow_exit && n > 1
                          ? front + static_cast<long long>(unit) * kBlockPix
                          : nullptr;
    if (unit_front != nullptr) {
      // The depths the unit's other items have shared so far; an item
      // whose first row's bucket_low already lies past them at every
      // in-image pixel skips its slice (its rows' depths are at least
      // that bound: none can win).
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (out[k] >= 0)
          bound_d[k] = key_depth(__ldcg(&unit_front[tid + kThreads * k]));
      if (lo >= big_n && lo < hi) {
        const float first_low =
            __ldg(&rows[static_cast<long long>(s0 + lo - big_n) * 16 + 14]);
        if (exit_past(d, bound_d, first_low)) hi = lo;
      }
    }

    int issue = lo;     // the next flat row to stage
    bool stop = false;  // the exit was taken: stage and evaluate no more
    int done = 0;       // binned rows evaluated
    auto next_chunk = [&](int* start, int* cnt) {
      *start = issue;
      const int end = stop ? issue : issue < big_n ? min(big_n, hi) : hi;
      *cnt = min(kWalkChunk, max(end - issue, 0));
      issue += *cnt;
    };
    auto stage = [&](int slot, int start, int cnt) {
      float* dst = ring + slot * kWalkSlotF;
      const float* src =
          start < big_n ? big_rows + static_cast<long long>(start) * 16
                        : rows + static_cast<long long>(s0 + start - big_n) *
                                     16;
      if (tid == 0 && cnt > 0) bulk_load(dst, src, cnt * 64, &full[slot]);
    };

    int slot = 0, n_start, n_cnt;
    next_chunk(&n_start, &n_cnt);
    stage(0, n_start, n_cnt);
    for (;;) {
      const int c_start = n_start, c_cnt = n_cnt;
      if (c_cnt == 0) break;  // the same in every thread
      mbar_wait(&full[slot], (parity >> slot) & 1u);
      parity ^= 1u << slot;
      __syncthreads();  // chunk staged and visible; the other slot is free
      next_chunk(&n_start, &n_cnt);
      stage(slot ^ 1, n_start, n_cnt);
      const float* sh = ring + slot * kWalkSlotF;
      slot ^= 1;
      if (stop) continue;  // a chunk staged before the exit
      const float4* sh4 = reinterpret_cast<const float4*>(sh);
      if (c_start < big_n) {
        eval_strip_rows<true, kSharedCol>(sh4, c_cnt, qx, qy, d, di);
        continue;
      }
      eval_strip_rows<kAnyKind, kSharedCol>(sh4, c_cnt, qx, qy, d, di);
      done += c_cnt;
      if (!allow_exit) continue;
      bool in_image[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) in_image[k] = out[k] >= 0;
      // The chunk's last bucket_low bounds every later row of the strip.
      stop = exit_step(unit_front, tid, kThreads, in_image, d, bound_d, true,
                       sh[(c_cnt - 1) * 16 + 14]);
    }

    if (n == 1) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (out[k] >= 0) {
          depth_out[out[k]] = d[k];
          index_out[out[k]] = isinf(d[k]) ? -1 : static_cast<int>(di[k]);
        }
      }
    } else {
      write_partial(partial, item, d, di);
    }
    if (walked != nullptr && tid == 0 && done > 0)
      atomicAdd(&walked[strip], done);
  }
}

// The (depth, id) minima of a split unit's items, merged with the walk's
// compare and written to the image; units of one item were written by the
// walk.
__global__ void __launch_bounds__(kThreads)
csr2_merge_kernel(const int* __restrict__ plan,
                  const float* __restrict__ partial,
                  float* __restrict__ depth_out, int* __restrict__ index_out,
                  int width, int height, int tiles_x, int passes, int tile_h,
                  int tile_w) {
  const int unit = blockIdx.x;
  const int first = unit > 0 ? plan[unit - 1] : 0;
  const int n = plan[unit] - first;
  if (n <= 1) return;
  const int strip = unit / passes;
  const int pb = (unit - strip * passes) * kBlockPix;
  const int ty = strip / tiles_x;
  const int tx = strip - ty * tiles_x;
  float d[kPix], di[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    d[k] = __int_as_float(0x7f800000);
    di[k] = kEmptyId;
  }
  fold_partials(partial, first, n, d, di);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int o = strip_pixel(pb + threadIdx.x + k * kThreads, tx, ty, tile_h,
                              tile_w, width, height);
    if (o >= 0) {
      depth_out[o] = d[k];
      index_out[o] = isinf(d[k]) ? -1 : static_cast<int>(di[k]);
    }
  }
}

template <bool kAnyKind, bool kSharedCol>
void launch_walk2(const float* rows, const int* starts, const float* big_rows,
                  const int* big_n, int big_cap, int* plan, float* partial,
                  float* depth,
                  int* index, int* walked, int* front, int width, int height,
                  int tiles_x, int num_units, int passes, int tile_h,
                  int tile_w, int max_items, int allow_exit, cudaStream_t st) {
  static const int ctas = persistent_ctas(
      csr2_walk_kernel<kAnyKind, kSharedCol>, kWalkRingBytes);
  csr2_walk_kernel<kAnyKind, kSharedCol>
      <<<min(ctas, max_items), kThreads, kWalkRingBytes, st>>>(
          rows, starts, big_rows, big_n, big_cap, plan, partial, depth, index,
          walked, front, width, height, tiles_x, num_units, passes, tile_h,
          tile_w, max_items, allow_exit);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the first failed launch
// (0 = success).  rows (>= starts[T], 16 or 8) f32 in sorted order;
// starts (T+1) i32 the tiles' row ranges (T = tiles_x * tiles_y,
// row-major); big_rows (>= *big_n, 16) f32; big_n one i32 on the device;
// depth (H, W) f32; index (H, W) i32; walked null or (T) i32, each tile's
// count of rows evaluated before its exit (summed over its passes, and
// for csr2_raster over its work items); no_triangles != 0 evaluates the
// binned 16-float rows through the capsule body alone; allow_exit == 0
// walks every row.

// The split walk of v2 over its generic 16-float rows (plan, walk,
// merge).  rows and big_rows (big_cap, 16) 16-byte aligned, the first
// min(*big_n, big_cap) big rows live; front, with allow_exit, (U, 1024)
// i32 scratch (the plan resets it), U = T * passes of 1024 pixels; plan
// (U + 3 max_items + 3) i32 and partial (max_items, 2, 1024) f32
// scratch; a unit of more than split_rows rows is cut into items
// (max_items >= U in all).
extern "C" int csr2_raster(const float* rows, const int* starts,
                           const float* big_rows, const int* big_n,
                           int* front, int* walked, float* depth, int* index,
                           int* plan, float* partial, int big_cap, int width,
                           int height, int tiles_x, int tiles_y, int tile_h,
                           int tile_w, int no_triangles, int allow_exit,
                           int split_rows, int max_items, void* stream) {
  if (tile_h < 1 || tile_w < 1 || split_rows < 1 || (allow_exit && !front))
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles <= 0) return 0;
  const int passes = (tile_h * tile_w + kBlockPix - 1) / kBlockPix;
  const int num_units = num_tiles * passes;
  if (max_items < num_units) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_plan_kernel<StripRows><<<1, kPlanThreads, 0, st>>>(
      StripRows{starts, passes}, big_n, big_cap, num_units, split_rows,
      max_items, plan, walked, num_tiles, allow_exit ? front : nullptr,
      allow_exit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // A thread's 4 pixels (tid + 256 k) share a column when the strip width
  // divides 256.
  const bool shared_col = kThreads % tile_w == 0;
  void (*walk)(const float*, const int*, const float*, const int*, int,
               int*, float*, float*, int*, int*, int*, int, int, int, int,
               int, int, int, int, int, cudaStream_t) =
      launch_walk2<true, false>;
  if (no_triangles && shared_col)
    walk = launch_walk2<false, true>;
  else if (no_triangles)
    walk = launch_walk2<false, false>;
  else if (shared_col)
    walk = launch_walk2<true, true>;
  walk(rows, starts, big_rows, big_n, big_cap, plan, partial, depth, index,
       walked, front, width, height, tiles_x, num_units, passes, tile_h,
       tile_w, max_items, allow_exit, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr2_merge_kernel<<<num_units, kThreads, 0, st>>>(
      plan, partial, depth, index, width, height, tiles_x, passes, tile_h,
      tile_w);
  return static_cast<int>(cudaGetLastError());
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
