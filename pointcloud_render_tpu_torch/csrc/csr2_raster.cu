// v1 and v2 strip-tile rasterizers for Hopper (sm_90a) over tile_h x
// tile_w pixel tiles (8 x 128 by default).  Three entry points, one split
// walk:
//   * csr2_raster replaces pallas_csr2._make_kernel (v2) over its generic
//     16-float rows [params 0..11, id, kind, bucket_low, 0];
//   * csr1_raster replaces pallas_csr._make_kernel (v1).  v1 and v2 are
//     one function over one row layout and one binning: v1 differs only
//     in its default max_tiles_per_prim (8 against 4, a binning choice
//     made in raster/csr.py) and in the TPU's 128-row DMA chunk, which
//     the port does not keep.  So csr1_raster runs csr2_raster's walk and
//     keeps its own symbol for the kernel it replaces;
//   * csr2_disc8 replaces pallas_csr2._make_kernel over its discs_only
//     8-float rows [px, py, z, r*r, id, bucket_low, 0, 0] (the same walk,
//     its disc rows culled per warp).
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
// shared memory (rows are in sorted order: a contiguous copy, no gather).
// Binned generic rows take the kind branch too, or the capsule body alone
// under no_triangles (triangles then ride the big list, as on the TPU);
// disc rows are covered where dx * dx + dy * dy <= r * r.  After each
// chunk the saturation exit of pallas_csr.py:182-192: once every pixel of
// the tile is covered and the chunk's last row's bucket_low is strictly
// greater than the deepest pixel, no later row can win a pixel (later
// rows sit in the same or later buckets, whose depths are at least that
// bound; strict: an equal depth with a lower id could still win), so the
// tile stops.  The exit never changes a winner, so the port may take it
// at its own granularity.  A tile of more than 1024 pixels is walked in
// passes of 1024 pixels, each with its own exit.  `walked` reports the
// rows each tile evaluated before its exits (summed over its passes and
// work items).
//
// The split walk (split_walk.cuh: plan, persistent walk, merge).  One
// CTA per tile left a dense strip's whole range on one SM (traj_ball's
// cloud projects to the frame's centre).  A unit is one pass of 1024 pixels of a strip; split_plan_kernel cuts a
// unit of more than split_rows rows (its big rows, then its range) into
// work items; csr2_walk_kernel's persistent CTAs take them from a
// counter, and csr2_merge_kernel folds a split unit's per-item minima.  A
// strip's rows are one contiguous run of 64 B (or 32 B disc) rows,
// 16-byte aligned, so a chunk of 256 rows (512 disc rows: the same 16 KB)
// is one bulk copy (cp.async.bulk, the TMA unit's one-dimensional form)
// issued by one thread into a two-slot ring and completed on an mbarrier,
// the next chunk in flight while one is evaluated.  The exit across a
// split unit's items: each folds its minima into the unit's `front`
// depths (reset by the plan) by atomicMin after every chunk and tests the
// rule against them (never below the unit's final depths, so the rule
// stays sound: every in-image depth below the bound), one barrier per
// chunk; alone, an item holding a slice of a strip would see the pixels
// other items cover as empty and never leave.  The plan hands the items
// out in waves, front to back (see csr2_walk_kernel).  Where the strip
// width divides 256, a thread's 4 pixels share a column, so dx and dx *
// sdx are evaluated once per row (the expression order of capsule_pair
// unchanged); a triangle's 1 / iz only at covered pairs, where it is
// tri_pair's depth.  csr2_disc8's cull: a disc is a few pixels wide and a
// strip's rows are all its discs, so of the 1024 x rows pairs of a unit
// almost none can be covered.  Each warp holds a block of 32 columns x 4
// rows (at strip widths 32-256; elsewhere the 16-float layout) and
// evaluates only the rows whose disc can reach the box of its pixel
// centres (eval_disc_rows: one exact test per row and warp).
//
// Winner per pixel = lexicographic min of (depth, primitive id) with
// strict compares, so the walk order does not matter; index -1 where the
// depth is infinite.  The per-pair bodies are raster_pairs.cuh's, shared
// with csr6_raster.cu.  Exactness needs IEEE float32 per operation: build
// with -fmad=false and without --use_fast_math.
//
// What bounds it on an H100: per-pair arithmetic, as in csr6_raster.cu
// (17 float32 operations per capsule pair, 18 per triangle pair, 4 per
// disc pair), over 1024 pixels x the rows each tile walked before its
// exit, plus every pixel x every live big row.  csr2_disc8's floor is the pairs the
// function needs: 32 pixels per (binned row, pixel row, 32-column
// segment) that the exact test can cover (csr.segment_rows with segments
// of one pixel row), plus every pixel x every live big row, or the bytes.

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // capsule_pair_col, tri_cover, merge_pair
#include "split_walk.cuh"    // plan, item counter, staging, merge

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPix = 1024;             // pixels per pass of a CTA
constexpr int kPix = kBlockPix / kThreads;  // pixels per thread per pass
constexpr float kEmptyId = 16777216.0f;     // 2^24 > every prim id

// ---------------------------------------------------------------------------
// The split walk of all three entry points (see the header).  A unit
// is one pass of 1024 pixels of a strip: unit u = strip * passes + pass.

constexpr int kWalkSlotF = 256 * 16;  // floats per ring slot (16 KB)
constexpr int kWalkRingBytes = 2 * kWalkSlotF * 4;
constexpr int kBigChunk = kWalkSlotF / 16;  // 64 B big rows per slot

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

// Where this thread's pixels lie in a unit: pixel k is p0 + dp * k.  The
// 16-float walk takes tid + 256 k.  The disc walk, where the strip width
// is 32, 64, 128 or 256, gives each warp a block of 32 columns x 4
// consecutive rows (rows 4 (w / S) + k of the unit, columns 32 (w % S) +
// lane, S = tile_w / 32), so that its cull skips rows on both axes; at
// other widths tid + 256 k.
template <int kRowF>
__device__ __forceinline__ void unit_layout(int tile_w, int* p0, int* dp) {
  if (kRowF == 8 &&
      (tile_w == 32 || tile_w == 64 || tile_w == 128 || tile_w == 256)) {
    const int s = tile_w / 32, w = threadIdx.x >> 5;
    *p0 = (w / s) * 4 * tile_w + (w % s) * 32 + (threadIdx.x & 31);
    *dp = tile_w;
  } else {
    *p0 = threadIdx.x;
    *dp = kThreads;
  }
}

// Staged 8-float disc rows [0, count) ([px, py, z, r*r, id, bucket_low,
// 0, 0], pallas_csr2._eval_disc_row) at this thread's pixels, each row
// only where the warp's cull keeps it: lane `lane` tests row base + lane
// against the box [xlo, xhi] x [ylo, yhi] of the pixel centres the warp
// holds in the strip and the image (warp-uniform; `live` false when it
// holds none), and the warp takes the ballot.  A row is skipped when
// fl(fl(dx * dx) + fl(dy * dy)) > r*r at the box's centre nearest to
// (px, py) (clamp(floor(p) + 0.5, box) per axis).  That is exact, as
// csr6_raster.cu's band_live: fl(q - p) is monotone in q and keeps its
// sign, so no centre of the box has a smaller |fl(dx)| or |fl(dy)|, the
// squares and their sum round monotonically, and the body tests that
// very sum (NaN: live, and no cover).  Under kSharedCol the thread's
// pixels share qx[0].  Returns the rows the warp evaluated.
template <bool kSharedCol>
__device__ __forceinline__ int eval_disc_rows(const float* sh, int count,
                                              const float* qx,
                                              const float* qy, bool live,
                                              float xlo, float xhi,
                                              float ylo, float yhi,
                                              float* d, float* di) {
  const float4* rows = reinterpret_cast<const float4*>(sh);
  int evaluated = 0;
  for (int base = 0; base < count; base += 32) {
    const int t = base + (threadIdx.x & 31);
    bool keep = false;
    if (live && t < count) {
      const float4 a = rows[t * 2];
      const float dx = fminf(fmaxf(floorf(a.x) + 0.5f, xlo), xhi) - a.x;
      const float dy = fminf(fmaxf(floorf(a.y) + 0.5f, ylo), yhi) - a.y;
      keep = !(dx * dx + dy * dy > a.w);
    }
    unsigned m = __ballot_sync(0xffffffffu, keep);
    evaluated += __popc(m);
    while (m) {
      const int r = base + __ffs(m) - 1;
      m &= m - 1;
      const float4 a = rows[r * 2];  // px, py, z, r*r
      const float idf = rows[r * 2 + 1].x;
      const float dx0 = qx[0] - a.x;
      const float dx20 = dx0 * dx0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float dx = qx[kSharedCol ? 0 : k] - a.x;
        const float dx2 = kSharedCol ? dx20 : dx * dx;
        const float dy = qy[k] - a.y;
        merge_pair(dx2 + dy * dy <= a.w, a.z, idf, &d[k], &di[k]);
      }
    }
  }
  return evaluated;
}

// Persistent CTAs take work items from the plan; an item is the slice
// [lo, hi) of its unit's flat rows (the live big rows, then the strip's
// range), staged by bulk copies through two 16 KB shared-memory slots
// (256 big or 16-float rows, 512 8-float disc rows), the next chunk in
// flight while one is evaluated.  kRowF 8 (csr2_disc8) evaluates its disc
// rows through eval_disc_rows' cull and counts the (row, warp) pairs it
// evaluated in `bands` (null or (T), zeroed; summed over a strip's
// passes and items).  The saturation exit after each binned chunk
// (allow_exit): every in-image pixel of the unit is covered and the
// chunk's last bucket_low (lane 14 of a 16-float row, 5 of a disc row) is
// strictly above its deepest pixel, i.e. every in-image depth is below
// that bound.  The depths tested are the item's own, and for a split unit
// the minima its items fold into `front` by atomicMin after each chunk
// (never below the unit's final depths, so the rule stays sound).  An
// item that exits skips the rest of its slice; an item whose first row's
// bucket_low already lies past the shared depths skips all of it.  With
// the exit the plan hands the 16-float walk's items out in waves (every
// unit's first item, then every unit's second, ...), so that a split
// unit's deep items start after its front ones have filled `front`:
// started at once, they walked 45% of the rows at traj_ball frame 120
// against 31% for one CTA per strip.  csr2_disc8's go out in plan
// order: on the disc lane, whose exit leaves few rows, the waves made it
// slower (PERF.md).  A unit of one item writes the image, the items of a
// split unit their minima to `partial` (csr2_merge_kernel).  walked (null
// or (T)) sums the binned rows evaluated per strip.
template <int kRowF, bool kAnyKind, bool kSharedCol>
__global__ void __launch_bounds__(kThreads, kRowF == 8 ? 4 : 2)
csr2_walk_kernel(const float* __restrict__ rows,
                 const int* __restrict__ starts,
                 const float* __restrict__ big_rows,
                 const int* __restrict__ big_n_ptr, int big_cap,
                 int* __restrict__ plan,
                 float* __restrict__ partial, float* __restrict__ depth_out,
                 int* __restrict__ index_out, int* __restrict__ walked,
                 int* __restrict__ bands, int* __restrict__ front, int width,
                 int height, int tiles_x, int num_units, int passes,
                 int tile_h, int tile_w, int max_items, int allow_exit) {
  constexpr int kChunkRows = kWalkSlotF / kRowF;  // binned rows per slot
  constexpr int kBoundLane = kRowF == 16 ? 14 : 5;  // bucket_low
  extern __shared__ __align__(16) float ring[];  // 2 x kWalkSlotF floats
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int* items_cum = plan;
  const int* item_unit = plan + num_units;
  int* sched = plan + num_units + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float inf = __int_as_float(0x7f800000);
  int p0, dp;  // this thread's pixel k of a unit: p0 + dp * k
  unit_layout<kRowF>(tile_w, &p0, &dp);
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
    // With the exit the plan hands the 16-float walk's items out in waves
    // (ticket_item).
    const int item = kRowF == 16 && allow_exit ? sched[3 + ticket] : ticket;
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
    // The disc walk's cull box: the warp's pixel centres in the image.
    float xlo = inf, xhi = -inf, ylo = inf, yhi = -inf;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = pb + p0 + dp * k;
      out[k] = strip_pixel(p, tx, ty, tile_h, tile_w, width, height);
      qx[k] = static_cast<float>(tx * tile_w + p % tile_w) + 0.5f;
      qy[k] = static_cast<float>(ty * tile_h + p / tile_w) + 0.5f;
      d[k] = inf;
      di[k] = kEmptyId;
      // The depths the exit tests besides this item's: the unit's shared
      // ones when it is split (+inf until then); -inf off the image.
      bound_d[k] = out[k] >= 0 ? inf : -inf;
      if (kRowF == 8 && out[k] >= 0) {
        xlo = fminf(xlo, qx[k]);
        xhi = fmaxf(xhi, qx[k]);
        ylo = fminf(ylo, qy[k]);
        yhi = fmaxf(yhi, qy[k]);
      }
    }
    if (kRowF == 8) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
        xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
        ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
        yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
      }
    }
    const bool warp_live = xlo <= xhi;  // the warp holds an image pixel
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
          bound_d[k] = key_depth(__ldcg(&unit_front[p0 + dp * k]));
      if (lo >= big_n && lo < hi) {
        const float first_low = __ldg(
            &rows[static_cast<long long>(s0 + lo - big_n) * kRowF +
                  kBoundLane]);
        if (exit_past(d, bound_d, first_low)) hi = lo;
      }
    }

    int issue = lo;     // the next flat row to stage
    bool stop = false;  // the exit was taken: stage and evaluate no more
    int done = 0;       // binned rows evaluated
    int evaluated = 0;  // (binned row, warp) pairs of this warp (discs)
    auto next_chunk = [&](int* start, int* cnt) {
      *start = issue;
      const bool big = issue < big_n;
      const int end = stop ? issue : big ? min(big_n, hi) : hi;
      *cnt = min(big ? kBigChunk : kChunkRows, max(end - issue, 0));
      issue += *cnt;
    };
    auto stage = [&](int slot, int start, int cnt) {
      if (tid != 0 || cnt == 0) return;
      float* dst = ring + slot * kWalkSlotF;
      if (start < big_n)
        bulk_load(dst, big_rows + static_cast<long long>(start) * 16,
                  cnt * 64, &full[slot]);
      else
        bulk_load(dst,
                  rows + static_cast<long long>(s0 + start - big_n) * kRowF,
                  cnt * kRowF * 4, &full[slot]);
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
      if constexpr (kRowF == 16)
        eval_strip_rows<kAnyKind, kSharedCol>(sh4, c_cnt, qx, qy, d, di);
      else
        evaluated += eval_disc_rows<kSharedCol>(sh, c_cnt, qx, qy, warp_live,
                                                xlo, xhi, ylo, yhi, d, di);
      done += c_cnt;
      if (!allow_exit) continue;
      bool in_image[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) in_image[k] = out[k] >= 0;
      // The chunk's last bucket_low bounds every later row of the strip.
      stop = exit_step(unit_front, p0, dp, in_image, d, bound_d, true,
                       sh[(c_cnt - 1) * kRowF + kBoundLane]);
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
      write_partial(partial, item, d, di, nullptr, nullptr, p0, dp);
    }
    if (walked != nullptr && tid == 0 && done > 0)
      atomicAdd(&walked[strip], done);
    if (kRowF == 8 && bands != nullptr && (tid & 31) == 0 && evaluated > 0)
      atomicAdd(&bands[strip], evaluated);
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

template <int kRowF, bool kAnyKind, bool kSharedCol>
void launch_walk2(const float* rows, const int* starts, const float* big_rows,
                  const int* big_n, int big_cap, int* plan, float* partial,
                  float* depth, int* index, int* walked, int* bands,
                  int* front, int width, int height, int tiles_x,
                  int num_units, int passes, int tile_h, int tile_w,
                  int max_items, int allow_exit, cudaStream_t st) {
  static const int ctas = persistent_ctas(
      csr2_walk_kernel<kRowF, kAnyKind, kSharedCol>, kWalkRingBytes);
  csr2_walk_kernel<kRowF, kAnyKind, kSharedCol>
      <<<min(ctas, max_items), kThreads, kWalkRingBytes, st>>>(
          rows, starts, big_rows, big_n, big_cap, plan, partial, depth, index,
          walked, bands, front, width, height, tiles_x, num_units, passes,
          tile_h, tile_w, max_items, allow_exit);
}

// Plan, walk and merge of a v2 split walk over kRowF-float rows on
// `stream`; returns the first launch error.
template <int kRowF>
int strip_walk(const float* rows, const int* starts, const float* big_rows,
               const int* big_n, int* front, int* walked, int* bands,
               float* depth, int* index, int* plan, float* partial,
               int big_cap, int width, int height, int tiles_x, int tiles_y,
               int tile_h, int tile_w, int no_triangles, int allow_exit,
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
      kRowF == 16 && allow_exit);  // the waves (see csr2_walk_kernel)
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // A thread's 4 pixels share a column when the strip width divides 256
  // (tid + 256 k; the disc walk's blocks of 4 rows are such widths).
  const bool shared_col = kThreads % tile_w == 0;
  using Walk = void (*)(const float*, const int*, const float*, const int*,
                        int, int*, float*, float*, int*, int*, int*, int*,
                        int, int, int, int, int, int, int, int, int,
                        cudaStream_t);
  // Disc rows (kRowF 8) have no kind lane: no triangle instances.
  Walk walk = shared_col ? launch_walk2<kRowF, false, true>
                         : launch_walk2<kRowF, false, false>;
  if constexpr (kRowF == 16) {
    if (!no_triangles)
      walk = shared_col ? launch_walk2<kRowF, true, true>
                        : launch_walk2<kRowF, true, false>;
  }
  walk(rows, starts, big_rows, big_n, big_cap, plan, partial, depth, index,
       walked, bands, front, width, height, tiles_x, num_units, passes,
       tile_h, tile_w, max_items, allow_exit, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr2_merge_kernel<<<num_units, kThreads, 0, st>>>(
      plan, partial, depth, index, width, height, tiles_x, passes, tile_h,
      tile_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the first failed launch
// (0 = success).  rows (>= starts[T], 16 or 8) f32 in sorted order;
// starts (T+1) i32 the tiles' row ranges (T = tiles_x * tiles_y,
// row-major); big_rows (>= *big_n, 16) f32; big_n one i32 on the device;
// depth (H, W) f32; index (H, W) i32; walked null or (T) i32, each tile's
// count of rows evaluated before its exit (summed over its passes and
// work items); no_triangles != 0 evaluates the binned 16-float rows
// through the capsule body alone; allow_exit == 0 walks every row.

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
  return strip_walk<16>(rows, starts, big_rows, big_n, front, walked,
                        nullptr, depth, index, plan, partial, big_cap, width,
                        height, tiles_x, tiles_y, tile_h, tile_w,
                        no_triangles, allow_exit, split_rows, max_items,
                        stream);
}

// The same split walk over v2's discs_only 8-float disc rows (16-byte
// aligned; no_triangles unused), culled per warp: bands null or (T) i32
// zeroed, the (binned row, warp) pairs each strip evaluated (summed over
// its passes); the rest as csr2_raster's.
extern "C" int csr2_disc8(const float* rows, const int* starts,
                          const float* big_rows, const int* big_n,
                          int* front, int* walked, int* bands, float* depth,
                          int* index, int* plan, float* partial, int big_cap,
                          int width, int height, int tiles_x, int tiles_y,
                          int tile_h, int tile_w, int no_triangles,
                          int allow_exit, int split_rows, int max_items,
                          void* stream) {
  return strip_walk<8>(rows, starts, big_rows, big_n, front, walked, bands,
                       depth, index, plan, partial, big_cap, width, height,
                       tiles_x, tiles_y, tile_h, tile_w, no_triangles,
                       allow_exit, split_rows, max_items, stream);
}

// v1 (pallas_csr._make_kernel): csr2_raster's walk over the same rows,
// with the same arguments.
extern "C" int csr1_raster(const float* rows, const int* starts,
                           const float* big_rows, const int* big_n,
                           int* front, int* walked, float* depth, int* index,
                           int* plan, float* partial, int big_cap, int width,
                           int height, int tiles_x, int tiles_y, int tile_h,
                           int tile_w, int no_triangles, int allow_exit,
                           int split_rows, int max_items, void* stream) {
  return strip_walk<16>(rows, starts, big_rows, big_n, front, walked,
                        nullptr, depth, index, plan, partial, big_cap, width,
                        height, tiles_x, tiles_y, tile_h, tile_w,
                        no_triangles, allow_exit, split_rows, max_items,
                        stream);
}

extern "C" const char* csr2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
