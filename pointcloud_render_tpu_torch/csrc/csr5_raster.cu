// v5 chunk-binned disc rasterizer for Hopper (sm_90a) over tiles of 1024
// pixels (tile_h x tile_w, tile_w in {16, 32, 64, 128}).  Two kernels
// share one template:
//   * csr5_raster  -> depth and index;
//   * csr5_shaded  -> depth, index and the shaded rgb: the walk carries
//     the winner's location, and the epilogue reads its px, py, rflag and
//     rgb there and evaluates the sphere-Lambert shade.
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
// chunk ids: at each pixel the k slots of a superrow are taken in id
// order with a strict < (dx*dx + dy*dy <= r*r, z < the row's depth): the
// lowest slot wins an equal depth.  The row winner (z, base id + slot,
// base id = slot 0's id lane) merges into the tile's winner with the full
// lexicographic compare (pallas_csr5.py:399-401), so the result does not
// depend on the order of the entries, nor on how the run is split.
//
// The exit (pallas_csr5.py:422-463): entries ascend in the bucket of
// their chunk's depth minimum, and a superrow's depth minimum over its
// slots is that minimum (inert slots hold +inf), so after every
// `check_every` superrows of the run every later prim lies at or past
// zmin + max(floor((zrow - zmin) * s) - 1, 0) * thr_scale, zrow the last
// superrow's depth minimum.  A warp leaves the run when that bound is
// strictly greater than the depth of every in-image pixel it holds, its
// own or the tile's shared `front` (strict: an equal depth with a lower id
// could still win, and under a split the front may hold a depth that a
// later item met): no later prim can win one of its pixels.  The TPU
// block decides it for all its pixels at once; each warp deciding for
// its own is as sound, and costs a vote of the warp instead of a barrier
// of the CTA every check_every superrows.  The exit never changes a
// winner; allow_exit = 0 walks every entry.
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
// What bounds it on an H100: a splat of radius 0.002 covers a few pixels,
// so of the 1024 x k pairs a superrow offers a tile almost none can be
// covered (8.8% of the (slot, pixel row) pairs at the disc lane's frame
// 120, fewer pixels still), and the floor is the pairs the function needs
// (4 float32 operations each: dy, dy * dy, + dx * dx, <= r * r) or the
// 512 B superrows' bytes, whichever is larger.  One CTA per tile walked
// every slot of every superrow at every pixel, staged synchronously, and
// left a dense tile's run on one SM.  Design (csr5_walk_kernel): the split
// walk of split_walk.cuh (a plan cuts a tile of more than split_rows
// superrows into work items, persistent CTAs take them from a counter,
// csr5_merge_kernel folds a split tile's items and runs the epilogue);
// each superrow, found through chunks[], is one 16-byte aligned bulk copy
// into a two-slot ring, a slot's copies completing on its mbarrier, the
// next slot's superrows in flight while one is evaluated; each warp owns
// a block of 32 columns x 4 rows of the tile (16 columns x 8 rows where
// tile_w is 16: the same 128 pixels, each thread's 4 pixels one column)
// and evaluates only the live slots whose disc can reach the block's
// pixel centres (cull_keep: one exact test per slot and warp, a ballot
// over 32 / k superrows at a time).  What is left is issue-bound: every
// warp pays the test and the ballot for every superrow of the run, and
// the kept slots are a few percent of the pairs.

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // clip01, capsule_pair, tri_pair, merge_pair
#include "split_walk.cuh"    // plan, item counter, bulk copies, merge

namespace {

constexpr int kThreads = kWalkThreads;   // 256
constexpr int kPix = kUnitPixPerThread;  // pixels per thread
constexpr int kBigF = 17;                // big row: 12 params, id, rgb, rflag
constexpr int kBigChunk = 64;            // big rows per synchronous stage
constexpr int kRowF = 8;                 // floats per slot
constexpr int kRing = 2;                 // ring slots: one in flight
constexpr int kSlotF = 4096;             // floats per ring slot (16 KB)
constexpr int kRingBytes = kRing * kSlotF * 4;
constexpr int kMaxRows = kSlotF / kRowF;  // superrows per slot at k = 1
constexpr float kEmpty = 16777216.0f;     // 2^24 > every prim id
constexpr int kNoWinner = -1;  // location of an empty pixel; a big winner
                               // is -(rank + 2), a binned one its slot of
                               // the table, row * k + slot

// jnp.minimum: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// Pixel k of this thread in a tile is p0 + tile_w * k (one column, kPix
// consecutive rows): warp w owns a block of 32 columns x 4 rows (S =
// tile_w / 32 blocks per block row; w / S its block row), or of 16
// columns x 8 rows where tile_w is 16 (lanes 16..31 its lower 4 rows).
__device__ __forceinline__ int block_p0(int tile_w) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (tile_w == 16) return (8 * w + 4 * (lane >> 4)) * 16 + (lane & 15);
  const int s = tile_w / 32;
  return (w / s) * 4 * tile_w + (w % s) * 32 + lane;
}

// The warp cull's test of one staged slot a = [px, py, z, r] against the
// box [xlo, xhi] x [ylo, yhi] of the pixel centres the warp holds in the
// image: skipped when its depth is not below +inf (it can win no pixel)
// or when fl(fl(dx * dx) + fl(dy * dy)) > fl(r * r) at the box's centre
// nearest to (px, py) (clamp(floor(p) + 0.5, box) per axis).  That is
// exact, as csr2_raster.cu's eval_disc_rows: fl(q - p) is monotone in q
// and keeps its sign, so no centre of the box has a smaller |fl(dx)| or
// |fl(dy)|, the squares and their sum round monotonically, and the body
// tests that very sum (NaN: kept, and no cover).  A skipped slot covers
// none of the warp's pixels, so it cannot change the row winner or its
// equal-depth tie.
__device__ __forceinline__ bool cull_keep(const float4& a, float xlo,
                                          float xhi, float ylo, float yhi) {
  const float dx = fminf(fmaxf(floorf(a.x) + 0.5f, xlo), xhi) - a.x;
  const float dy = fminf(fmaxf(floorf(a.y) + 0.5f, ylo), yhi) - a.y;
  return a.z < __int_as_float(0x7f800000) &&
         !(dx * dx + dy * dy > a.w * a.w);
}

// Slot s of a staged superrow at this thread's pixels (column qx, rows
// qy[]): covered where dx*dx + dy*dy <= r*r, taken into the row winner
// (rz, rs) with the strict < (the slots come in id order: the lowest
// wins an equal depth).
__device__ __forceinline__ void eval_slot(const float* row, int s, float qx,
                                          const float* qy, float* rz,
                                          int* rs) {
  const float4 a = reinterpret_cast<const float4*>(row)[s * 2];
  const float dx = qx - a.x;
  const float dx2 = dx * dx;
  const float r2 = a.w * a.w;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float dy = qy[j] - a.y;
    if ((dx2 + dy * dy <= r2) && a.z < rz[j]) {
      rz[j] = a.z;
      rs[j] = s;
    }
  }
}

// The row winner (rz, rs; rs == k where no slot covered the pixel, z,
// base id + slot) merged into the pixel's with the full (depth, id)
// compare; under kFused the winner's location, table row `row_id` times
// k plus its slot.
template <bool kFused>
__device__ __forceinline__ void merge_row(const float* row, int k,
                                          int row_id, const float* rz,
                                          const int* rs, float* d, float* di,
                                          int* loc) {
  const float base_idf = row[4];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (rs[j] == k) continue;
    const float idf = base_idf + static_cast<float>(rs[j]);
    if ((rz[j] < d[j]) || ((rz[j] == d[j]) && (idf < di[j]))) {
      d[j] = rz[j];
      di[j] = idf;
      if (kFused) loc[j] = row_id * k + rs[j];
    }
  }
}

// A superrow's depth minimum over its k slots, in slot order (NaN
// propagates).
__device__ __forceinline__ float row_zmin(const float* row, int k) {
  float z = row[2];
  for (int u = 1; u < k; ++u) z = min_nan(z, row[u * kRowF + 2]);
  return z;
}

// Write one pixel's winner at image offset o (pixel centre (qx, qy));
// under kFused its shaded rgb too, the winner's px, py, rflag and rgb read
// at its location (a binned winner's rgb from meta under `uniform`).
template <bool kFused>
__device__ __forceinline__ void write_pixel5(
    long long o, float d, float di, int loc, float qx, float qy,
    const float* __restrict__ tab, const float* __restrict__ big_params,
    int big_cap, const float* __restrict__ meta, int uniform,
    float* __restrict__ depth_out, int* __restrict__ index_out,
    float* __restrict__ rgb_out) {
  depth_out[o] = d;
  if constexpr (!kFused) {
    index_out[o] = isinf(d) ? -1 : static_cast<int>(di);
  } else {
    index_out[o] = isfinite(d) ? static_cast<int>(di) : -1;
    float apx = 0.0f, apy = 0.0f, arf = -1.0f, cc[3] = {0.0f, 0.0f, 0.0f};
    if (loc >= 0) {
      const float* w = tab + static_cast<long long>(loc) * kRowF;
      apx = w[0];
      apy = w[1];
      arf = w[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) cc[c] = uniform ? meta[11 + c] : w[5 + c];
    } else if (loc != kNoWinner) {
      const float* b = big_params + (-loc - 2);
      apx = b[0];
      apy = b[big_cap];
      arf = b[16 * static_cast<long long>(big_cap)];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        cc[c] = b[(13 + c) * static_cast<long long>(big_cap)];
    }
    const float inv_r = __fdiv_rn(1.0f, arf < 1e-6f ? 1e-6f : arf);
    const float u = (qx - apx) * inv_r;
    const float v = -(qy - apy) * inv_r;
    float w2 = 1.0f - u * u - v * v;
    w2 = w2 < 0.0f ? 0.0f : w2;  // jnp.maximum: NaN stays NaN
    const float nz = -__fsqrt_rn(w2);
    const float ndotl = u * meta[3] + v * meta[4] + nz * meta[5];
    const float lit = meta[6] + meta[7] * (ndotl < 0.0f ? 0.0f : ndotl);
    const bool is_disc = arf > 0.0f;
    const bool hit = d < __int_as_float(0x7f800000);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float val = hit ? (is_disc ? cc[c] * lit : cc[c]) : meta[8 + c];
      rgb_out[o * 3 + c] = clip01(val);
    }
  }
}

// The split walk (see the header).  A unit is one tile; its flat rows
// are its live big rows, then its run of chunk ids [starts[t],
// starts[t+1]) (StripRows with one pass).  Persistent CTAs take work
// items from the plan in plan order; an item is the slice [lo, hi) of its
// tile's flat rows.  Its big rows are staged synchronously, kBigChunk at
// a time, and evaluated at every pixel (the list is short and holds the
// ground, which no cull could skip); its superrows go through the ring:
// warp 0 arms the slot's mbarrier for the chunk's bytes and its lanes
// issue one bulk copy per superrow (the chunk ids read there, kept in
// sh_ids for the winner's location).  The exit (allow_exit): each warp,
// after every check_every superrows of the run and at the item's end
// (its depths folded for the tile's later items), takes exit_step's warp
// form with the last superrow's bucket floor and leaves the run when it
// passes; the CTA stops staging once every warp has left.  A tile of one
// item writes the image (with the epilogue under kFused); the items of a
// split tile write (depth, id) and under kFused the winner's location to
// `partial` (csr5_merge_kernel).  walked (null or (T), zeroed by the
// plan) sums, over a tile's items, the superrows the item's furthest
// warp passed; bands (null or (T), zeroed by the caller) the (live slot,
// warp block) pairs the cull kept.  Registers are held to 64 (4 CTAs per
// SM), as in the culled disc walks of csr6_raster.cu.
template <bool kFused>
__global__ void __launch_bounds__(kThreads, 4)
csr5_walk_kernel(const float* __restrict__ tab, const int* __restrict__ chunks,
                 const int* __restrict__ starts,
                 const float* __restrict__ big_params,
                 const int* __restrict__ big_kinds,
                 const int* __restrict__ big_n_ptr,
                 const float* __restrict__ meta, int* __restrict__ plan,
                 float* __restrict__ partial, float* __restrict__ depth_out,
                 int* __restrict__ index_out, float* __restrict__ rgb_out,
                 int* __restrict__ walked, int* __restrict__ bands,
                 int* __restrict__ front, int big_cap, int width, int height,
                 int tiles_x, int num_tiles, int tile_h, int tile_w, int k,
                 int check_every, int allow_exit, int uniform,
                 int max_items) {
  extern __shared__ __align__(128) float ring[];  // kRing x kSlotF floats
  __shared__ float sh_big[kBigF * kBigChunk];
  __shared__ int sh_kind[kBigChunk];
  __shared__ int sh_ids[kFused ? kRing * kMaxRows : 1];
  __shared__ int s_item;
  __shared__ int s_done;  // the superrows the item passed
  __shared__ __align__(8) unsigned long long full[kRing];  // a slot landed
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* items_cum = plan;
  const int* item_tile = plan + num_tiles;
  int* sched = plan + num_tiles + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float zmin = meta[0], zs = meta[1], thr = meta[2];
  const float inf = __int_as_float(0x7f800000);
  const int row_f = k * kRowF;
  const int chunk_rows = kSlotF / row_f;  // superrows per ring slot
  const int p0 = block_p0(tile_w);
  const int col = p0 % tile_w, row0 = p0 / tile_w;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  unsigned parity = 0;  // bit s: the phase of full[s] waited for next

  for (;;) {
    const int item = next_item(sched, &s_item);  // also publishes `full`
    if (item >= n_items) break;
    if (tid == 0) s_done = 0;  // read after this item's last barrier
    const int tile = item_tile[item];
    const int first = tile > 0 ? items_cum[tile - 1] : 0;
    const int n = items_cum[tile] - first;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int s0 = starts[tile];
    int lo, hi;
    item_slice(static_cast<long long>(big_n) + starts[tile + 1] - s0, item,
               first, n, &lo, &hi);
    const int x = tx * tile_w + col;
    const int y0 = ty * tile_h + row0;
    const float qx = static_cast<float>(x) + 0.5f;
    float qy[kPix], d[kPix], di[kPix], bound_d[kPix];
    int loc[kPix];
    bool in_img[kPix];
    // The warp's cull box: its pixel centres inside the image.
    float xlo = inf, xhi = -inf, ylo = inf, yhi = -inf;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      qy[j] = static_cast<float>(y0 + j) + 0.5f;
      in_img[j] = x < width && y0 + j < height;
      d[j] = inf;
      di[j] = kEmpty;
      loc[j] = kNoWinner;
      // The depths the exit tests besides this item's: the tile's shared
      // ones when it is split (+inf until then); -inf off the image.
      bound_d[j] = in_img[j] ? inf : -inf;
      if (in_img[j]) {
        xlo = fminf(xlo, qx);
        xhi = fmaxf(xhi, qx);
        ylo = fminf(ylo, qy[j]);
        yhi = fmaxf(yhi, qy[j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, o));
      xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, o));
      ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
      yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
    }
    const bool box_live = xlo <= xhi;  // the warp holds an image pixel
    int* tile_front = allow_exit && n > 1
                          ? front + static_cast<long long>(tile) * kUnitPix
                          : nullptr;

    // The item's big rows: capsules, triangles and wide discs, the full
    // compare, staged synchronously.
    const int big_hi = min(hi, big_n);
    for (int b0 = lo; b0 < big_hi; b0 += kBigChunk) {
      const int cnt = min(kBigChunk, big_hi - b0);
      __syncthreads();  // the last stage is read
      for (int i = tid; i < kBigF * cnt; i += kThreads) {
        const int r = i / cnt, b = i - r * cnt;
        sh_big[r * kBigChunk + b] =
            big_params[static_cast<long long>(r) * big_cap + b0 + b];
      }
      if (tid < cnt) sh_kind[tid] = big_kinds[b0 + tid];
      __syncthreads();
      for (int b = 0; b < cnt; ++b) {
        float p[12];
#pragma unroll
        for (int r = 0; r < 12; ++r) p[r] = sh_big[r * kBigChunk + b];
        const float idf = sh_big[12 * kBigChunk + b];
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
            if (kFused) loc[j] = -(b0 + b + 2);
          }
        }
      }
    }

    // The item's superrows through the ring.  Each warp walks them on its
    // own and leaves the item at its own exit (wstop); the CTA stops
    // staging once every warp has left.
    int issue = max(lo, big_n);  // the next flat row to stage
    bool stop = false;   // every warp left: stage and evaluate no more
    bool wstop = false;  // this warp left the item at its exit
    int passed = 0;      // superrows this warp passed
    int kept = 0;        // (slot, warp) pairs this warp kept
    // Superrows until the next exit check: after every check_every
    // superrows of the run, counted from its start.
    int until = check_every - (issue - big_n) % check_every;
    auto next_chunk = [&](int* start, int* cnt) {
      *start = issue;
      *cnt = stop ? 0 : max(min(chunk_rows, hi - issue), 0);
      issue += *cnt;
    };
    auto stage = [&](int slot, int start, int cnt) {
      if (cnt == 0 || warp != 0) return;
      if (lane == 0) mbar_arrive_expect(&full[slot], cnt * row_f * 4);
      __syncwarp();
      for (int j = lane; j < cnt; j += 32) {
        const int id = __ldg(&chunks[s0 + start - big_n + j]);
        if (kFused) sh_ids[slot * kMaxRows + j] = id;
        bulk_copy(ring + slot * kSlotF + j * row_f,
                  tab + static_cast<long long>(id) * row_f, row_f * 4,
                  &full[slot]);
      }
    };
    // After superrow f (flat rows passed) with depth minimum zrow: the
    // exit check, where due (warp-uniform), and whether the warp leaves.
    auto check_exit = [&](int f, auto zrow_of) {
      if (!allow_exit || (--until != 0 && f != hi)) return false;
      until = check_every;
      float q = floorf((zrow_of() - zmin) * zs) - 1.0f;
      q = q < 0.0f ? 0.0f : q;  // NaN stays NaN (jnp.maximum): no exit
      return exit_step<true>(tile_front, p0, tile_w, in_img, d, bound_d,
                             f < hi,  // superrows of the item left
                             zmin + q * thr);
    };

    int slot = 0, n_start, n_cnt;
    next_chunk(&n_start, &n_cnt);
    stage(0, n_start, n_cnt);
    for (;;) {
      const int c_start = n_start, c_cnt = n_cnt;
      if (c_cnt == 0) break;  // the same in every thread
      mbar_wait(&full[slot], (parity >> slot) & 1u);
      parity ^= 1u << slot;
      // Chunk staged and visible; the other slot is free.
      if (__syncthreads_and(wstop)) stop = true;
      next_chunk(&n_start, &n_cnt);
      stage(slot ^ 1, n_start, n_cnt);
      const float* sh = ring + slot * kSlotF;
      const int* ids = sh_ids + (kFused ? slot * kMaxRows : 0);
      slot ^= 1;
      if (stop || wstop) continue;
      if (k <= 32) {
        // 32 / k superrows per ballot: lane l tests slot l % k of
        // superrow r0 + l / k.
        const int rpb = 32 / k, seg = lane / k, u = lane - seg * k;
        const unsigned seg_mask = k == 32 ? 0xffffffffu : (1u << k) - 1u;
        const bool pow2 = (k & (k - 1)) == 0;
        for (int r0 = 0; r0 < c_cnt && !wstop; r0 += rpb) {
          bool keep = false;
          float z = __int_as_float(0x7f800000);
          if (seg < rpb && r0 + seg < c_cnt) {
            const float4 a =
                reinterpret_cast<const float4*>(sh + (r0 + seg) * row_f)[u * 2];
            z = a.z;
            keep = box_live && cull_keep(a, xlo, xhi, ylo, yhi);
          }
          const unsigned m = __ballot_sync(0xffffffffu, keep);
          if (allow_exit && pow2) {
            // Each segment's depth minimum at its first lane.
            for (int o = k >> 1; o > 0; o >>= 1)
              z = min_nan(z, __shfl_xor_sync(0xffffffffu, z, o));
          }
          for (int j = 0; j < rpb && r0 + j < c_cnt; ++j) {
            const int r = r0 + j;
            const float* row = sh + r * row_f;
            unsigned mj = (m >> (j * k)) & seg_mask;
            if (mj != 0) {
              kept += __popc(mj);
              float rz[kPix];
              int rs[kPix];
#pragma unroll
              for (int i = 0; i < kPix; ++i) {
                rz[i] = __int_as_float(0x7f800000);
                rs[i] = k;
              }
              while (mj) {
                eval_slot(row, __ffs(mj) - 1, qx, qy, rz, rs);
                mj &= mj - 1;
              }
              merge_row<kFused>(row, k, kFused ? ids[r] : 0, rz, rs, d, di,
                                loc);
            }
            ++passed;
            if (check_exit(c_start + r + 1, [&] {
                  return pow2 ? __shfl_sync(0xffffffffu, z, j * k)
                              : row_zmin(row, k);
                })) {
              wstop = true;
              break;
            }
          }
        }
      } else {
        // Wider superrows: one at a time, 32 slots per ballot.
        for (int r = 0; r < c_cnt; ++r) {
          const float* row = sh + r * row_f;
          float rz[kPix];
          int rs[kPix];
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            rz[i] = __int_as_float(0x7f800000);
            rs[i] = k;
          }
          bool any = false;
          for (int g0 = 0; g0 < k; g0 += 32) {
            const int u = g0 + lane;
            const bool keep =
                box_live && u < k &&
                cull_keep(reinterpret_cast<const float4*>(row)[u * 2], xlo,
                          xhi, ylo, yhi);
            unsigned m = __ballot_sync(0xffffffffu, keep);
            kept += __popc(m);
            any |= m != 0;
            while (m) {
              eval_slot(row, g0 + __ffs(m) - 1, qx, qy, rz, rs);
              m &= m - 1;
            }
          }
          if (any)
            merge_row<kFused>(row, k, kFused ? ids[r] : 0, rz, rs, d, di,
                              loc);
          ++passed;
          if (check_exit(c_start + r + 1, [&] { return row_zmin(row, k); })) {
            wstop = true;
            break;
          }
        }
      }
    }
    // The superrows the item passed: its warps' most.
    if (lane == 0 && passed > 0) atomicMax(&s_done, passed);
    __syncthreads();

    if (n == 1) {
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (in_img[j])
          write_pixel5<kFused>(static_cast<long long>(y0 + j) * width + x,
                               d[j], di[j], loc[j], qx, qy[j], tab,
                               big_params, big_cap, meta, uniform, depth_out,
                               index_out, rgb_out);
    } else {
      float locf[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) locf[j] = __int_as_float(loc[j]);
      write_partial<kFused ? 3 : 2>(partial, item, d, di, locf, nullptr, p0,
                                    tile_w);
    }
    if (walked != nullptr && tid == 0 && s_done > 0)
      atomicAdd(&walked[tile], s_done);
    if (bands != nullptr && lane == 0 && kept > 0)
      atomicAdd(&bands[tile], kept);
  }
}

// A split tile's per-item minima folded with the walk's full (depth, id)
// compare (the result depends on neither the split nor the item order;
// under kFused the winner's location rides along) and written to the
// image, under kFused through the epilogue; tiles of one item were
// written by the walk.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
csr5_merge_kernel(const int* __restrict__ plan,
                  const float* __restrict__ partial,
                  const float* __restrict__ tab,
                  const float* __restrict__ big_params,
                  const float* __restrict__ meta,
                  float* __restrict__ depth_out, int* __restrict__ index_out,
                  float* __restrict__ rgb_out, int big_cap, int width,
                  int height, int tiles_x, int tile_h, int tile_w,
                  int uniform) {
  const int tile = blockIdx.x;
  const int first = tile > 0 ? plan[tile - 1] : 0;
  const int n = plan[tile] - first;
  if (n <= 1) return;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  float d[kPix], di[kPix], locf[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    d[j] = __int_as_float(0x7f800000);
    di[j] = kEmpty;
    locf[j] = __int_as_float(kNoWinner);
  }
  fold_partials<kFused ? 3 : 2>(partial, first, n, d, di, locf);
  // Pixel j of this thread: tid + 256 j of the tile (the same column).
  const int x = tx * tile_w + threadIdx.x % tile_w;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int y = ty * tile_h + (threadIdx.x + kThreads * j) / tile_w;
    if (x < width && y < height)
      write_pixel5<kFused>(static_cast<long long>(y) * width + x, d[j], di[j],
                           __float_as_int(locf[j]),
                           static_cast<float>(x) + 0.5f,
                           static_cast<float>(y) + 0.5f, tab, big_params,
                           big_cap, meta, uniform, depth_out, index_out,
                           rgb_out);
  }
}

// Plan, walk and merge on `stream`; returns the first launch error.
template <bool kFused>
int walk5(const float* tab, const int* chunks, const int* starts,
          const float* big_params, const int* big_kinds, const int* big_n,
          const float* meta, int* front, int* walked, int* bands,
          float* depth, int* index, float* rgb, int* plan, float* partial,
          int big_cap, int width, int height, int tiles_x, int tiles_y,
          int tile_h, int tile_w, int k, int check_every, int allow_exit,
          int uniform, int split_rows, int max_items, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (tile_h * tile_w != kUnitPix ||
      (tile_w != 16 && tile_w != 32 && tile_w != 64 && tile_w != 128) ||
      k < 1 || k * kRowF > kSlotF || check_every < 1 || tiles_x < 0 ||
      tiles_y < 0 || split_rows < 1 || max_items < num_tiles ||
      (allow_exit && !front))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_plan_kernel<StripRows><<<1, kPlanThreads, 0, st>>>(
      StripRows{starts, 1}, big_n, big_cap, num_tiles, split_rows, max_items,
      plan, walked, num_tiles, allow_exit ? front : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int ctas =
      persistent_ctas(csr5_walk_kernel<kFused>, kRingBytes);
  csr5_walk_kernel<kFused><<<min(ctas, max_items), kThreads, kRingBytes,
                             st>>>(
      tab, chunks, starts, big_params, big_kinds, big_n, meta, plan, partial,
      depth, index, rgb, walked, bands, front, big_cap, width, height,
      tiles_x, num_tiles, tile_h, tile_w, k, check_every, allow_exit,
      uniform, max_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr5_merge_kernel<kFused><<<num_tiles, kThreads, 0, st>>>(
      plan, partial, tab, big_params, meta, depth, index, rgb, big_cap,
      width, height, tiles_x, tile_h, tile_w, uniform);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the first failed launch
// (0 = success).  tab (C', 8k) f32 superrows, 16-byte aligned; chunks (>=
// starts[T]) i32 chunk ids in key order; starts (T+1) i32 per-tile entry
// runs; big_params (17, big_cap) f32 and big_kinds (big_cap) i32, the
// first min(*big_n, big_cap) live; big_n one i32 on the device; meta (16)
// f32 [zmin, s, thr_scale, light (3), ambient, diffuse, background (3),
// uniform color (3), 0, 0]; front, with allow_exit, (T, 1024) i32 scratch
// (the plan resets it); walked null or (T) i32, each tile's superrows
// passed before its exit (the plan zeroes it); bands null or (T) i32,
// zeroed by the caller, the (live slot, warp block) pairs each tile's
// cull kept; depth (H, W) f32; index (H, W) i32; plan (T + 3 max_items +
// 3) i32 and partial (max_items, 2, 1024) f32 scratch; allow_exit != 0
// checks the exit every check_every superrows; a tile of more than
// split_rows rows (big rows and superrows) is cut into items (max_items
// >= T in all).
extern "C" int csr5_raster(const float* tab, const int* chunks,
                           const int* starts, const float* big_params,
                           const int* big_kinds, const int* big_n,
                           const float* meta, int* front, int* walked,
                           int* bands, float* depth, int* index, int* plan,
                           float* partial, int big_cap, int width, int height,
                           int tiles_x, int tiles_y, int tile_h, int tile_w,
                           int k, int check_every, int allow_exit,
                           int split_rows, int max_items, void* stream) {
  return walk5<false>(tab, chunks, starts, big_params, big_kinds, big_n, meta,
                      front, walked, bands, depth, index, nullptr, plan,
                      partial, big_cap, width, height, tiles_x, tiles_y,
                      tile_h, tile_w, k, check_every, allow_exit, 0,
                      split_rows, max_items, stream);
}

// csr5_raster that also writes the shaded rgb (H, W, 3) f32; uniform != 0
// takes the binned winners' color from meta; partial (max_items, 3, 1024)
// f32 (the third plane: the winner's location).
extern "C" int csr5_shaded(const float* tab, const int* chunks,
                           const int* starts, const float* big_params,
                           const int* big_kinds, const int* big_n,
                           const float* meta, int* front, int* walked,
                           int* bands, float* depth, int* index, float* rgb,
                           int* plan, float* partial, int big_cap, int width,
                           int height, int tiles_x, int tiles_y, int tile_h,
                           int tile_w, int k, int check_every, int allow_exit,
                           int uniform, int split_rows, int max_items,
                           void* stream) {
  return walk5<true>(tab, chunks, starts, big_params, big_kinds, big_n, meta,
                     front, walked, bands, depth, index, rgb, plan, partial,
                     big_cap, width, height, tiles_x, tiles_y, tile_h, tile_w,
                     k, check_every, allow_exit, uniform, split_rows,
                     max_items, stream);
}

extern "C" const char* csr5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
