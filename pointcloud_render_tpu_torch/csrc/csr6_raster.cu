// v6, v4 and v3 tile rasterizers for Hopper (sm_90a) over 32x32 pixel
// tiles.  Seven kernels share the split walk: csr6_raster (16-float binned
// rows at span 2, 4 or 8; with bin_triangles, binned triangles too),
// csr6_cap10 (the same walk over 10-float capsule rows), csr6_disc8
// (8-float disc rows), csr6_disc8_uv (disc rows, with the winner's
// lambert plane coordinates carried through the merge), csr6_rows9
// (kind-split 9-float disc and capsule rows, any span), csr4_raster (the
// v4 walk over per-tile entry runs with the z-bucket early exit) and
// csr3_raster (the v3 disc fast path: stable runs, a strict-< merge on
// the entry index, the z-bucket early exit).
//
// csr6_raster replaces three Pallas TPU pieces of
// pointcloud_render_tpu/raster:
//   * pallas_csr6._make_kernel6 / _make_tile_body — the per-tile walk over
//     the tile's CSR ranges of the anchor-sorted soup.  At span 2 these
//     are four merged ranges: its own anchor (classes 0..3), the left
//     neighbour's x-spill classes {1, 2}, the up neighbour's y-spill
//     classes {2, 3} and the diagonal's "both" class {2}, guarded at
//     tx >= 1 / ty >= 1; with the z-bucket early exit, the nine
//     single-class segments they merge.  At span 4 and 8 (span x span
//     classes, row-major cy * span + cx) they are the own anchor's range
//     plus, per neighbour (dx, dy), one range per class row cy >= dy of
//     the classes cx >= dx (one range when dx = 0): see tile_range;
//   * pallas_csr4._make_row_body16 — the 16-float row evaluation: the
//     capsule (a disc is a zero-axis capsule) and the triangle dual, in
//     the exact expression order of the JAX code;
//   * pallas_csr4._stream_big and the resident big-list branch of
//     _make_tile_body — every tile merges every big-list row through the
//     triangle-aware evaluation.
// A CTA sizes its ranges in parallel (one or two per thread), scans their
// lengths, and stages rows across range boundaries in chunks, so empty
// and tiny ranges cost no synchronisation (size_ranges, flat_pos).
//
// csr6_raster with bin_triangles (the mesh-LOD droplets; the kRows16Tri
// instance of its walk): small triangles are binned like discs and
// capsules, and the binned ranges go through the triangle-aware dual
// evaluation as the big list does (pallas_csr6._make_tile_body's binned
// stream with _make_row_body16(with_triangles=True)).  Every thread reads
// the same staged row, so the per-row kind branch does not diverge.
//
// csr6_cap10 replaces pallas_csr6._make_row_body10 (cap_rows10): the
// binned rows are [x0, y0, z0, r0, sdx, sdy, sdz, sdr, il2, idf], the
// lanes of the 16-float row that its capsule body reads, evaluated by the
// same function (capsule_pair), so winners and depth bits equal
// csr6_raster's; triangles ride the big list (16-float rows, dual body).
// A 40 B row is not 16-byte aligned: rows are staged as five 8-byte
// copies into a 10-float stride of shared memory.  It has no exit: its
// rows carry no zlb lane (the JAX package forces the exit off).
//
// csr6_raster, csr6_cap10 and csr6_rows9 walk in three launches (the
// split walk of split_walk.cuh; the disc walks below in four).  What
// bounds them: per-pair arithmetic (below), and how evenly it is spread.
// One CTA per tile left a dense tile's whole range on one SM (the traj
// preset packs trail capsules, the droplet lane its droplets, into a few
// tiles at the cloud's centre), and staged each chunk synchronously.
// (1) split_plan_kernel sizes every tile's rows (its big rows, then its
// binned ranges: TileRows) and cuts a
// tile of more than split_rows rows into work items, contiguous slices of
// those rows: the first takes the big list and the first w rows, the
// others share the rest; (2) csr6_walk_kernel (csr6_rows9_walk_kernel)
// runs one persistent CTA per free SM slot, each taking the next item
// from a counter; (3) csr6_merge_kernel merges a split tile's per-item
// (depth, id) minima with the walk's own compare, so the image does not
// depend on the split or the order.  Rows are staged in chunks of 256
// (341 for 9-float rows: a slot's floats over their 12-float stride,
// kChunk9) through a two-slot ring by cp.async (16 B .cg copies for 64 B
// rows, 8 B for 40 B rows, 4 B for 36 B rows), the next
// chunk (and the sorted id of the one after, where rows are gathered by
// id) in flight while a chunk is evaluated.  TMA does not serve the
// gather of csr6_raster and csr6_cap10: its copies are boxes of a tensor,
// and these rows are scattered records found through order[] (one 64 or
// 40 B row per id); csr6_rows9's rows sit in sorted order, but a 36 B row
// is only 4-byte aligned, below the bulk copy's 16.
// The exit (pallas_csr6's allow_exit, B1; csr6_disc8 takes it too, forced
// on, with the disc's depth, lane 2, as its bound): with zmeta the
// binning's keys carry the z-bucket of each prim's depth lower bound
// (lane 14), so each
// single-class segment ascends in bucket; after a chunk whose segment
// goes on past it, the CTA takes the rule of csr4_raster below over its
// in-image pixels (the TPU block counts all 1024; both are sound) and
// skips the rest of the segment, never across a class boundary.  A split
// item decides on its own minima, which are never below the tile's.
//
// csr4_raster replaces pallas_csr4._make_kernel4 (v4): every binned prim
// is expanded into the up-to-four (tile, z-bucket) entries its 2x2 tile
// bbox covers, so a tile's rows are one contiguous entry run
// [starts[t], starts[t+1]) of prim ids, ascending in the bucket of their
// depth lower bound zlb (lane 14).  What bounds it: per-pair arithmetic
// (below) over 1024 pixels x the entries its tiles walk before their
// exits, and how evenly that is spread: one CTA per tile left a dense
// tile's whole run on one SM (traj_ball's cloud projects to a few tiles
// at the frame's centre) and gathered each chunk synchronously, the big
// list again in every tile.  Design: the split walk (csr4_walk_kernel;
// the run is a unit of split_plan_kernel, a tile of more than split_rows
// rows is cut into work items on persistent CTAs), rows gathered by id
// through a cp.async ring (the big list the same way; TMA does not serve
// scattered records found through entries[]), a split tile's items merged
// by csr6_merge_kernel.  The exit: after each chunk an item stops when
// zmin + max(floor((zlb_last - zmin) * s) - 1, 0) * thr_scale is strictly
// greater than every in-image pixel's depth (its own, or the tile's
// shared `front`), zlb_last being the chunk's last entry's: every later
// entry's depth is at least its zlb, which is past that floor, so none
// can change a winner (strict: at equality a later entry with a lower id
// could).  The TPU kernel decides it per grid step over all 1024 pixels
// of the block; both are sound.  With the exit the items go out in waves
// and an item whose first entry already lies past the shared depths
// skips its slice (the first-row test of csr2_raster).
//
// csr3_raster replaces pallas_csr3._make_kernel3 (v3, the disc fast
// path): the binned entries are 2x2-span discs only, sorted STABLY by
// (tile, z-bucket) over the id-major expansion, so a tile's run ascends
// in (bucket, prim id), and the rows are entry-indexed ([px, py, z, r*r,
// ...] in sorted order: no gather by id).  The big list runs first in
// rank order (prim order) through the 16-float dual, the same float32
// expressions as the JAX package's scalar evaluators _eval_capsule /
// _eval_tri (pallas_csr.py:60-85), then the tile's run in order; both
// with a strict < on depth, so the first (lowest-id) pair at the least
// depth wins without an id compare (a disc's depth is constant over its
// footprint).  The kernel writes the winner's ENTRY: its sorted position,
// -(rank + 2) for a big winner, INT32_MAX where nothing won.  It takes
// the split walk and the disc walks' warp-band cull (csr3_walk_kernel): a
// tile's run is one contiguous range of 32 B rows, staged by bulk copies;
// a split tile's items fold into the first winner of the whole walk,
// (depth, walk_order3 of the entry) (csr3_merge_kernel).  The early exit
// checks once per `block` entries of the run (the TPU: once per
// 512-entry DMA chunk): the last entry's bucket, one bucket back, stops
// an item when zmin + qz * thr_scale > the depth of every in-image pixel
// (strict, unlike the TPU's >=: under a split the tile's shared depth at
// a pixel may come from a later item, and an entry of this item at that
// depth would win).
//
// csr6_disc8 replaces pallas_csr6._make_row_body8 (the discs_only walk at
// span 2, 4 or 8, its ranges walked as csr6_raster's: binned rows are
// [px, py, z, r*r, idf, flag, 0, 0], covered where dx*dx + dy*dy <= r*r)
// and csr6_disc8_uv replaces
// pallas_csr6._make_row_body8_uv with _make_big_body16_uv: the same walk,
// every pixel also keeping u = dx * flag and v = -dy * flag of its
// winning pair (flag = 1/r; lane 5 of a disc row, lane 13 of a big row),
// +inf when the winner is a triangle or a capsule.  u and v change under
// the very predicate that changes depth and id, so they are a function
// of the winning pair alone: the merge of a split tile takes them from
// the winner merge_pair's compare picks.  Both walk the big list as a
// dense array of 16-float big rows.  What bounds them: a disc is a few
// pixels wide, so of the 1024 x tile rows pairs of a tile (1.2M tile
// rows at the disc lane's frame 120) almost none can be covered, and a
// tile's rows are its neighbours' spills as well as its own.  Design
// (csr6_disc_walk_kernel): the rows are built in sorted order
// (build_rows8), so a tile's ranges are contiguous runs staged by bulk
// copies, with no order[] gather and no per-row range search; the split
// walk spreads the dense tiles over persistent CTAs; and each warp owns
// a band of 4 pixel rows and evaluates only the rows whose disc can
// reach it (band_live: one exact test per row and warp, 17% of the pairs
// kept there), so the walk is bound by the pairs it keeps, their merges,
// and the latency of its barriers and copies.
//
// csr6_rows9 replaces pallas_csr6._make_row_body9d / _make_row_body9c
// (the rows9 mode; rows8's _make_row_body8d / _make_row_body8c evaluate
// the same float32 expressions and route here too) inside the v6 walk
// at span 2, 4 or 8.  The binning is kind-split: every disc's key sorts
// before every capsule's, so a tile has a disc range set and a capsule
// range set, each walked as csr6_raster walks its ranges.  Rows are 9
// floats in sorted order, disc [px, py, z, r*r, idf, 0, 0, 0, 0] through
// the exact disc body, capsule [x0, y0, ux, -rho0, uy, rhod, z0, sdz, idf]
// through the renormalized segment-frame body (ux = sdx*il2,
// rho = r*sqrt(il2)).  Big rows (wide discs, wide capsules, the ground)
// keep the exact 16-float evaluation.  It takes the split walk
// (csr6_rows9_walk_kernel): a tile's flat rows are its big rows, its disc
// ranges, then its capsule ranges, each region sized with its own prefix,
// chunks never straddling a region boundary; 9-float chunks are staged by
// 4-byte cp.async copies, consecutive threads on consecutive floats of a
// range (no order[] gather), into a 12-float stride that the evaluation
// reads with 16-byte loads.  No exit: its rows carry no zlb lane.
//
// Winner per pixel = lexicographic min of (depth, primitive id) with
// strict compares, so the walk order does not matter (v3: the order is
// the stable run's, see above).  Exactness needs IEEE float32 per
// operation: build with -fmad=false (no multiply-add contraction) and
// without --use_fast_math (correctly rounded 1/iz).
//
// What bounds the walks on an H100: per-pair arithmetic.  Every (row,
// pixel) pair of a 16-float row must execute 17 float32 operations in the
// capsule body and 18 in the triangle body (per-row and per-pixel-column
// terms such as dx and dx * sdx hoisted; the three merge compares and the
// depth they read, z0 + sdz * t or 1 / iz, are needed only at covered
// pairs), and a tile evaluates every row of its ranges at
// all 1024 pixels, so the work is 1024 x (binned entries) + pixels x (big
// rows) pairs; row bytes (64 B per row, read once per tile it touches;
// 40 B under cap_rows10) are small beside that.  Design: rows are staged
// through shared memory in chunks (one row per thread, gathered by id
// through a cp.async ring, or contiguous runs by bulk copies), every
// thread keeps the
// (depth, id) minima of its 4 pixels in registers, and all threads read
// the same staged row (a shared-memory broadcast).  A disc pair must
// execute 4 operations (dy, dy * dy, + dx * dx, <= r * r; dx and dx * dx
// are per row and thread, not per pixel) and a disc row is 32 B, staged
// 512 at a time (v3 too, of which it reads 16 B).  A rows9 capsule pair must
// execute 16 (dy, a and g (2 each, with dx * ux and dx * uy per column),
// the clip (2), a - t, d2 (3), rad (2), d2 <= rad * rad (2), rad > 0; its
// depth z is read only at covered pairs).
// A binned triangle pair (csr6_raster or csr4_raster with bin_triangles)
// costs 18 operations, as a big-list one.  The bounds of the walks with
// an exit (csr6_raster, csr4_raster) count 1024 x (the rows their tiles
// evaluated before their exits, which the kernels report through
// `walked`) + pixels x (big rows) pairs.  The disc walks' and
// csr3_raster's bound is the pairs the function needs, whatever the
// walk's bands: 32 x (the (row, pixel row) pairs whose exact dy test
// passes) + pixels x (big rows), or the bytes if larger (with an exit,
// scaled by the share of rows walked); the (row, band) pairs their warps
// evaluate are reported through `bands`.
// The split walk: csr6_raster, csr6_cap10, csr6_rows9 and csr4_raster
// (cp.async ring) and csr6_disc8, csr6_disc8_uv, csr3_raster (bulk copies,
// warp-band cull) here, csr2_raster, csr1_raster and csr2_disc8 (bulk
// copies; csr2_disc8 with a warp cull) in csr2_raster.cu, csr5_raster and
// csr5_shaded (bulk copies, warp cull) in csr5_raster.cu.  Every kernel
// of the port walks its tiles this way.

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // clip01, capsule_pair, tri_pair
#include "split_walk.cuh"    // plan, item counter, cp.async, merge

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kPix = kTile * kTile / kThreads;  // pixels per thread
constexpr int kChunk = 256;                      // rows per staged chunk
constexpr int kRowF = 16;
constexpr float kEmpty = 16777216.0f;           // 2^24 > every prim id

// One pair of a staged 16-float row (a, b, c, e = its four float4s): the
// triangle dual when kTri and the row's kind flag (lane 15) is set, else
// the capsule body.  Returns covered; writes the depth and the capsule's
// (dx, dy).
template <bool kTri>
__device__ __forceinline__ bool pair16(const float4& a, const float4& b,
                                       const float4& c, const float4& e,
                                       float qx, float qy, float* z,
                                       float* dx, float* dy) {
  if (kTri && e.w > 0.0f)
    return tri_pair(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.z, c.w,
                    e.x, qx, qy, z);
  *dx = qx - a.x;
  *dy = qy - a.y;
  return capsule_pair(*dx, *dy, a.z, a.w, b.x, b.y, b.z, b.w, c.x, z);
}

// Evaluate staged rows [0, count) at this thread's pixels.  kTri selects
// the dual (triangle-aware) body used for the big list and, under
// bin_triangles, for binned rows; otherwise binned rows are
// discs/capsules and take the capsule body alone, as on the TPU.  kUV
// also keeps the winner's (u, v): a big-list disc (no triangle, lane 13
// > 0) gives dx * flag and -dy * flag, any other row +inf.  A triangle's
// 1 / iz is divided only at covered pairs: nothing else reads it, and iz >
// 0 there, so the depth is tri_pair's.
template <bool kTri, bool kUV>
__device__ __forceinline__ void eval_rows(const float4* sh, int count,
                                          float qx, const float* qy,
                                          float* d, float* di, float* u,
                                          float* v) {
  const float inf = __int_as_float(0x7f800000);
  for (int r = 0; r < count; ++r) {
    const float4 a = sh[r * 4 + 0];  // x0, y0, z0, r0
    const float4 b = sh[r * 4 + 1];  // sdx, sdy, sdz, sdr
    const float4 c = sh[r * 4 + 2];  // il2, idf, lane10, lane11
    const float4 e = sh[r * 4 + 3];  // lane12, lane13, zlb, kind flag
    const float idf = c.y;
    // The row's kind is the same for every thread (a broadcast row), so
    // the branch does not diverge: a big-list capsule skips the triangle
    // body and its division.
    if (kTri && e.w > 0.0f) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float iz;
        if (tri_cover(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.z, c.w,
                      e.x, qx, qy[k], &iz)) {
          const float z = 1.0f / iz;
          if ((z < d[k]) || ((z == d[k]) && (idf < di[k]))) {
            d[k] = z;
            di[k] = idf;
            if (kUV) {
              u[k] = inf;
              v[k] = inf;
            }
          }
        }
      }
      continue;
    }
    const bool is_disc = !(kTri && e.w > 0.0f) && e.y > 0.0f;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      float z, dx = 0.0f, dy = 0.0f;
      const bool cov = pair16<kTri>(a, b, c, e, qx, qy[k], &z, &dx, &dy);
      if (cov && ((z < d[k]) || ((z == d[k]) && (idf < di[k])))) {
        d[k] = z;
        di[k] = idf;
        if (kUV) {
          u[k] = is_disc ? dx * e.y : inf;
          v[k] = is_disc ? -dy * e.y : inf;
        }
      }
    }
  }
}

// The warp-band cull of the disc walks: lane `lane` tests staged disc row
// r = base + lane ([px, py, z, r*r, ...] at float r * 8) against its
// warp's band of pixel centres y0 + 0.5 .. y_last (warp-uniform), and the
// warp takes the ballot.  A row is skipped when fl(dy * dy) > r*r at the
// band's centre nearest to py (clamp(floor(py) + 0.5, band)), dy = qy -
// py.  That is exact: qy - py rounds monotonically in qy and keeps its
// sign, so no centre of the band has a smaller |fl(qy - py)|, fl(dy * dy)
// is monotone in |dy|, and fl(dx2 + dy2) >= dy2 for every dx2 >= 0 (NaN:
// no cover), so no pixel of the band passes dx2 + dy * dy <= r*r.  Strict:
// a pair at equality is covered.  A NaN py or r*r never skips.
__device__ __forceinline__ unsigned band_live(const float* sh, int base,
                                              int count, float y_lo,
                                              float y_hi) {
  const int r = base + (threadIdx.x & 31);
  bool live = false;
  if (r < count) {
    const float4 a = reinterpret_cast<const float4*>(sh)[r * 2];
    const float near = fminf(fmaxf(floorf(a.y) + 0.5f, y_lo), y_hi);
    const float dy = near - a.y;
    live = !(dy * dy > a.w);
  }
  return __ballot_sync(0xffffffffu, live);
}

// Evaluate staged 8-float disc rows [0, count) (2 x float4 each) at this
// thread's kPix pixels (one column, kPix consecutive pixel rows from
// y_lo: the warp's band): pallas_csr6._make_row_body8 /
// _make_row_body8_uv, each row only where band_live keeps it for the
// warp.  Returns the rows the warp evaluated.
template <bool kUV>
__device__ __forceinline__ int eval_disc_band(const float* sh, int count,
                                              float qx, float y_lo,
                                              float* d, float* di, float* u,
                                              float* v) {
  const float4* rows = reinterpret_cast<const float4*>(sh);
  const float y_hi = y_lo + static_cast<float>(kPix - 1);
  int evaluated = 0;
  for (int base = 0; base < count; base += 32) {
    unsigned m = band_live(sh, base, count, y_lo, y_hi);
    evaluated += __popc(m);
    while (m) {
      const int r = base + __ffs(m) - 1;
      m &= m - 1;
      const float4 a = rows[r * 2 + 0];  // px, py, z, r*r
      const float4 b = rows[r * 2 + 1];  // idf, flag (1/r), 0, 0
      const float z = a.z, r2 = a.w, idf = b.x;
      const float dx = qx - a.x;
      const float dx2 = dx * dx;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float dy = (y_lo + static_cast<float>(k)) - a.y;
        const bool cov = dx2 + dy * dy <= r2;
        if (cov && ((z < d[k]) || ((z == d[k]) && (idf < di[k])))) {
          d[k] = z;
          di[k] = idf;
          if (kUV) {
            u[k] = dx * b.y;
            v[k] = -dy * b.y;
          }
        }
      }
    }
  }
  return evaluated;
}

constexpr int kRowF9 = 9;
constexpr int kStride9 = 12;  // floats per staged 9-float row (48 B)
constexpr int kRowF10 = 10;
constexpr int kMaxRanges = 512;  // range slots: span^3 at span 8

// Evaluate staged 9-float rows [0, count) at this thread's pixels:
// kCap the renormalized capsule body (pallas_csr6._make_row_body9c),
// else the exact disc body (_make_row_body9d).  Rows are staged at a
// stride of kStride9 floats, so a row is two 16-byte loads and one more.
template <bool kCap>
__device__ __forceinline__ void eval_rows9(const float* sh, int count,
                                           float qx, const float* qy,
                                           float* d, float* di) {
  for (int r = 0; r < count; ++r) {
    const float* row = sh + r * kStride9;
    const float4 lo = reinterpret_cast<const float4*>(row)[0];
    const float4 mid = reinterpret_cast<const float4*>(row)[1];
    if (kCap) {
      const float x0 = lo.x, y0 = lo.y, ux = lo.z, nr0 = lo.w;
      const float uy = mid.x, rhod = mid.y, z0 = mid.z, sdz = mid.w;
      const float idf = row[8];
      const float dx = qx - x0;
      const float dxux = dx * ux;
      const float dxuy = dx * uy;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float dy = qy[k] - y0;
        const float a = dxux + dy * uy;
        const float g = dy * ux - dxuy;
        const float t = clip01(a);
        const float am = a - t;
        const float d2 = am * am + g * g;
        const float rad = rhod * t - nr0;
        const float z = z0 + sdz * t;
        // Strict rad > 0: a disc row read here (lane 5 = 0) gives
        // rad = -r*r <= 0 and covers nothing; NaN rows fail every compare.
        const bool cov = (d2 <= rad * rad) & (rad > 0.0f);
        if (cov && ((z < d[k]) || ((z == d[k]) && (idf < di[k])))) {
          d[k] = z;
          di[k] = idf;
        }
      }
    } else {
      const float z = lo.z, r2 = lo.w, idf = mid.x;
      const float dx = qx - lo.x;
      const float dx2 = dx * dx;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float dy = qy[k] - lo.y;
        // A capsule row read here has r2 = -rho0 < 0: no cover.
        const bool cov = dx2 + dy * dy <= r2;
        if (cov && ((z < d[k]) || ((z == d[k]) && (idf < di[k])))) {
          d[k] = z;
          di[k] = idf;
        }
      }
    }
  }
}

// Evaluate staged 10-float capsule rows [0, count) at this thread's
// pixels: pallas_csr6._make_row_body10, the capsule body of eval_rows.
__device__ __forceinline__ void eval_rows10(const float* sh, int count,
                                            float qx, const float* qy,
                                            float* d, float* di) {
  for (int r = 0; r < count; ++r) {
    const float* row = sh + r * kRowF10;
    const float x0 = row[0], y0 = row[1], z0 = row[2], r0 = row[3];
    const float sdx = row[4], sdy = row[5], sdz = row[6], sdr = row[7];
    const float il2 = row[8], idf = row[9];
    const float dx = qx - x0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      float z;
      const bool cov = capsule_pair(dx, qy[k] - y0, z0, r0, sdx, sdy, sdz,
                                    sdr, il2, &z);
      if (cov && ((z < d[k]) || ((z == d[k]) && (idf < di[k])))) {
        d[k] = z;
        di[k] = idf;
      }
    }
  }
}

// Range slot q of tile (tx, ty) in the ordinal region starting at `reg`
// -> (first sorted position, length); length 0 for slots that name no
// range or a neighbour off the grid.  Span 2: the four merged ranges, or
// with `segs` (the early exit) the nine single-class segments, each
// ascending in z-bucket: the own anchor's classes 1..3, the left
// neighbour's 1 and 2, the up neighbour's 2 and 3, the diagonal's 2, and
// last the own anchor's class 0.  Class 0 (prims inside the tile) holds
// most rows but rarely covers the tile's border pixels, which the
// spilling classes do: walked first, they let the exit leave class 0.
// Wider spans: slot q = (cy * span + dy) * span + dx names neighbour
// (dx, dy)'s classes in class row cy with cx >= dx; for dx = 0 the slot
// cy = dy takes every class row from dy on at once.
__device__ __forceinline__ void tile_range(int q, int span, int tile, int tx,
                                           int ty, int tiles_x, int reg,
                                           const int* __restrict__ starts,
                                           int* s_out, int* n_out,
                                           bool segs = false) {
  int dx, dy, lo, hi;
  bool named = true;
  if (segs) {
    dx = (q == 3 || q == 4 || q == 7) ? 1 : 0;
    dy = (q == 5 || q == 6 || q == 7) ? 1 : 0;
    lo = q < 3 ? q + 1 : (q == 3 ? 1 : (q == 6 ? 3 : (q == 8 ? 0 : 2)));
    hi = lo + 1;
  } else if (span == 2) {
    dx = (q & 1);
    dy = (q >> 1);
    lo = q == 0 ? 0 : (q == 1 ? 1 : 2);
    hi = (q & 1) ? 3 : 4;
  } else {
    const int k2 = span * span;
    dx = q % span;
    dy = (q / span) % span;
    const int cy = q / k2;
    named = cy >= dy && (dx > 0 || cy == dy);
    lo = dx == 0 ? dy * span : cy * span + dx;
    hi = dx == 0 ? k2 : cy * span + span;
  }
  *s_out = 0;
  *n_out = 0;
  if (!named || tx < dx || ty < dy) return;
  const int base = reg + span * span * (tile - dy * tiles_x - dx);
  const int s = starts[base + lo];
  *s_out = s;
  *n_out = starts[base + hi] - s;
}

constexpr int kSegSlots = 9;  // single-class segments of a span-2 tile

__device__ __forceinline__ int range_slots(int span, bool segs = false) {
  return segs ? kSegSlots : (span == 2 ? 4 : span * span * span);
}

// Size the tile's ranges in the ordinal region `reg`: every thread sizes
// slots 2 * tid and 2 * tid + 1, and a block-wide exclusive scan of the
// lengths leaves each slot's first sorted position in range_start and
// its first flat row in range_cum.  Returns the tile's row count (the
// same in every thread); ends with a barrier.
__device__ int size_ranges(int span, int tile, int tx, int ty, int tiles_x,
                           int reg, const int* __restrict__ starts,
                           int* range_start, int* range_cum, int* warp_tot,
                           bool segs = false) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_slots = range_slots(span, segs);
  int len[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 2 * tid + h;
    int s = 0;
    len[h] = 0;
    if (q < n_slots)
      tile_range(q, span, tile, tx, ty, tiles_x, reg, starts, &s, &len[h],
                 segs);
    range_start[q] = s;
  }
  const int local = len[0] + len[1];
  int v = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    total += t;
  }
  const int excl = off + v - local;
  range_cum[2 * tid] = excl;
  range_cum[2 * tid + 1] = excl + len[0];
  __syncthreads();
  return total;
}

// The slot of flat row f of the sized ranges: the last slot whose
// prefix is <= f holds it (empty slots share their prefix with the next
// one).
__device__ __forceinline__ int find_slot(int f, int n_slots,
                                         const int* range_cum) {
  int lo = 0, hi = n_slots;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (range_cum[mid] <= f) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// The sorted position of flat row f of the sized ranges.
__device__ __forceinline__ int flat_pos(int f, int n_slots,
                                        const int* range_start,
                                        const int* range_cum) {
  const int q = find_slot(f, n_slots, range_cum);
  return range_start[q] + f - range_cum[q];
}

// The exit (zmeta, span 2): the end of the single-class segment that
// holds flat row f of the `binned` sized rows.
__device__ __forceinline__ int segment_end(int f, int n_slots,
                                           const int* range_cum,
                                           int binned) {
  const int q = find_slot(f, n_slots, range_cum);
  return q + 1 < n_slots ? range_cum[q + 1] : binned;
}

// The exit's bound after a row of depth floor zlb (zmeta = zmin, s,
// thr_scale): zmin + max(floor((zlb - zmin) * s) - 1, 0) * thr_scale, no
// later row of its segment being nearer.
__device__ __forceinline__ float bucket_floor(float zlb, float zmin,
                                              float zs, float thr_scale) {
  float qz = floorf((zlb - zmin) * zs) - 1.0f;
  qz = qz < 0.0f ? 0.0f : qz;  // NaN stays NaN: no exit
  return zmin + qz * thr_scale;
}

// Write this thread's (depth, id) minima, its pixel k at column px, row
// py0 + dpy * k: index -1 where the depth is +inf; with kUV also the
// winner's (u, v).
template <bool kUV = false>
__device__ __forceinline__ void write_pixels(
    const float* d, const float* di, const float* u, const float* v, int px,
    int py0, int dpy, int width, int height, float* depth_out,
    int* index_out, float* u_out, float* v_out) {
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int py = py0 + dpy * k;
    if (px < width && py < height) {
      const long long o = static_cast<long long>(py) * width + px;
      depth_out[o] = d[k];
      index_out[o] = isinf(d[k]) ? -1 : static_cast<int>(di[k]);
      if (kUV) {
        u_out[o] = u[k];
        v_out[o] = v[k];
      }
    }
  }
}

// Write a tile's minima (and with kUV its (u, v)) from the threads'
// pixels tid + 256 k.
template <bool kUV = false>
__device__ __forceinline__ void write_tile(
    const float* d, const float* di, int tx, int ty, int width, int height,
    float* depth_out, int* index_out, const float* u = nullptr,
    const float* v = nullptr, float* u_out = nullptr,
    float* v_out = nullptr) {
  write_pixels<kUV>(d, di, u, v, tx * kTile + (threadIdx.x & (kTile - 1)),
                    ty * kTile + (threadIdx.x >> 5), kThreads / kTile, width,
                    height, depth_out, index_out, u_out, v_out);
}

// This thread's pixel centres (qx; qy per k) and the empty minima.
__device__ __forceinline__ float init_pixels(int tx, int ty, float* qy,
                                             float* d, float* di) {
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qy[k] = static_cast<float>(ty * kTile + (threadIdx.x >> 5) + 8 * k) +
            0.5f;
    d[k] = __int_as_float(0x7f800000);  // +inf
    di[k] = kEmpty;
  }
  return static_cast<float>(tx * kTile + (threadIdx.x & (kTile - 1))) + 0.5f;
}

// ---------------------------------------------------------------------------
// The split walk of csr6_raster (16-float rows, with or without binned
// triangles) and csr6_cap10 (10-float rows): see the header.

enum RowMode { kRows16 = 0, kRows16Tri = 1, kRows10 = 2 };

constexpr int kRing = 2;                   // staged chunks: one in flight
constexpr int kSlotF = kChunk * kRowF;     // floats per ring slot (16 KB)
constexpr int kRingBytes = kRing * kSlotF * 4;
constexpr int kTilePix = kTile * kTile;

// The binned rows of tile t for split_plan_kernel: its ranges in each of
// `regions` ordinal regions (two under the kind split of csr6_rows9: the
// disc ranges, then the capsule ranges).
struct TileRows {
  const int* starts;
  int tiles_x, num_tiles, span, segs, regions;
  __device__ int operator()(int t) const {
    const int ty = t / tiles_x;
    const int tx = t - ty * tiles_x;
    const int n_slots = range_slots(span, segs != 0);
    int rows = 0;
    for (int r = 0; r < regions; ++r) {
      for (int q = 0; q < n_slots; ++q) {
        int st, len;
        tile_range(q, span, t, tx, ty, tiles_x, r * span * span * num_tiles,
                   starts, &st, &len, segs != 0);
        rows += len;
      }
    }
    return rows;
  }
};

// Where flat row f of a work item's tile lives: its live big rows first
// (csr6_raster: table rows by big_ids; csr6_cap10: the dense big_rows),
// then the binned ranges (rows of `table` by sorted id).
template <int kMode>
__device__ __forceinline__ const float* row_src(
    int f, int big_n, const float* __restrict__ table,
    const float* __restrict__ big_rows, const int* __restrict__ big_ids,
    const int* __restrict__ order, int n_slots, const int* range_start,
    const int* range_cum) {
  if (f < big_n) {
    if (kMode == kRows10) return big_rows + static_cast<long long>(f) * kRowF;
    return table + static_cast<long long>(big_ids[f]) * kRowF;
  }
  const int id = order[flat_pos(f - big_n, n_slots, range_start, range_cum)];
  return table + static_cast<long long>(id) *
                     (kMode == kRows10 ? kRowF10 : kRowF);
}

// The walk of csr6_raster and csr6_cap10: persistent CTAs take work
// items in order from the plan (an atomic counter).  An item is the
// slice [lo, hi) of its tile's flat rows (big rows, then binned ranges;
// split evenly among the tile's items), staged in chunks of kChunk rows
// through a ring of two shared-memory slots by cp.async, the next chunk
// (and the sorted id of the one after) in flight while the current one is
// evaluated.  Chunks never straddle the big/binned boundary.  With zmeta
// (span 2) the binned ranges are the nine single-class segments and,
// after a chunk whose segment goes on past it, the CTA leaves the segment
// when zmin + max(floor((zlb_last - zmin) * s) - 1, 0) * thr_scale
// exceeds the depth of every in-image pixel it owns (strict: at equality
// a later row with a lower id could win); chunks already staged evaluate
// only their rows past the segment.  The items of a split tile run at
// once and share their depths through `front` (the tile's 1024 pixels,
// depth_key ints): after each binned chunk an item folds its minima in
// by atomicMin and tests the exit against the result, which is at least
// the tile's final depth at every pixel (a minimum of partial minima).
// Alone, an item holding a slice of a segment would see pixels that
// other rows cover (the big list's ground, the spilling classes, the
// front of its own segment) as empty and never leave the segment.
// Which item leaves when depends on timing; no winner does.  A tile of
// one item writes the image; the items of a split
// tile write their (depth, id) minima to `partial`, merged by
// csr6_merge_kernel.  walked (null or (T)) sums the binned rows each
// tile's items evaluated.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
csr6_walk_kernel(const float* __restrict__ table,
                 const float* __restrict__ big_rows,
                 const int* __restrict__ order,
                 const int* __restrict__ starts,
                 const int* __restrict__ big_ids,
                 const int* __restrict__ big_n_ptr, int big_cap,
                 const float* __restrict__ zmeta, int* __restrict__ plan,
                 float* __restrict__ partial, float* __restrict__ depth_out,
                 int* __restrict__ index_out, int* __restrict__ walked,
                 int* __restrict__ front, int width, int height,
                 int tiles_x, int num_tiles, int span, int max_items) {
  extern __shared__ __align__(16) float ring[];  // kRing x kSlotF floats
  __shared__ int range_start[kMaxRanges];
  __shared__ int range_cum[kMaxRanges];
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const bool segs = zmeta != nullptr;
  const int n_slots = range_slots(span, segs);
  const int* items_cum = plan;
  const int* item_tile = plan + num_tiles;
  int* sched = plan + num_tiles + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float zmin = segs ? zmeta[0] : 0.0f;
  const float zs = segs ? zmeta[1] : 0.0f;
  const float thr_scale = segs ? zmeta[2] : 0.0f;

  for (;;) {
    // The item counter, slice and partial write of split_walk.cuh
    // (next_item, item_slice, write_partial), inline: through the helpers
    // this kernel took 83 registers instead of 77-79, one CTA fewer per SM.
    __syncthreads();  // the last item is done with s_item, ring and ranges
    if (tid == 0) s_item = atomicAdd(&sched[1], 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;
    const int tile = item_tile[item];
    const int first = tile > 0 ? items_cum[tile - 1] : 0;
    const int n = items_cum[tile] - first;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int binned = size_ranges(span, tile, tx, ty, tiles_x, 0, starts,
                                   range_start, range_cum, warp_tot, segs);
    const long long rows = big_n + binned;
    const int lo = static_cast<int>(rows * (item - first) / n);
    const int hi = static_cast<int>(rows * (item - first + 1) / n);
    float qy[kPix], d[kPix], di[kPix];
    const float qx = init_pixels(tx, ty, qy, d, di);
    // The depths the exit tests besides this item's: the tile's shared
    // ones when it is split (+inf otherwise); -inf at off-image pixels,
    // which are never tested.
    const float inf = __int_as_float(0x7f800000);
    float bound_d[kPix];
    bool in_image[kPix];
    const int px = tx * kTile + (tid & (kTile - 1));
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      in_image[k] = px < width && ty * kTile + (tid >> 5) + 8 * k < height;
      bound_d[k] = in_image[k] ? inf : -inf;
    }
    int* tile_front = segs && n > 1
                          ? front + static_cast<long long>(tile) * kTilePix
                          : nullptr;

    int issue = lo;  // the next flat row to stage
    int skip = lo;   // rows below it are evaluated or skipped by the exit
    int done = 0;    // binned rows evaluated
    // The chunk after the one staged last: [max(issue, skip), +cnt),
    // capped at hi and at the big/binned boundary.
    auto next_chunk = [&](int* start, int* cnt) {
      *start = max(issue, skip);
      const int end = *start < big_n ? min(big_n, hi) : hi;
      *cnt = min(kChunk, max(end - *start, 0));
      issue = *start + *cnt;
    };
    int pf = -1;  // the row this thread stages next, and where it lives
    const float* pf_src = nullptr;
    auto stage = [&](int slot, int start, int cnt) {
      if (tid < cnt) {
        const int f = start + tid;
        const float* src = f == pf ? pf_src
                                   : row_src<kMode>(f, big_n, table,
                                                    big_rows, big_ids, order,
                                                    n_slots, range_start,
                                                    range_cum);
        float* dst = ring + slot * kSlotF;
        if (kMode == kRows10 && f >= big_n) {
          // 40 B rows, 8-byte aligned in both memories: five copies.
          dst += tid * kRowF10;
#pragma unroll
          for (int j = 0; j < kRowF10; j += 2) cp_async8(dst + j, src + j);
        } else {
          dst += tid * kRowF;
#pragma unroll
          for (int j = 0; j < kRowF; j += 4) cp_async16(dst + j, src + j);
        }
      }
      cp_async_commit();
      // The sorted id of this thread's row in the next chunk, loaded now
      // so that its latency hides behind the evaluation (an exit jump
      // makes it stale: stage() then looks the row up again).
      pf = issue + tid;
      if (pf < hi)
        pf_src = row_src<kMode>(pf, big_n, table, big_rows, big_ids, order,
                                n_slots, range_start, range_cum);
      else
        pf = -1;
    };

    int slot = 0, n_start, n_cnt;
    next_chunk(&n_start, &n_cnt);
    stage(0, n_start, n_cnt);
    for (;;) {
      const int c_start = n_start, c_cnt = n_cnt;
      if (c_cnt == 0) break;  // the same in every thread
      cp_async_wait_all();
      __syncthreads();  // chunk staged and visible; the other slot is free
      next_chunk(&n_start, &n_cnt);
      stage(slot ^ 1, n_start, n_cnt);
      const float* sh = ring + slot * kSlotF;
      const int r0 = min(max(skip - c_start, 0), c_cnt);
      const float4* sh4 = reinterpret_cast<const float4*>(sh);
      if (c_start < big_n) {
        eval_rows<true, false>(sh4 + r0 * 4, c_cnt - r0, qx, qy, d, di,
                                     nullptr, nullptr);
      } else {
        if (kMode == kRows10)
          eval_rows10(sh + r0 * kRowF10, c_cnt - r0, qx, qy, d, di);
        else
          eval_rows<kMode == kRows16Tri, false>(
              sh4 + r0 * 4, c_cnt - r0, qx, qy, d, di, nullptr, nullptr);
        done += c_cnt - r0;
        if (kMode != kRows10 && segs && r0 < c_cnt) {
          const int seg_end =
              big_n + segment_end(c_start + c_cnt - 1 - big_n, n_slots,
                                  range_cum, binned);
          if (exit_step(tile_front, tid, kThreads, in_image, d, bound_d,
                        seg_end > c_start + c_cnt,  // the segment goes on
                        bucket_floor(sh[(c_cnt - 1) * kRowF + 14], zmin, zs,
                                     thr_scale)))
            skip = min(seg_end, hi);
        }
      }
      slot ^= 1;
    }

    if (n == 1) {
      write_tile(d, di, tx, ty, width, height, depth_out, index_out);
    } else {
      float* out = partial + static_cast<long long>(item) * 2 * kTilePix;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        out[tid + kThreads * k] = d[k];
        out[kTilePix + tid + kThreads * k] = di[k];
      }
    }
    if (walked != nullptr && tid == 0 && done > 0)
      atomicAdd(&walked[tile], done);
  }
}

// The (depth, id) minima of a split tile's items, merged with the walk's
// own compare (strict, so the result does not depend on the item order)
// and written to the image; tiles of one item were written by the walk.
// kUV (csr6_disc8_uv): the items carry the winner's (u, v) too.
template <bool kUV = false>
__global__ void __launch_bounds__(kThreads)
csr6_merge_kernel(const int* __restrict__ plan,
                  const float* __restrict__ partial,
                  float* __restrict__ depth_out, int* __restrict__ index_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int width, int height, int tiles_x) {
  const int tile = blockIdx.x;
  const int first = tile > 0 ? plan[tile - 1] : 0;
  const int n = plan[tile] - first;
  if (n <= 1) return;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  float qy[kPix], d[kPix], di[kPix], u[kPix], v[kPix];
  init_pixels(tx, ty, qy, d, di);
#pragma unroll
  for (int k = 0; k < kPix; ++k) u[k] = v[k] = __int_as_float(0x7f800000);
  fold_partials<kUV ? 4 : 2>(partial, first, n, d, di, u, v);
  write_tile<kUV>(d, di, tx, ty, width, height, depth_out, index_out, u, v,
                  u_out, v_out);
}

// The split walk of csr6_rows9 (kind-split 9-float rows in sorted order):
// persistent CTAs take work items from the plan, as csr6_walk_kernel.  A
// tile's flat rows are its live big rows (the dense 16-float big_rows,
// through the dual body), then its disc ranges (region 0, the exact disc
// body), then its capsule ranges (region 1, from span^2 T on: the
// renormalized capsule body); chunks never straddle those boundaries.
// Each region is sized with its own prefix into its own half of the slot
// arrays (at span 8 the two regions name 2 x 512 range slots).  Rows sit
// in sorted order, so there is no order[] gather: a 9-float chunk is
// staged by 4-byte cp.async copies, consecutive threads on consecutive
// floats of a range (rows are 36 B, only 4-byte aligned), each row at a
// 12-float stride of the slot (eval_rows9's 16-byte loads); big rows by
// 16-byte copies.  No exit: the rows carry no zlb lane.
constexpr int kChunk9 = kSlotF / kStride9;  // 9-float rows per ring slot

__global__ void __launch_bounds__(kThreads, 2)
csr6_rows9_walk_kernel(const float* __restrict__ rows9,
                       const float* __restrict__ big_rows,
                       const int* __restrict__ starts,
                       const int* __restrict__ big_n_ptr, int big_cap,
                       int* __restrict__ plan, float* __restrict__ partial,
                       float* __restrict__ depth_out,
                       int* __restrict__ index_out, int width, int height,
                       int tiles_x, int num_tiles, int span, int max_items) {
  extern __shared__ __align__(16) float ring[];  // kRing x kSlotF floats
  __shared__ int range_start[2 * kMaxRanges];    // discs, then capsules
  __shared__ int range_cum[2 * kMaxRanges];
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int n_slots = range_slots(span);
  const int* items_cum = plan;
  const int* item_tile = plan + num_tiles;
  int* sched = plan + num_tiles + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);

  for (;;) {
    const int item = next_item(sched, &s_item);
    if (item >= n_items) break;
    const int tile = item_tile[item];
    const int first = tile > 0 ? items_cum[tile - 1] : 0;
    const int n = items_cum[tile] - first;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int n_disc = size_ranges(span, tile, tx, ty, tiles_x, 0, starts,
                                   range_start, range_cum, warp_tot);
    const int n_cap = size_ranges(span, tile, tx, ty, tiles_x,
                                  span * span * num_tiles, starts,
                                  range_start + kMaxRanges,
                                  range_cum + kMaxRanges, warp_tot);
    const int disc_end = big_n + n_disc;
    int lo, hi;
    item_slice(static_cast<long long>(disc_end) + n_cap, item, first, n, &lo,
               &hi);
    float qy[kPix], d[kPix], di[kPix];
    const float qx = init_pixels(tx, ty, qy, d, di);

    int issue = lo;  // the next flat row to stage
    // The next chunk [issue, +cnt), capped at hi and at the region's end.
    auto next_chunk = [&](int* start, int* cnt) {
      *start = issue;
      const int end = issue < big_n      ? min(big_n, hi)
                      : issue < disc_end ? min(disc_end, hi)
                                         : hi;
      *cnt = min(issue < big_n ? kChunk : kChunk9, max(end - issue, 0));
      issue += *cnt;
    };
    auto stage = [&](int slot, int start, int cnt) {
      float* dst = ring + slot * kSlotF;
      if (start < big_n) {
        if (tid < cnt) {
          const float* src =
              big_rows + static_cast<long long>(start + tid) * kRowF;
#pragma unroll
          for (int j = 0; j < kRowF; j += 4)
            cp_async16(dst + tid * kRowF + j, src + j);
        }
      } else {
        const int reg = start < disc_end ? 0 : 1;
        const int g0 = start - (reg == 0 ? big_n : disc_end);
        const int* rs = range_start + reg * kMaxRanges;
        const int* rc = range_cum + reg * kMaxRanges;
        for (int j = tid; j < cnt * kRowF9; j += kThreads) {
          const int r = j / kRowF9;
          const int lane = j - r * kRowF9;
          const long long pos = flat_pos(g0 + r, n_slots, rs, rc);
          cp_async4(dst + r * kStride9 + lane, rows9 + pos * kRowF9 + lane);
        }
      }
      cp_async_commit();
    };

    int slot = 0, n_start, n_cnt;
    next_chunk(&n_start, &n_cnt);
    stage(0, n_start, n_cnt);
    for (;;) {
      const int c_start = n_start, c_cnt = n_cnt;
      if (c_cnt == 0) break;  // the same in every thread
      cp_async_wait_all();
      __syncthreads();  // chunk staged and visible; the other slot is free
      next_chunk(&n_start, &n_cnt);
      stage(slot ^ 1, n_start, n_cnt);
      const float* sh = ring + slot * kSlotF;
      if (c_start < big_n)
        eval_rows<true, false>(reinterpret_cast<const float4*>(sh),
                                     c_cnt, qx, qy, d, di, nullptr, nullptr);
      else if (c_start < disc_end)
        eval_rows9<false>(sh, c_cnt, qx, qy, d, di);
      else
        eval_rows9<true>(sh, c_cnt, qx, qy, d, di);
      slot ^= 1;
    }

    if (n == 1)
      write_tile(d, di, tx, ty, width, height, depth_out, index_out);
    else
      write_partial(partial, item, d, di);
  }
}

// Plan, walk and merge on `st`; returns the first launch error.
template <int kMode>
int launch_split_walk(const float* table, const float* big_rows,
                      const int* order, const int* starts,
                      const int* big_ids, const int* big_n, int big_cap,
                      const float* zmeta, int* walked, float* depth,
                      int* index, int* plan, float* partial, int* front,
                      int width, int height, int tiles_x, int tiles_y,
                      int span, int split_rows, int max_items,
                      cudaStream_t st) {
  const int num_tiles = tiles_x * tiles_y;
  if ((span != 2 && span != 4 && span != 8) || (zmeta && span != 2) ||
      (zmeta && !front) || split_rows < 1 || max_items < num_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  split_plan_kernel<TileRows><<<1, kPlanThreads, 0, st>>>(
      TileRows{starts, tiles_x, num_tiles, span, zmeta != nullptr, 1}, big_n,
      big_cap, num_tiles, split_rows, max_items, plan, walked, num_tiles,
      zmeta != nullptr ? front : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int ctas =
      persistent_ctas(csr6_walk_kernel<kMode>, kRingBytes);
  csr6_walk_kernel<kMode><<<min(ctas, max_items), kThreads, kRingBytes,
                            st>>>(
      table, big_rows, order, starts, big_ids, big_n, big_cap, zmeta, plan,
      partial, depth, index, walked, front, width, height, tiles_x,
      num_tiles, span, max_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr6_merge_kernel<false><<<num_tiles, kThreads, 0, st>>>(
      plan, partial, depth, index, nullptr, nullptr, width, height, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The split walk of csr4_raster (v4; see the header).  A unit is one
// tile; its flat rows are its live big rows (table rows by big_ids), then
// its entry run [starts[t], starts[t+1]) (table rows by entries[]), sized
// by the plan as one run (StripRows with one pass).  Persistent CTAs take
// work items from the plan, as csr6_walk_kernel; an item is the slice
// [lo, hi) of its tile's flat rows, gathered by id in chunks of kChunk
// 64 B rows (thread t copies row t of a chunk by four 16-byte cp.async
// copies) through a ring of two shared-memory slots, the next chunk in
// flight and the id of this thread's row in the chunk after it loaded
// while a chunk is evaluated.  Chunks never straddle the big/entry
// boundary.  The exit (exit_on: the keys carry z-buckets): a tile's run
// ascends in the bucket of its rows' zlb (lane 14), so after each chunk
// of entries the item folds its depths into the tile's `front` (a split
// tile's; the plan resets it) and stops when every in-image pixel lies
// strictly nearer than zmin + max(floor((zlb_last - zmin) * s) - 1, 0) *
// thr_scale (exit_step): no later entry of the run can win.  Strict: the
// front may hold a depth that a later item met, and an entry of this item
// at that depth with a lower id would win.  With the exit the plan hands
// the items out in waves (every tile's first item, then every tile's
// second, ...), so that a split tile's deep items start after its front
// ones have filled `front`, and an item whose first entry's floor already
// lies past the shared depths skips its slice.  A tile of one item writes
// the image; the items of a split tile write their (depth, id) minima to
// `partial` (csr6_merge_kernel).  walked (null or (T)) sums the entries
// each tile's items evaluated.
template <bool kTri>
__global__ void __launch_bounds__(kThreads, 2)
csr4_walk_kernel(const float* __restrict__ table,
                 const int* __restrict__ entries,
                 const int* __restrict__ starts,
                 const int* __restrict__ big_ids,
                 const int* __restrict__ big_n_ptr, int big_cap,
                 const float* __restrict__ zmeta, int* __restrict__ plan,
                 float* __restrict__ partial, float* __restrict__ depth_out,
                 int* __restrict__ index_out, int* __restrict__ walked,
                 int* __restrict__ front, int width, int height,
                 int tiles_x, int num_tiles, int max_items, int exit_on) {
  extern __shared__ __align__(16) float ring[];  // kRing x kSlotF floats
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int* items_cum = plan;
  const int* item_tile = plan + num_tiles;
  int* sched = plan + num_tiles + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float zmin = zmeta[0], zs = zmeta[1], thr_scale = zmeta[2];
  const float inf = __int_as_float(0x7f800000);

  for (;;) {
    const int ticket = next_item(sched, &s_item);
    if (ticket >= n_items) break;
    // With the exit the plan hands the items out in waves (ticket_item).
    const int item = exit_on ? sched[3 + ticket] : ticket;
    const int tile = item_tile[item];
    const int first = tile > 0 ? items_cum[tile - 1] : 0;
    const int n = items_cum[tile] - first;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int* run = entries + starts[tile];
    int lo, hi;
    item_slice(static_cast<long long>(big_n) + starts[tile + 1] -
                   starts[tile],
               item, first, n, &lo, &hi);
    float qy[kPix], d[kPix], di[kPix], bound_d[kPix];
    bool in_image[kPix];
    const float qx = init_pixels(tx, ty, qy, d, di);
    const int px = tx * kTile + (tid & (kTile - 1));
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      in_image[k] = px < width && ty * kTile + (tid >> 5) + 8 * k < height;
      // The depths the exit tests besides this item's: the tile's shared
      // ones when it is split (+inf until then); -inf off the image.
      bound_d[k] = in_image[k] ? inf : -inf;
    }
    int* tile_front = exit_on && n > 1
                          ? front + static_cast<long long>(tile) * kTilePix
                          : nullptr;
    if (tile_front != nullptr) {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (in_image[k])
          bound_d[k] = key_depth(__ldcg(&tile_front[tid + kThreads * k]));
      if (lo >= big_n && lo < hi &&
          exit_past(d, bound_d,
                    bucket_floor(__ldg(&table[static_cast<long long>(__ldg(
                                                  &run[lo - big_n])) *
                                                  kRowF + 14]),
                                 zmin, zs, thr_scale)))
        hi = lo;
    }
    // The table row of flat row f.
    auto row_id = [&](int f) {
      return __ldg(f < big_n ? &big_ids[f] : &run[f - big_n]);
    };

    int issue = lo;     // the next flat row to stage
    bool stop = false;  // the exit was taken: stage and evaluate no more
    int done = 0;       // entries evaluated
    auto next_chunk = [&](int* start, int* cnt) {
      *start = issue;
      const int end = stop ? issue : issue < big_n ? min(big_n, hi) : hi;
      *cnt = min(kChunk, max(end - issue, 0));
      issue += *cnt;
    };
    int pf = -1, pf_id = 0;  // this thread's row of the next chunk, its id
    auto stage = [&](int slot, int start, int cnt) {
      if (tid < cnt) {
        const int f = start + tid;
        const float* src =
            table + static_cast<long long>(f == pf ? pf_id : row_id(f)) *
                        kRowF;
        float* dst = ring + slot * kSlotF + tid * kRowF;
#pragma unroll
        for (int j = 0; j < kRowF; j += 4) cp_async16(dst + j, src + j);
      }
      cp_async_commit();
      // The id of this thread's row in the chunk after, loaded now so that
      // its latency hides behind the evaluation.
      pf = issue + tid;
      if (pf < hi)
        pf_id = row_id(pf);
      else
        pf = -1;
    };

    int slot = 0, n_start, n_cnt;
    next_chunk(&n_start, &n_cnt);
    stage(0, n_start, n_cnt);
    for (;;) {
      const int c_start = n_start, c_cnt = n_cnt;
      if (c_cnt == 0) break;  // the same in every thread
      cp_async_wait_all();
      __syncthreads();  // chunk staged and visible; the other slot is free
      next_chunk(&n_start, &n_cnt);
      stage(slot ^ 1, n_start, n_cnt);
      const float* sh = ring + slot * kSlotF;
      slot ^= 1;
      if (stop) continue;  // a chunk staged before the exit
      const float4* sh4 = reinterpret_cast<const float4*>(sh);
      if (c_start < big_n) {
        eval_rows<true, false>(sh4, c_cnt, qx, qy, d, di, nullptr, nullptr);
        continue;
      }
      eval_rows<kTri, false>(sh4, c_cnt, qx, qy, d, di, nullptr, nullptr);
      done += c_cnt;
      // The chunk's last zlb bounds every later entry of the run.
      if (exit_on)
        stop = exit_step(tile_front, tid, kThreads, in_image, d, bound_d,
                         c_start + c_cnt < hi,  // entries of the item left
                         bucket_floor(sh[(c_cnt - 1) * kRowF + 14], zmin, zs,
                                      thr_scale));
    }

    if (n == 1)
      write_tile(d, di, tx, ty, width, height, depth_out, index_out);
    else
      write_partial(partial, item, d, di);
    if (walked != nullptr && tid == 0 && done > 0)
      atomicAdd(&walked[tile], done);
  }
}

// Plan, walk and merge of the v4 walk on `st`; returns the first launch
// error.
template <bool kTri>
int walk4(const float* table, const int* entries, const int* starts,
          const int* big_ids, const int* big_n, int big_cap,
          const float* zmeta, int* front, int* walked, float* depth,
          int* index, int* plan, float* partial, int width, int height,
          int tiles_x, int num_tiles, int exit_on, int split_rows,
          int max_items, cudaStream_t st) {
  split_plan_kernel<StripRows><<<1, kPlanThreads, 0, st>>>(
      StripRows{starts, 1}, big_n, big_cap, num_tiles, split_rows, max_items,
      plan, walked, num_tiles, exit_on ? front : nullptr, exit_on);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int ctas = persistent_ctas(csr4_walk_kernel<kTri>, kRingBytes);
  csr4_walk_kernel<kTri><<<min(ctas, max_items), kThreads, kRingBytes, st>>>(
      table, entries, starts, big_ids, big_n, big_cap, zmeta, plan, partial,
      depth, index, walked, front, width, height, tiles_x, num_tiles,
      max_items, exit_on);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr6_merge_kernel<false><<<num_tiles, kThreads, 0, st>>>(
      plan, partial, depth, index, nullptr, nullptr, width, height, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The split walk of csr6_disc8 and csr6_disc8_uv (8-float disc rows in
// sorted order, the discs_only walk at span 2, 4 or 8): persistent CTAs
// take work items from the plan, as csr6_walk_kernel.  A tile's flat rows
// are its live big rows (the dense 16-float big_rows, through the dual
// body, never culled), then its binned ranges; chunks never straddle that
// boundary.  Rows sit in sorted order, so every range piece of a chunk is
// one contiguous run of 32 B rows: warp 0 issues one bulk copy per piece
// into a ring slot (kDiscChunk rows; a chunk of kChunk big rows is one
// copy), all completing on the slot's mbarrier, the next chunk in flight
// while one is evaluated.  Warp w owns the band of pixel rows 4 w .. 4 w
// + 3 of the tile and lane l its column l (a thread's kPix pixels are one
// column's); a warp walks a chunk's rows through band_live's cull
// (eval_disc_band), and a band below the image evaluates nothing.  With
// zmeta (csr6_disc8 at span 2, the exit forced on) the binned ranges are
// the nine single-class segments and the exit of csr6_walk_kernel
// applies, the disc rows' depth (lane 2, their zlb) the bucket's floor;
// the plan hands a split tile's items out in waves, and an item whose
// first row's segment already lies past the tile's shared depths skips
// that segment.  walked (null or (T)) sums the binned rows each tile's
// items evaluated, bands (null or (T), zeroed by the caller) the (binned
// row, warp band) pairs.  A tile of one item writes the image; the items
// of a split tile write their minima (and (u, v)) to `partial`, merged by
// csr6_merge_kernel<kUV>.  Registers are held to 64 (4 CTAs per SM): the
// culled walk waits on shared-memory loads and barriers more than it
// issues, and 32 warps per SM hide that better than 24 (28% faster on the
// disc lane; a 16-byte spill).
constexpr int kDiscRowF = 8;
constexpr int kDiscChunk = kSlotF / kDiscRowF;  // disc rows per ring slot

template <bool kUV>
__global__ void __launch_bounds__(kThreads, 4)
csr6_disc_walk_kernel(const float* __restrict__ rows8,
                      const float* __restrict__ big_rows,
                      const int* __restrict__ starts,
                      const int* __restrict__ big_n_ptr, int big_cap,
                      const float* __restrict__ zmeta, int* __restrict__ plan,
                      float* __restrict__ partial,
                      float* __restrict__ depth_out,
                      int* __restrict__ index_out, float* __restrict__ u_out,
                      float* __restrict__ v_out, int* __restrict__ walked,
                      int* __restrict__ bands, int* __restrict__ front,
                      int width, int height, int tiles_x, int num_tiles,
                      int span, int max_items) {
  constexpr int kPlanes = kUV ? 4 : 2;
  extern __shared__ __align__(128) float ring[];  // kRing x kSlotF floats
  __shared__ int range_start[kMaxRanges];
  __shared__ int range_cum[kMaxRanges];
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int s_item;
  __shared__ __align__(8) unsigned long long full[kRing];  // a slot landed
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool segs = zmeta != nullptr;
  const int n_slots = range_slots(span, segs);
  const int* items_cum = plan;
  const int* item_tile = plan + num_tiles;
  int* sched = plan + num_tiles + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float zmin = segs ? zmeta[0] : 0.0f;
  const float zs = segs ? zmeta[1] : 0.0f;
  const float thr_scale = segs ? zmeta[2] : 0.0f;
  const float inf = __int_as_float(0x7f800000);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  unsigned parity = 0;  // bit s: the phase of full[s] waited for next

  for (;;) {
    const int ticket = next_item(sched, &s_item);  // also publishes `full`
    if (ticket >= n_items) break;
    // With the exit the plan hands the items out in waves (ticket_item).
    const int item = segs ? sched[3 + ticket] : ticket;
    const int tile = item_tile[item];
    const int first = tile > 0 ? items_cum[tile - 1] : 0;
    const int n = items_cum[tile] - first;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int binned = size_ranges(span, tile, tx, ty, tiles_x, 0, starts,
                                   range_start, range_cum, warp_tot, segs);
    int lo, hi;
    item_slice(static_cast<long long>(big_n) + binned, item, first, n, &lo,
               &hi);
    // This thread's pixels: column lane, rows y0 .. y0 + kPix - 1 (the
    // warp's band); pixel k of the tile's 1024 is pix0 + 32 k.
    const int px = tx * kTile + lane;
    const int y0 = ty * kTile + warp * kPix;
    const int pix0 = warp * kPix * kTile + lane;
    const float qx = static_cast<float>(px) + 0.5f;
    const float y_lo = static_cast<float>(y0) + 0.5f;
    const bool band_in = y0 < height;  // the same in the whole warp
    float qy[kPix], d[kPix], di[kPix], u[kPix], v[kPix], bound_d[kPix];
    bool in_image[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      qy[k] = y_lo + static_cast<float>(k);
      d[k] = inf;
      di[k] = kEmpty;
      u[k] = inf;
      v[k] = inf;
      in_image[k] = px < width && y0 + k < height;
      // The depths the exit tests besides this item's: the tile's shared
      // ones when it is split (+inf until then); -inf off the image.
      bound_d[k] = in_image[k] ? inf : -inf;
    }
    int* tile_front = segs && n > 1
                          ? front + static_cast<long long>(tile) * kTilePix
                          : nullptr;
    int skip = lo;  // rows below it are evaluated or skipped by the exit
    if (tile_front != nullptr) {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (in_image[k])
          bound_d[k] = key_depth(__ldcg(&tile_front[pix0 + kTile * k]));
      if (lo >= big_n && lo < hi) {
        // The first row's segment, if the depths the tile's other items
        // shared already lie nearer than its floor at every pixel.
        const int f = lo - big_n;
        const int q = find_slot(f, n_slots, range_cum);
        const long long pos = range_start[q] + f - range_cum[q];
        if (exit_past(d, bound_d,
                      bucket_floor(__ldg(&rows8[pos * kDiscRowF + 2]), zmin,
                                   zs, thr_scale)))
          skip = min(big_n + segment_end(f, n_slots, range_cum, binned), hi);
      }
    }

    int issue = lo;  // the next flat row to stage
    int done = 0;    // binned rows evaluated
    int evaluated = 0;  // (binned row, band) pairs of this warp
    // The chunk after the one staged last: [max(issue, skip), +cnt),
    // capped at hi and at the big/binned boundary.
    auto next_chunk = [&](int* start, int* cnt) {
      *start = max(issue, skip);
      const bool big = *start < big_n;
      const int end = big ? min(big_n, hi) : hi;
      *cnt = min(big ? kChunk : kDiscChunk, max(end - *start, 0));
      issue = *start + *cnt;
    };
    auto stage = [&](int slot, int start, int cnt) {
      if (cnt == 0 || warp != 0) return;
      float* dst = ring + slot * kSlotF;
      if (start < big_n) {
        if (lane == 0)
          bulk_load(dst, big_rows + static_cast<long long>(start) * kRowF,
                    cnt * kRowF * 4, &full[slot]);
        return;
      }
      // One copy per range piece of the chunk, issued by the warp's lanes
      // after lane 0 has armed the slot for the whole chunk.
      if (lane == 0) mbar_arrive_expect(&full[slot], cnt * kDiscRowF * 4);
      __syncwarp();
      const int f0 = start - big_n, f1 = f0 + cnt;
      const int q0 = find_slot(f0, n_slots, range_cum);
      const int q1 = find_slot(f1 - 1, n_slots, range_cum);
      for (int q = q0 + lane; q <= q1; q += 32) {
        const int a = max(range_cum[q], f0);
        const int b = min(q + 1 < n_slots ? range_cum[q + 1] : binned, f1);
        if (b > a)
          bulk_copy(dst + (a - f0) * kDiscRowF,
                    rows8 + (static_cast<long long>(range_start[q]) + a -
                             range_cum[q]) * kDiscRowF,
                    (b - a) * kDiscRowF * 4, &full[slot]);
      }
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
      const float* sh = ring + slot * kSlotF;
      const int r0 = min(max(skip - c_start, 0), c_cnt);
      if (c_start < big_n) {
        if (band_in)
          eval_rows<true, kUV>(
              reinterpret_cast<const float4*>(sh) + r0 * 4, c_cnt - r0, qx,
              qy, d, di, u, v);
      } else {
        if (band_in)
          evaluated += eval_disc_band<kUV>(sh + r0 * kDiscRowF, c_cnt - r0,
                                           qx, y_lo, d, di, u, v);
        done += c_cnt - r0;
        if (segs && r0 < c_cnt) {
          const int end =
              big_n + segment_end(c_start + c_cnt - 1 - big_n, n_slots,
                                  range_cum, binned);
          if (exit_step(tile_front, pix0, kTile, in_image, d, bound_d,
                        end > c_start + c_cnt,  // the segment goes on
                        bucket_floor(sh[(c_cnt - 1) * kDiscRowF + 2], zmin,
                                     zs, thr_scale)))
            skip = min(end, hi);
        }
      }
      slot ^= 1;
    }

    if (n == 1)
      write_pixels<kUV>(d, di, u, v, px, y0, 1, width, height, depth_out,
                        index_out, u_out, v_out);
    else
      write_partial<kPlanes>(partial, item, d, di, u, v, pix0, kTile);
    if (walked != nullptr && tid == 0 && done > 0)
      atomicAdd(&walked[tile], done);
    if (bands != nullptr && lane == 0 && evaluated > 0)
      atomicAdd(&bands[tile], evaluated);
  }
}

// rows[t] = TileRows(t) for every tile, one warp per tile (its lanes over
// the range slots): at span 8 a tile names 512 slots, which the plan's
// single CTA would size one by one.
__global__ void __launch_bounds__(kThreads)
tile_rows_kernel(TileRows rows_of, int* __restrict__ rows) {
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= rows_of.num_tiles) return;
  const int ty = t / rows_of.tiles_x;
  const int tx = t - ty * rows_of.tiles_x;
  const int n_slots = range_slots(rows_of.span, rows_of.segs != 0);
  int sum = 0;
  for (int q = lane; q < n_slots; q += 32) {
    int st, len;
    tile_range(q, rows_of.span, t, tx, ty, rows_of.tiles_x, 0,
               rows_of.starts, &st, &len, rows_of.segs != 0);
    sum += len;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) rows[t] = sum;
}

// The plan's rows of tile t, sized by tile_rows_kernel.
struct RowsOfTile {
  const int* rows;
  __device__ int operator()(int t) const { return rows[t]; }
};

// Plan, walk and merge of the disc walks on `st`; returns the first
// launch error.  The tiles' rows are sized into the head of `partial`
// (as ints), which the walk overwrites only after the plan has read them.
template <bool kUV>
int disc_walk(const float* rows8, const float* big_rows, const int* starts,
              const int* big_n, int big_cap, const float* zmeta, int* front,
              int* walked, int* bands, float* depth, int* index, float* u,
              float* v, int* plan, float* partial, int width, int height,
              int tiles_x, int tiles_y, int span, int split_rows,
              int max_items, cudaStream_t st) {
  const int num_tiles = tiles_x * tiles_y;
  if ((span != 2 && span != 4 && span != 8) || (zmeta && span != 2) ||
      (zmeta && !front) || split_rows < 1 || max_items < num_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  int* rows = reinterpret_cast<int*>(partial);
  constexpr int kTilesPerCta = kThreads / 32;
  tile_rows_kernel<<<(num_tiles + kTilesPerCta - 1) / kTilesPerCta, kThreads,
                     0, st>>>(
      TileRows{starts, tiles_x, num_tiles, span, zmeta != nullptr, 1}, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_plan_kernel<RowsOfTile><<<1, kPlanThreads, 0, st>>>(
      RowsOfTile{rows}, big_n, big_cap, num_tiles, split_rows, max_items,
      plan, walked, num_tiles, zmeta != nullptr ? front : nullptr,
      zmeta != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int ctas =
      persistent_ctas(csr6_disc_walk_kernel<kUV>, kRingBytes);
  csr6_disc_walk_kernel<kUV><<<min(ctas, max_items), kThreads, kRingBytes,
                               st>>>(
      rows8, big_rows, starts, big_n, big_cap, zmeta, plan, partial, depth,
      index, u, v, walked, bands, front, width, height, tiles_x, num_tiles,
      span, max_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr6_merge_kernel<kUV><<<num_tiles, kThreads, 0, st>>>(
      plan, partial, depth, index, u, v, width, height, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The split walk of csr3_raster (v3; see the header).  A unit is one
// tile; its flat rows are its live big rows in rank order, then its
// stable run rows8[starts[t], starts[t+1]) (StripRows with one pass).
constexpr int kImax = 2147483647;
constexpr int kMaxBlock3 = 1024;  // entries between two exit checks, at most

// The order of the v3 walk over winner encodings: big winners -(rank + 2)
// first, by rank, then binned entries by sorted position, then kImax
// (nothing won).  The walk meets rows in this order, so under its strict
// < on depth the first winner at the least depth is the least (depth,
// walk_order3) pair, whichever item of a split tile met it.
__device__ __forceinline__ int walk_order3(int e) {
  return e >= 0 ? e : (-e - 2) + (-kImax - 1);
}

// Staged 16-float big rows [0, count), ranks rank0.., at this thread's
// pixels: the dual evaluation with a strict < on depth alone (the first,
// lowest-rank big prim at the least depth wins), the winner's entry
// -(rank + 2).
__device__ __forceinline__ void eval_big3(const float4* sh, int count,
                                          int rank0, float qx,
                                          const float* qy, float* d,
                                          int* e) {
  for (int r = 0; r < count; ++r) {
    const float4 a = sh[r * 4 + 0], b = sh[r * 4 + 1];
    const float4 c = sh[r * 4 + 2], f = sh[r * 4 + 3];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      float z, dx, dy;
      if (pair16<true>(a, b, c, f, qx, qy[k], &z, &dx, &dy) && z < d[k]) {
        d[k] = z;
        e[k] = -(rank0 + r + 2);
      }
    }
  }
}

// Staged 8-float entry rows [0, count) (sorted positions e0..) at this
// thread's band (eval_disc_band's pixels): the disc body with a strict <
// on depth, in entry order, each row only where band_live keeps it for
// the warp.  Returns the rows the warp evaluated.
__device__ __forceinline__ int eval_disc_band3(const float* sh, int count,
                                               int e0, float qx, float y_lo,
                                               float* d, int* e) {
  const float4* rows = reinterpret_cast<const float4*>(sh);
  const float y_hi = y_lo + static_cast<float>(kPix - 1);
  int evaluated = 0;
  for (int base = 0; base < count; base += 32) {
    unsigned m = band_live(sh, base, count, y_lo, y_hi);
    evaluated += __popc(m);
    while (m) {
      const int r = base + __ffs(m) - 1;
      m &= m - 1;
      const float4 a = rows[r * 2];  // px, py, z, r*r
      const float dx = qx - a.x;
      const float dx2 = dx * dx;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float dy = (y_lo + static_cast<float>(k)) - a.y;
        if ((dx2 + dy * dy <= a.w) && a.z < d[k]) {
          d[k] = a.z;
          e[k] = e0 + r;
        }
      }
    }
  }
  return evaluated;
}

// Persistent CTAs take work items from the plan, as csr6_disc_walk_kernel:
// an item is the slice [lo, hi) of its tile's flat rows, staged by bulk
// copies (a tile's run is one contiguous range of 32 B rows in sorted
// order; big rows 64 B) through a two-slot ring, the next chunk in flight
// while one is evaluated; each warp owns a band of kPix pixel rows and
// evaluates the run's rows that band_live keeps.  The exit (allow_exit):
// after every `block` entries of the run (counted from the run's start)
// the item folds its depths into the tile's `front` (a split tile's; the
// plan resets it) and stops when every in-image pixel lies strictly
// nearer than zmin + max(floor((z_last - zmin) * s) - 1, 0) * thr_scale,
// z_last the last evaluated entry's depth: every later entry of the run
// sits in the same or a later bucket, at least that deep.  Strict: the
// front may hold a depth that a later item met, and an entry of this item
// at that same depth has a lower position and wins (the single-CTA walk
// could stop at >=; a split walk cannot).  An item whose first entry's
// floor already lies past the shared depths skips its slice.  The items
// go out in plan order, the exit on or off: handing them out in waves,
// as csr2_raster does, made this walk slower on the disc lane (PERF.md),
// whose exit leaves few rows.  A tile of one item writes
// the image; the items of a split tile write (depth, entry bits) to
// `partial` (csr3_merge_kernel).  walked (null or (T)) sums the entries
// each tile's items evaluated, bands (null or (T), zeroed) the (entry,
// warp band) pairs.
__global__ void __launch_bounds__(kThreads, 4)
csr3_walk_kernel(const float* __restrict__ rows8,
                 const float* __restrict__ big_rows,
                 const int* __restrict__ starts,
                 const int* __restrict__ big_n_ptr, int big_cap,
                 const float* __restrict__ zmeta, int* __restrict__ plan,
                 float* __restrict__ partial, float* __restrict__ depth_out,
                 int* __restrict__ ent_out, int* __restrict__ walked,
                 int* __restrict__ bands, int* __restrict__ front, int width,
                 int height, int tiles_x, int num_tiles, int max_items,
                 int allow_exit, int block) {
  extern __shared__ __align__(128) float ring[];  // kRing x kSlotF floats
  __shared__ int s_item;
  __shared__ __align__(8) unsigned long long full[kRing];  // a slot landed
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* items_cum = plan;
  const int* item_tile = plan + num_tiles;
  int* sched = plan + num_tiles + max_items;
  const int n_items = sched[0];
  const int big_n = min(*big_n_ptr, big_cap);
  const float zmin = zmeta[0], zs = zmeta[1], thr_scale = zmeta[2];
  const float inf = __int_as_float(0x7f800000);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  unsigned parity = 0;  // bit s: the phase of full[s] waited for next

  for (;;) {
    const int item = next_item(sched, &s_item);  // also publishes `full`
    if (item >= n_items) break;
    const int tile = item_tile[item];
    const int first = tile > 0 ? items_cum[tile - 1] : 0;
    const int n = items_cum[tile] - first;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    const int s0 = starts[tile];
    int lo, hi;
    item_slice(static_cast<long long>(big_n) + starts[tile + 1] - s0, item,
               first, n, &lo, &hi);
    // This thread's pixels: column lane, rows y0 .. y0 + kPix - 1 (the
    // warp's band); pixel k of the tile's 1024 is pix0 + 32 k.
    const int px = tx * kTile + lane;
    const int y0 = ty * kTile + warp * kPix;
    const int pix0 = warp * kPix * kTile + lane;
    const float qx = static_cast<float>(px) + 0.5f;
    const float y_lo = static_cast<float>(y0) + 0.5f;
    const bool band_in = y0 < height;  // the same in the whole warp
    float qy[kPix], d[kPix], bound_d[kPix];
    int e[kPix];
    bool in_image[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      qy[k] = y_lo + static_cast<float>(k);
      d[k] = inf;
      e[k] = kImax;
      in_image[k] = px < width && y0 + k < height;
      // The depths the exit tests besides this item's: the tile's shared
      // ones when it is split (+inf until then); -inf off the image.
      bound_d[k] = in_image[k] ? inf : -inf;
    }
    int* tile_front = allow_exit && n > 1
                          ? front + static_cast<long long>(tile) * kTilePix
                          : nullptr;
    if (tile_front != nullptr) {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        if (in_image[k])
          bound_d[k] = key_depth(__ldcg(&tile_front[pix0 + kTile * k]));
      if (lo >= big_n && lo < hi &&
          exit_past(d, bound_d,
                    bucket_floor(__ldg(&rows8[static_cast<long long>(
                                                  s0 + lo - big_n) *
                                                  kDiscRowF + 2]),
                                 zmin, zs, thr_scale)))
        hi = lo;
    }

    int issue = lo;       // the next flat row to stage
    bool stop = false;    // the exit was taken: stage and evaluate no more
    int done = 0;         // entries evaluated
    int evaluated = 0;    // (entry, band) pairs of this warp
    auto next_chunk = [&](int* start, int* cnt) {
      *start = issue;
      const bool big = issue < big_n;
      const int end = stop ? issue : big ? min(big_n, hi) : hi;
      *cnt = min(big ? kChunk : kDiscChunk, max(end - issue, 0));
      issue += *cnt;
    };
    auto stage = [&](int slot, int start, int cnt) {
      if (tid != 0 || cnt == 0) return;
      float* dst = ring + slot * kSlotF;
      if (start < big_n)
        bulk_load(dst, big_rows + static_cast<long long>(start) * kRowF,
                  cnt * kRowF * 4, &full[slot]);
      else
        bulk_load(dst,
                  rows8 + static_cast<long long>(s0 + start - big_n) *
                              kDiscRowF,
                  cnt * kDiscRowF * 4, &full[slot]);
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
      const float* sh = ring + slot * kSlotF;
      slot ^= 1;
      if (stop) continue;  // a chunk staged before the exit
      if (c_start < big_n) {
        if (band_in)
          eval_big3(reinterpret_cast<const float4*>(sh), c_cnt, c_start, qx,
                    qy, d, e);
        continue;
      }
      // The run's entries, in pieces that end where the exit is checked:
      // at every multiple of `block` of the run, and at the item's end
      // (its depths folded for the tile's later items).
      const int o0 = c_start - big_n;  // run offset of the chunk
      for (int r = 0; r < c_cnt;) {
        const int r1 = allow_exit
                           ? min(c_cnt, ((o0 + r) / block + 1) * block - o0)
                           : c_cnt;
        if (band_in)
          evaluated += eval_disc_band3(sh + r * kDiscRowF, r1 - r,
                                       s0 + o0 + r, qx, y_lo, d, e);
        done += r1 - r;
        r = r1;
        if (allow_exit && ((o0 + r) % block == 0 || c_start + r == hi) &&
            exit_step(tile_front, pix0, kTile, in_image, d, bound_d,
                      c_start + r < hi,  // entries of the item left
                      bucket_floor(sh[(r - 1) * kDiscRowF + 2], zmin, zs,
                                   thr_scale))) {
          stop = true;
          break;
        }
      }
    }

    if (n == 1) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (in_image[k]) {
          const long long o = static_cast<long long>(y0 + k) * width + px;
          depth_out[o] = d[k];
          ent_out[o] = e[k];
        }
      }
    } else {
      // The entry's bits ride the partial's id plane (walk_order3 compares
      // them as ints in the merge).
      float ef[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) ef[k] = __int_as_float(e[k]);
      write_partial(partial, item, d, ef, nullptr, nullptr, pix0, kTile);
    }
    if (walked != nullptr && tid == 0 && done > 0)
      atomicAdd(&walked[tile], done);
    if (bands != nullptr && lane == 0 && evaluated > 0)
      atomicAdd(&bands[tile], evaluated);
  }
}

// A split tile's per-item (depth, entry) winners folded into the tile's:
// the least depth, and at equal depth the least walk_order3, the first
// winner of the walk over the whole tile whatever the slicing (the big
// rows may fall in any items).  Tiles of one item were written by the
// walk.
__global__ void __launch_bounds__(kThreads)
csr3_merge_kernel(const int* __restrict__ plan,
                  const float* __restrict__ partial,
                  float* __restrict__ depth_out, int* __restrict__ ent_out,
                  int width, int height, int tiles_x) {
  const int tile = blockIdx.x;
  const int first = tile > 0 ? plan[tile - 1] : 0;
  const int n = plan[tile] - first;
  if (n <= 1) return;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int o = threadIdx.x + kThreads * k;
    float d = __int_as_float(0x7f800000);
    int e = kImax;
    for (int j = 0; j < n; ++j) {
      const float* p =
          partial + static_cast<long long>(first + j) * 2 * kTilePix;
      const float pd = p[o];
      const int pe = __float_as_int(p[kTilePix + o]);
      if (pd < d || (pd == d && walk_order3(pe) < walk_order3(e))) {
        d = pd;
        e = pe;
      }
    }
    const int px = tx * kTile + (o & (kTile - 1));
    const int py = ty * kTile + (o >> 5);
    if (px < width && py < height) {
      const long long out = static_cast<long long>(py) * width + px;
      depth_out[out] = d;
      ent_out[out] = e;
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the first failed launch
// (0 = success).  table (P+1, 16) f32 with row P all zero, 16-byte
// aligned; order (>= starts[-1]) i32 sorted prim ids; starts (span^2 T +
// 1) i32 range bounds of a binning at `span` (2, 4 or 8); big_ids (>=
// *big_n, big_cap slots) i32; big_n one i32 on the device; zmeta null, or
// (3) f32 (zmin, s, thr_scale) of an exit binning at span 2 (the z-bucket
// early exit); front, with zmeta, (T, 1024) i32 scratch (the plan
// resets it); walked null or (T) i32, the binned rows each tile
// evaluated; depth (H, W) f32; index (H, W) i32; plan (T + max_items +
// 3) i32 and partial (max_items, 2, 1024) f32 scratch;
// bin_triangles != 0 evaluates the binned rows through the dual; a tile
// of more than split_rows rows is cut into items (max_items >= T in all).
extern "C" int csr6_raster(const float* table, const int* order,
                           const int* starts, const int* big_ids,
                           const int* big_n, const float* zmeta, int* front,
                           int* walked, float* depth, int* index, int* plan,
                           float* partial, int big_cap, int width,
                           int height, int tiles_x, int tiles_y,
                           int bin_triangles, int span, int split_rows,
                           int max_items, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bin_triangles)
    return launch_split_walk<kRows16Tri>(
        table, nullptr, order, starts, big_ids, big_n, big_cap, zmeta,
        walked, depth, index, plan, partial, front, width, height, tiles_x,
        tiles_y, span, split_rows, max_items, st);
  return launch_split_walk<kRows16>(
      table, nullptr, order, starts, big_ids, big_n, big_cap, zmeta, walked,
      depth, index, plan, partial, front, width, height, tiles_x, tiles_y,
      span, split_rows, max_items, st);
}

// The cap_rows10 walk (no exit).  table10 (P+1, 10) f32 with row P all
// zero, 8-byte aligned; big_rows (big_cap, 16) f32, 16-byte aligned, the
// first *big_n rows live; the rest as csr6_raster's.
extern "C" int csr6_cap10(const float* table10, const float* big_rows,
                          const int* order, const int* starts,
                          const int* big_n, int* walked, float* depth,
                          int* index, int* plan, float* partial, int big_cap,
                          int width, int height, int tiles_x, int tiles_y,
                          int span, int split_rows, int max_items,
                          void* stream) {
  return launch_split_walk<kRows10>(
      table10, big_rows, order, starts, nullptr, big_n, big_cap, nullptr,
      walked, depth, index, plan, partial, nullptr, width, height, tiles_x,
      tiles_y, span, split_rows, max_items,
      static_cast<cudaStream_t>(stream));
}

// The v3 walk (split, culled).  rows8 (>= starts[T], 8) f32
// entry-indexed rows, 16-byte aligned; big_rows (big_cap, 16) f32 in rank
// order, 16-byte aligned, the first *big_n rows live; starts (T+1) i32
// per-tile runs; zmeta (3) f32 (zmin, s, thr_scale); front, with
// allow_exit, (T, 1024) i32 scratch (the plan resets it); walked null or
// (T) i32, each tile's count of entries evaluated before its exit; bands
// null or (T) i32 zeroed, the (entry, warp band) pairs each tile
// evaluated; depth (H, W) f32; ent (H, W) i32 winning entries (-(rank +
// 2) for big winners, INT32_MAX where empty); plan (T + 3 max_items + 3)
// i32 and partial (max_items, 2, 1024) f32 scratch; allow_exit != 0 turns
// the z-bucket early exit on, checked after every `block` entries
// (1..1024); a tile of more than split_rows rows is cut into items
// (max_items >= T in all).
extern "C" int csr3_raster(const float* rows8, const float* big_rows,
                           const int* starts, const int* big_n,
                           const float* zmeta, int* front, int* walked,
                           int* bands, float* depth, int* ent, int* plan,
                           float* partial, int big_cap, int width,
                           int height, int tiles_x, int tiles_y,
                           int allow_exit, int block, int split_rows,
                           int max_items, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (block < 1 || block > kMaxBlock3 || split_rows < 1 ||
      max_items < num_tiles || (allow_exit && !front))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_plan_kernel<StripRows><<<1, kPlanThreads, 0, st>>>(
      StripRows{starts, 1}, big_n, big_cap, num_tiles, split_rows,
      max_items, plan, walked, num_tiles, allow_exit ? front : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int ctas = persistent_ctas(csr3_walk_kernel, kRingBytes);
  csr3_walk_kernel<<<min(ctas, max_items), kThreads, kRingBytes, st>>>(
      rows8, big_rows, starts, big_n, big_cap, zmeta, plan, partial, depth,
      ent, walked, bands, front, width, height, tiles_x, num_tiles,
      max_items, allow_exit, block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr3_merge_kernel<<<num_tiles, kThreads, 0, st>>>(plan, partial, depth,
                                                    ent, width, height,
                                                    tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The v4 walk (split).  table (P+1, 16) f32 with row P all zero, 16-byte
// aligned; entries (>= starts[T]) i32 prim ids in (tile, z-bucket) key
// order; starts (T+1) i32 per-tile entry runs; big_ids (big_cap) i32, the
// first min(*big_n, big_cap) live; big_n one i32 on the device; zmeta (3)
// f32 (zmin, s, thr_scale); front, with zq_bits > 0, (T, 1024) i32
// scratch (the plan resets it); walked null or (T) i32, each tile's count
// of entries evaluated before its exit (the plan zeroes it); depth (H, W)
// f32; index (H, W) i32; plan (T + 3 max_items + 3) i32 and partial
// (max_items, 2, 1024) f32 scratch.  zq_bits > 0 turns the z-bucket early
// exit on; bin_triangles != 0 evaluates the entries through the dual; a
// tile of more than split_rows rows is cut into items (max_items >= T in
// all).
extern "C" int csr4_raster(const float* table, const int* entries,
                           const int* starts, const int* big_ids,
                           const int* big_n, const float* zmeta, int* front,
                           int* walked, float* depth, int* index, int* plan,
                           float* partial, int big_cap, int width,
                           int height, int tiles_x, int tiles_y, int zq_bits,
                           int bin_triangles, int split_rows, int max_items,
                           void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  const int exit_on = zq_bits > 0;
  if (split_rows < 1 || max_items < num_tiles || (exit_on && !front))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (bin_triangles ? walk4<true> : walk4<false>)(
      table, entries, starts, big_ids, big_n, big_cap, zmeta, front, walked,
      depth, index, plan, partial, width, height, tiles_x, num_tiles,
      exit_on, split_rows, max_items, st);
}

// The discs_only walk (split, culled).  rows8 (>= starts[-1], 8) f32 disc
// rows in sorted order (row i = sorted position i), 16-byte aligned;
// big_rows (big_cap, 16) f32, 16-byte aligned, the first *big_n rows
// live; starts, big_n and span as csr6_raster's; zmeta null, or (3) f32
// of an exit binning at span 2, with front (T, 1024) i32 scratch; walked
// null or (T) i32, the binned rows each tile evaluated; bands null or (T)
// i32 zeroed, the (binned row, warp band) pairs each tile evaluated;
// depth (H, W) f32; index (H, W) i32; plan (T + 3 max_items + 3) i32 and
// partial (max_items, 2, 1024) f32 scratch; split_rows and max_items as
// csr6_raster's.
extern "C" int csr6_disc8(const float* rows8, const float* big_rows,
                          const int* starts, const int* big_n,
                          const float* zmeta, int* front, int* walked,
                          int* bands, float* depth, int* index, int* plan,
                          float* partial, int big_cap, int width, int height,
                          int tiles_x, int tiles_y, int span, int split_rows,
                          int max_items, void* stream) {
  return disc_walk<false>(rows8, big_rows, starts, big_n, big_cap, zmeta,
                          front, walked, bands, depth, index, nullptr,
                          nullptr, plan, partial, width, height, tiles_x,
                          tiles_y, span, split_rows, max_items,
                          static_cast<cudaStream_t>(stream));
}

// csr6_disc8 (no exit) that also writes the winner's lambert (u, v)
// images (H, W) f32: +inf where empty or where the winner is no disc;
// partial (max_items, 4, 1024) f32.
extern "C" int csr6_disc8_uv(const float* rows8, const float* big_rows,
                             const int* starts, const int* big_n,
                             int* walked, int* bands, float* depth,
                             int* index, float* u, float* v, int* plan,
                             float* partial, int big_cap, int width,
                             int height, int tiles_x, int tiles_y, int span,
                             int split_rows, int max_items, void* stream) {
  return disc_walk<true>(rows8, big_rows, starts, big_n, big_cap, nullptr,
                         nullptr, walked, bands, depth, index, u, v, plan,
                         partial, width, height, tiles_x, tiles_y, span,
                         split_rows, max_items,
                         static_cast<cudaStream_t>(stream));
}

// The kind-split walk (rows9, rows8).  rows9 (P, 9) f32 in sorted order
// (row i = sorted position i), 4-byte aligned; big_rows (big_cap, 16)
// f32, 16-byte aligned, the first *big_n rows live; starts (2 * span^2 *
// T + 1) i32 range bounds of a kind-split binning at `span` (2, 4 or 8);
// depth (H, W) f32; index (H, W) i32; plan, partial, split_rows and
// max_items as csr6_raster's.
extern "C" int csr6_rows9(const float* rows9, const float* big_rows,
                          const int* starts, const int* big_n, float* depth,
                          int* index, int* plan, float* partial, int big_cap,
                          int width, int height, int tiles_x, int tiles_y,
                          int span, int split_rows, int max_items,
                          void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if ((span != 2 && span != 4 && span != 8) || split_rows < 1 ||
      max_items < num_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_plan_kernel<TileRows><<<1, kPlanThreads, 0, st>>>(
      TileRows{starts, tiles_x, num_tiles, span, 0, 2}, big_n, big_cap,
      num_tiles, split_rows, max_items, plan, nullptr, 0, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int ctas = persistent_ctas(csr6_rows9_walk_kernel, kRingBytes);
  csr6_rows9_walk_kernel<<<min(ctas, max_items), kThreads, kRingBytes, st>>>(
      rows9, big_rows, starts, big_n, big_cap, plan, partial, depth, index,
      width, height, tiles_x, num_tiles, span, max_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  csr6_merge_kernel<false><<<num_tiles, kThreads, 0, st>>>(
      plan, partial, depth, index, nullptr, nullptr, width, height, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csr6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
