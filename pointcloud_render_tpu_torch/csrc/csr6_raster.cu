// v6 tile rasterizers for Hopper (sm_90a): one CTA per 32x32 pixel tile.
// Four kernels share the walk: csr6_raster (16-float binned rows),
// csr6_disc8 (8-float disc rows), csr6_disc8_uv (disc rows, with the
// winner's lambert plane coordinates carried through the merge) and
// csr6_rows9 (kind-split 9-float disc and capsule rows, any span).
//
// csr6_raster replaces three Pallas TPU pieces of
// pointcloud_render_tpu/raster:
//   * pallas_csr6._make_kernel6 / _make_tile_body — the per-tile walk over
//     the tile's four merged CSR ranges of the anchor-sorted soup: its own
//     anchor (classes 0..3), the left neighbour's x-spill classes {1, 2},
//     the up neighbour's y-spill classes {2, 3} and the diagonal's "both"
//     class {2}, guarded at tx >= 1 / ty >= 1;
//   * pallas_csr4._make_row_body16 — the 16-float row evaluation: the
//     capsule (a disc is a zero-axis capsule) and the triangle dual, in
//     the exact expression order of the JAX code;
//   * pallas_csr4._stream_big and the resident big-list branch of
//     _make_tile_body — every tile merges every big-list row through the
//     triangle-aware evaluation.
//
// csr6_disc8 replaces pallas_csr6._make_row_body8 (the discs_only walk:
// binned rows are [px, py, z, r*r, idf, flag, 0, 0], covered where
// dx*dx + dy*dy <= r*r) and csr6_disc8_uv replaces
// pallas_csr6._make_row_body8_uv with _make_big_body16_uv: the same walk,
// every pixel also keeping u = dx * flag and v = -dy * flag of its
// winning pair (flag = 1/r; lane 5 of a disc row, lane 13 of a big row),
// +inf when the winner is a triangle or a capsule.  u and v change under
// the very predicate that changes depth and id, so they are a function
// of the winning pair alone and the walk order cannot show.  Both reuse
// the big-list phase below over a dense array of 16-float big rows.
//
// csr6_rows9 replaces pallas_csr6._make_row_body9d / _make_row_body9c
// (the rows9 mode; rows8's _make_row_body8d / _make_row_body8c evaluate
// the same float32 expressions and route here too) inside the v6 walk
// at span 2, 4 or 8.  The binning is kind-split: every disc's key sorts
// before every capsule's, so a tile has a disc range set and a capsule
// range set.  Rows are 9 floats in sorted order, disc
// [px, py, z, r*r, idf, 0, 0, 0, 0] through the exact disc body, capsule
// [x0, y0, ux, -rho0, uy, rhod, z0, sdz, idf] through the renormalized
// segment-frame body (ux = sdx*il2, rho = r*sqrt(il2)).  At span 2 each
// set is the four merged ranges above; at span 4 and 8 it is the tile's
// own anchor range plus, per neighbour (dx, dy), the classes reaching
// this tile: one range per class row cy >= dy of the row-major ordinals
// cy*span + cx with cx >= dx (one range when dx = 0), 34 per set at span
// 4.  A CTA sizes its ranges in parallel (one per thread), scans their
// lengths, and stages rows across range boundaries in chunks of 512, so
// empty and tiny ranges cost no synchronisation.  Big rows (wide discs,
// wide capsules, the ground) keep the exact 16-float evaluation.
//
// Winner per pixel = lexicographic min of (depth, primitive id) with
// strict compares, so the walk order does not matter.  Exactness needs
// IEEE float32 per operation: build with -fmad=false (no multiply-add
// contraction) and without --use_fast_math (correctly rounded 1/iz).
//
// What bounds it on an H100: per-pair arithmetic.  Every (row, pixel)
// pair of a 16-float row must execute 17 float32 operations in the
// capsule body and 18 in the triangle body (per-row and per-pixel-column
// terms such as dx and dx * sdx hoisted; the three merge compares and the
// depth they read, z0 + sdz * t or 1 / iz, are needed only at covered
// pairs), and a tile evaluates every row of its ranges at
// all 1024 pixels, so the work is 1024 x (binned entries) + pixels x (big
// rows) pairs; row bytes (64 B per row, read once per tile it touches)
// are small beside that.  Design: rows are staged through shared memory
// in chunks of 256 (one row per thread, gathered by sorted id), every
// thread keeps the (depth, id) minima of its 4 pixels in registers, and
// all threads read the same staged row (a shared-memory broadcast).  A
// disc pair must execute 4 operations (dy, dy * dy, + dx * dx, <= r * r;
// dx and dx * dx are per row and thread, not per pixel) and a disc row is
// 32 B, staged 512 at a time.  A rows9 capsule pair must execute 16 (dy,
// a and g (2 each, with dx * ux and dx * uy per column), the clip (2),
// a - t, d2 (3), rad (2), d2 <= rad * rad (2), rad > 0; its depth z is
// read only at covered pairs).
// Not done yet: the z-bucket early exit, load balancing of dense tiles,
// and asynchronous (TMA / cp.async) staging.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kPix = kTile * kTile / kThreads;  // pixels per thread
constexpr int kChunk = 256;                      // rows per staged chunk
constexpr int kRowF = 16;
constexpr float kEmpty = 16777216.0f;           // 2^24 > every prim id

// jnp.clip / torch.clamp semantics: NaN propagates.
__device__ __forceinline__ float clip01(float v) {
  const float t = v < 0.0f ? 0.0f : v;
  return t > 1.0f ? 1.0f : t;
}

// Stage table row `id` into shared slot `slot` (4 x float4).
__device__ __forceinline__ void stage_row(float4* sh, int slot,
                                          const float* __restrict__ table,
                                          int id) {
  const float4* src = reinterpret_cast<const float4*>(table) +
                      static_cast<long long>(id) * (kRowF / 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) sh[slot * 4 + j] = src[j];
}

// Evaluate staged rows [0, count) at this thread's pixels.  kTri selects
// the dual (triangle-aware) body used for the big list; binned rows are
// discs/capsules and take the capsule body alone, as on the TPU.  kUV
// also keeps the winner's (u, v): a big-list disc (no triangle, lane 13
// > 0) gives dx * flag and -dy * flag, any other row +inf.
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
    const float x0 = a.x, y0 = a.y, z0 = a.z, r0 = a.w;
    const float sdx = b.x, sdy = b.y, sdz = b.z, sdr = b.w;
    const float il2 = c.x, idf = c.y;
    // The row's kind is the same for every thread (a broadcast row), so
    // the branch does not diverge: a big-list capsule skips the triangle
    // body and its division.
    const bool is_tri = kTri && e.w > 0.0f;
    const bool is_disc = !is_tri && e.y > 0.0f;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      float z, uc = inf, vc = inf;
      bool cov;
      if (is_tri) {
        const float e0 = x0 * qy[k] - y0 * qx + z0;
        const float e1 = r0 * qy[k] - sdx * qx + sdy;
        const float e2 = sdz * qy[k] - sdr * qx + il2;
        const float iz = e0 * c.z + e1 * c.w + e2 * e.x;
        cov = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) & (iz > 0.0f);
        z = 1.0f / (iz > 0.0f ? iz : 1.0f);
      } else {
        const float dx = qx - x0;
        const float dy = qy[k] - y0;
        const float t = clip01((dx * sdx + dy * sdy) * il2);
        const float cx = dx - t * sdx;
        const float cy = dy - t * sdy;
        const float rad = r0 + sdr * t;
        z = z0 + sdz * t;
        cov = cx * cx + cy * cy <= rad * rad;
        if (kUV && is_disc) {
          uc = dx * e.y;
          vc = -dy * e.y;
        }
      }
      if (cov && ((z < d[k]) || ((z == d[k]) && (idf < di[k])))) {
        d[k] = z;
        di[k] = idf;
        if (kUV) {
          u[k] = uc;
          v[k] = vc;
        }
      }
    }
  }
}

// Evaluate staged 8-float disc rows [0, count) (2 x float4 each) at this
// thread's pixels: pallas_csr6._make_row_body8 / _make_row_body8_uv.
template <bool kUV>
__device__ __forceinline__ void eval_disc_rows(const float4* sh, int count,
                                               float qx, const float* qy,
                                               float* d, float* di, float* u,
                                               float* v) {
  for (int r = 0; r < count; ++r) {
    const float4 a = sh[r * 2 + 0];  // px, py, z, r*r
    const float4 b = sh[r * 2 + 1];  // idf, flag (1/r), 0, 0
    const float z = a.z, r2 = a.w, idf = b.x;
    const float dx = qx - a.x;
    const float dx2 = dx * dx;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float dy = qy[k] - a.y;
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

constexpr int kRowF9 = 9;
constexpr int kChunk9 = 512;     // 9-float rows per staged chunk (18 KB)
constexpr int kMaxRanges = 512;  // range slots: span^3 at span 8

// Evaluate staged 9-float rows [0, count) at this thread's pixels:
// kCap the renormalized capsule body (pallas_csr6._make_row_body9c),
// else the exact disc body (_make_row_body9d).
template <bool kCap>
__device__ __forceinline__ void eval_rows9(const float* sh, int count,
                                           float qx, const float* qy,
                                           float* d, float* di) {
  for (int r = 0; r < count; ++r) {
    const float* row = sh + r * kRowF9;
    if (kCap) {
      const float x0 = row[0], y0 = row[1], ux = row[2], nr0 = row[3];
      const float uy = row[4], rhod = row[5], z0 = row[6], sdz = row[7];
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
      const float z = row[2], r2 = row[3], idf = row[4];
      const float dx = qx - row[0];
      const float dx2 = dx * dx;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const float dy = qy[k] - row[1];
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

// Range slot q of tile (tx, ty) in the ordinal region starting at `reg`
// -> (first sorted position, length); length 0 for slots that name no
// range or a neighbour off the grid.  Span 2: the four merged ranges of
// csr6_tile_kernel.  Wider spans: slot q = (cy * span + dy) * span + dx
// names neighbour (dx, dy)'s classes in class row cy with cx >= dx; for
// dx = 0 the slot cy = dy takes every class row from dy on at once.
__device__ __forceinline__ void tile_range(int q, int span, int tile, int tx,
                                           int ty, int tiles_x, int reg,
                                           const int* __restrict__ starts,
                                           int* s_out, int* n_out) {
  int dx, dy, lo, hi;
  bool named = true;
  if (span == 2) {
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

__global__ void __launch_bounds__(kThreads)
csr6_rows9_kernel(const float* __restrict__ rows9,
                  const float* __restrict__ big_rows,
                  const int* __restrict__ starts,
                  const int* __restrict__ big_n_ptr, int big_cap,
                  float* __restrict__ depth_out, int* __restrict__ index_out,
                  int width, int height, int tiles_x, int num_tiles,
                  int span) {
  // Staged rows: 512 x 9 floats, or 256 x 16 for the big list.
  __shared__ __align__(16) float sh[kChunk9 * kRowF9];
  __shared__ int range_start[kMaxRanges];
  __shared__ int range_cum[kMaxRanges];  // exclusive prefix of lengths
  __shared__ int warp_tot[kThreads / 32];
  float4* sh4 = reinterpret_cast<float4*>(sh);
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lx = tid & (kTile - 1);
  const int ly = tid >> 5;

  const float qx = static_cast<float>(tx * kTile + lx) + 0.5f;
  float qy[kPix], d[kPix], di[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qy[k] = static_cast<float>(ty * kTile + ly + 8 * k) + 0.5f;
    d[k] = __int_as_float(0x7f800000);  // +inf
    di[k] = kEmpty;
  }

  // Big list: wide discs and capsules and the ground, exact 16-float rows.
  const int big_n = min(*big_n_ptr, big_cap);
  for (int base = 0; base < big_n; base += kChunk) {
    const int cnt = min(kChunk, big_n - base);
    __syncthreads();
    if (tid < cnt) stage_row(sh4, tid, big_rows, base + tid);
    __syncthreads();
    eval_rows<true, false>(sh4, cnt, qx, qy, d, di, nullptr, nullptr);
  }

  const int k2 = span * span;
  const int n_slots = span == 2 ? 4 : k2 * span;
#pragma unroll 1
  for (int kind = 0; kind < 2; ++kind) {
    // Size this kind's ranges: slots 2*tid and 2*tid + 1.
    const int reg = kind * k2 * num_tiles;
    int len[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * tid + h;
      int s = 0;
      len[h] = 0;
      if (q < n_slots)
        tile_range(q, span, tile, tx, ty, tiles_x, reg, starts, &s, &len[h]);
      range_start[q] = s;
    }
    // Block-wide exclusive scan of the lengths.
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

    for (int base = 0; base < total; base += kChunk9) {
      const int cnt = min(kChunk9, total - base);
      __syncthreads();
      for (int i = tid; i < cnt; i += kThreads) {
        // The last range whose prefix is <= f holds flat row f (empty
        // ranges share their prefix with the next one).
        const int f = base + i;
        int lo = 0, hi = n_slots;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (range_cum[mid] <= f) lo = mid + 1; else hi = mid;
        }
        const int r = lo - 1;
        const float* src =
            rows9 + static_cast<long long>(range_start[r] + f - range_cum[r]) *
                        kRowF9;
#pragma unroll
        for (int j = 0; j < kRowF9; ++j) sh[i * kRowF9 + j] = src[j];
      }
      __syncthreads();
      if (kind == 0)
        eval_rows9<false>(sh, cnt, qx, qy, d, di);
      else
        eval_rows9<true>(sh, cnt, qx, qy, d, di);
    }
  }

  const int px = tx * kTile + lx;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int py = ty * kTile + ly + 8 * k;
    if (px < width && py < height) {
      const long long o = static_cast<long long>(py) * width + px;
      depth_out[o] = d[k];
      index_out[o] = isinf(d[k]) ? -1 : static_cast<int>(di[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
csr6_tile_kernel(const float* __restrict__ table, const int* __restrict__ order,
                 const int* __restrict__ starts,
                 const int* __restrict__ big_ids,
                 const int* __restrict__ big_n_ptr,
                 float* __restrict__ depth_out, int* __restrict__ index_out,
                 int width, int height, int tiles_x) {
  __shared__ float4 sh[kChunk * 4];
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tid = threadIdx.x;
  const int lx = tid & (kTile - 1);
  const int ly = tid >> 5;

  const float qx = static_cast<float>(tx * kTile + lx) + 0.5f;
  float qy[kPix], d[kPix], di[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qy[k] = static_cast<float>(ty * kTile + ly + 8 * k) + 0.5f;
    d[k] = __int_as_float(0x7f800000);  // +inf
    di[k] = kEmpty;
  }

  // Big list: wide prims and the ground, merged at every tile.
  const int big_n = *big_n_ptr;
  for (int base = 0; base < big_n; base += kChunk) {
    const int cnt = min(kChunk, big_n - base);
    __syncthreads();
    if (tid < cnt) stage_row(sh, tid, table, big_ids[base + tid]);
    __syncthreads();
    eval_rows<true, false>(sh, cnt, qx, qy, d, di, nullptr, nullptr);
  }

  // The four merged CSR ranges of the anchor-sorted order (span 2,
  // class ordinals 0 = none, 1 = x-spill, 2 = both, 3 = y-spill).
  const bool left = tx >= 1, up = ty >= 1;
  const int anchors[4] = {tile, tile - 1, tile - tiles_x, tile - tiles_x - 1};
  const int lo[4] = {0, 1, 2, 2};
  const int hi[4] = {4, 3, 4, 3};
  const bool ok[4] = {true, left, up, left && up};
#pragma unroll 1
  for (int g = 0; g < 4; ++g) {
    if (!ok[g]) continue;
    const int a = anchors[g];
    const int s = starts[4 * a + lo[g]];
    const int n = starts[4 * a + hi[g]] - s;
    for (int base = 0; base < n; base += kChunk) {
      const int cnt = min(kChunk, n - base);
      __syncthreads();
      if (tid < cnt) stage_row(sh, tid, table, order[s + base + tid]);
      __syncthreads();
      eval_rows<false, false>(sh, cnt, qx, qy, d, di, nullptr, nullptr);
    }
  }

  const int px = tx * kTile + lx;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int py = ty * kTile + ly + 8 * k;
    if (px < width && py < height) {
      const long long o = static_cast<long long>(py) * width + px;
      depth_out[o] = d[k];
      index_out[o] = isinf(d[k]) ? -1 : static_cast<int>(di[k]);
    }
  }
}

// The discs_only walk: the big list is the dense (big_cap, 16) array
// big_rows (its first *big_n rows live), binned rows are 8-float rows of
// table8 gathered by sorted id.  kUV also writes the winner's (u, v).
template <bool kUV>
__global__ void __launch_bounds__(kThreads)
csr6_disc_kernel(const float* __restrict__ table8,
                 const float* __restrict__ big_rows,
                 const int* __restrict__ order, const int* __restrict__ starts,
                 const int* __restrict__ big_n_ptr, int big_cap,
                 float* __restrict__ depth_out, int* __restrict__ index_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 int width, int height, int tiles_x) {
  __shared__ float4 sh[kChunk * 4];
  constexpr int kDiscChunk = kChunk * 2;  // 2 x float4 per disc row
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int tid = threadIdx.x;
  const int lx = tid & (kTile - 1);
  const int ly = tid >> 5;
  const float inf = __int_as_float(0x7f800000);

  const float qx = static_cast<float>(tx * kTile + lx) + 0.5f;
  float qy[kPix], d[kPix], di[kPix], u[kPix], v[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    qy[k] = static_cast<float>(ty * kTile + ly + 8 * k) + 0.5f;
    d[k] = inf;
    di[k] = kEmpty;
    u[k] = inf;
    v[k] = inf;
  }

  // Big list: the ground, capsules and wide discs, merged at every tile.
  const int big_n = min(*big_n_ptr, big_cap);
  for (int base = 0; base < big_n; base += kChunk) {
    const int cnt = min(kChunk, big_n - base);
    __syncthreads();
    if (tid < cnt) stage_row(sh, tid, big_rows, base + tid);
    __syncthreads();
    eval_rows<true, kUV>(sh, cnt, qx, qy, d, di, u, v);
  }

  // The four merged CSR ranges, as in csr6_tile_kernel.
  const bool left = tx >= 1, up = ty >= 1;
  const int anchors[4] = {tile, tile - 1, tile - tiles_x, tile - tiles_x - 1};
  const int lo[4] = {0, 1, 2, 2};
  const int hi[4] = {4, 3, 4, 3};
  const bool ok[4] = {true, left, up, left && up};
  const float4* rows8 = reinterpret_cast<const float4*>(table8);
#pragma unroll 1
  for (int g = 0; g < 4; ++g) {
    if (!ok[g]) continue;
    const int a = anchors[g];
    const int s = starts[4 * a + lo[g]];
    const int n = starts[4 * a + hi[g]] - s;
    for (int base = 0; base < n; base += kDiscChunk) {
      const int cnt = min(kDiscChunk, n - base);
      __syncthreads();
      for (int i = tid; i < cnt; i += kThreads) {
        const float4* src =
            rows8 + static_cast<long long>(order[s + base + i]) * 2;
        sh[i * 2 + 0] = src[0];
        sh[i * 2 + 1] = src[1];
      }
      __syncthreads();
      eval_disc_rows<kUV>(sh, cnt, qx, qy, d, di, u, v);
    }
  }

  const int px = tx * kTile + lx;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int py = ty * kTile + ly + 8 * k;
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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// table (P+1, 16) f32 with row P all zero; order (>= starts[4T]) i32 sorted
// prim ids; starts (4T+1) i32 range bounds; big_ids (>= *big_n) i32;
// big_n one i32 on the device; depth (H, W) f32; index (H, W) i32.
extern "C" int csr6_raster(const float* table, const int* order,
                           const int* starts, const int* big_ids,
                           const int* big_n, float* depth, int* index,
                           int width, int height, int tiles_x, int tiles_y,
                           void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles <= 0) return 0;
  csr6_tile_kernel<<<num_tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, order, starts, big_ids, big_n, depth, index, width, height,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The discs_only walk.  table8 (P+1, 8) f32 with row P all zero; big_rows
// (big_cap, 16) f32, the first *big_n rows live; order, starts, big_n as
// above; depth (H, W) f32; index (H, W) i32.
extern "C" int csr6_disc8(const float* table8, const float* big_rows,
                          const int* order, const int* starts,
                          const int* big_n, float* depth, int* index,
                          int big_cap, int width, int height, int tiles_x,
                          int tiles_y, void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles <= 0) return 0;
  csr6_disc_kernel<false><<<num_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table8, big_rows, order, starts, big_n, big_cap, depth, index, nullptr,
      nullptr, width, height, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// csr6_disc8 that also writes the winner's lambert (u, v) images (H, W)
// f32: +inf where empty or where the winner is no disc.
extern "C" int csr6_disc8_uv(const float* table8, const float* big_rows,
                             const int* order, const int* starts,
                             const int* big_n, float* depth, int* index,
                             float* u, float* v, int big_cap, int width,
                             int height, int tiles_x, int tiles_y,
                             void* stream) {
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles <= 0) return 0;
  csr6_disc_kernel<true><<<num_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table8, big_rows, order, starts, big_n, big_cap, depth, index, u, v,
      width, height, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The kind-split walk (rows9, rows8).  rows9 (P, 9) f32 in sorted order
// (row i = sorted position i); big_rows (big_cap, 16) f32, the first
// *big_n rows live; starts (2 * span^2 * T + 1) i32 range bounds of a
// kind-split binning at `span` (2, 4 or 8); depth (H, W) f32; index (H, W)
// i32.
extern "C" int csr6_rows9(const float* rows9, const float* big_rows,
                          const int* starts, const int* big_n, float* depth,
                          int* index, int big_cap, int width, int height,
                          int tiles_x, int tiles_y, int span, void* stream) {
  if (span != 2 && span != 4 && span != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = tiles_x * tiles_y;
  if (num_tiles <= 0) return 0;
  csr6_rows9_kernel<<<num_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rows9, big_rows, starts, big_n, big_cap, depth, index, width, height,
      tiles_x, num_tiles, span);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csr6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
