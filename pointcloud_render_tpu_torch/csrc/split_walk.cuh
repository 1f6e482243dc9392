// Pieces shared by the port's split walks (csr6_raster.cu: csr6_raster,
// csr6_cap10, csr6_rows9, csr6_disc8, csr6_disc8_uv; csr2_raster.cu:
// csr2_raster).  A split walk
// runs in three launches:
//   (1) split_plan_kernel sizes every unit of pixels (a 32x32 tile, or a
//       1024-pixel pass of a strip) in rows, its live big rows included,
//       and cuts a unit of more than split_rows rows into work items,
//       contiguous slices of those rows;
//   (2) a walk kernel of persistent CTAs takes the items in order from an
//       atomic counter (next_item), stages each item's rows through a ring
//       of shared-memory slots (cp.async, or Hopper's bulk copy completed
//       on an mbarrier where the rows sit in sorted order) and keeps the
//       (depth, id) minima of its unit's pixels in registers;
//   (3) a merge kernel folds a split unit's per-item minima
//       (fold_partials) with merge_pair, the walk's own strict compare, so
//       the image does not depend on the split or on the item order.
// Walks with an early exit share a split unit's depths through `front`
// (depth_key ints, atomicMin), which the plan resets, and decide the exit
// with exit_step and exit_past.
#pragma once

#include <cuda_runtime.h>

#include "raster_pairs.cuh"  // merge_pair

namespace {

constexpr int kWalkThreads = 256;          // threads of a walk CTA
constexpr int kUnitPix = 1024;             // pixels of a unit
constexpr int kUnitPixPerThread = kUnitPix / kWalkThreads;
constexpr int kPlanThreads = 1024;

// ---- asynchronous copies into shared memory ------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Hopper's bulk copy (the TMA unit's one-dimensional form): one thread
// moves `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory and the copy completes on an mbarrier that
// expects that many bytes (bulk_load: one copy, one arrival; a chunk of
// several copies arrives once for all their bytes, mbar_arrive_expect,
// before its bulk_copy calls).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make initialised mbarriers visible to the async proxy (then a barrier).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` and raise the bytes its phase waits for by `bytes`.
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy completing on `bar`, whose phase already expects its
// bytes (mbar_arrive_expect).
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          int bytes,
                                          unsigned long long* bar) {
  mbar_arrive_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---- depths shared by a split unit's items --------------------------------

// Depths as ints whose order is the floats' (atomicMin of depths).
__device__ __forceinline__ int depth_key(float z) {
  const int i = __float_as_int(z);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_depth(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// ---- the plan, the item counter and the merge -----------------------------

// plan = [items_cum (U) | item_unit (max_items) | n_items, the next
// ticket to hand out, w | with `waves`: ticket_item (max_items), scratch
// (max_items)]: U units, each cut into n_u = max(1, ceil(rows_u / w))
// items with w = max(split_rows, ceil(rows / (max_items - U))), so that
// no call takes more than max_items items; items_cum is their inclusive
// prefix, and a unit's items are consecutive ids.  rows_of(u) is the
// unit's binned rows; every unit also walks the min(*big_n_ptr, big_cap)
// big rows.  Without `waves` ticket t of the item counter is item t;
// with it, ticket_item hands the items out in waves: every unit's first
// item, then every unit's second, and so on (the order within a wave is
// not fixed), so that a split unit's items start roughly front to back.
// walked (null or n_walked ints) is zeroed.  front (null, or (U,
// kUnitPix) ints of a walk with an exit) is reset to depth_key(+inf) for
// every split unit, the only ones whose items read it.  One CTA of
// kPlanThreads threads.
template <class RowsOf>
__global__ void __launch_bounds__(kPlanThreads)
split_plan_kernel(RowsOf rows_of, const int* __restrict__ big_n_ptr,
                  int big_cap, int num_units, int split_rows, int max_items,
                  int* __restrict__ plan, int* __restrict__ walked,
                  int n_walked, int* __restrict__ front, int waves = 0) {
  __shared__ long long warp_sum[kPlanThreads / 32];
  __shared__ int warp_cnt[kPlanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (num_units + kPlanThreads - 1) / kPlanThreads;
  const int t0 = min(tid * per, num_units);
  const int t1 = min(t0 + per, num_units);
  const int big_n = min(*big_n_ptr, big_cap);
  int* items_cum = plan;
  int* item_unit = plan + num_units;
  int* sched = plan + num_units + max_items;
  if (walked != nullptr)
    for (int t = tid; t < n_walked; t += kPlanThreads) walked[t] = 0;

  long long mine = 0;
  for (int t = t0; t < t1; ++t) {
    const int rows = big_n + rows_of(t);
    items_cum[t] = rows;  // replaced by the prefix below
    mine += rows;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if (lane == 0) warp_sum[warp] = mine;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kPlanThreads / 32; ++w) total += warp_sum[w];
  const long long room = max(max_items - num_units, 1);
  const long long w_rows =
      max(static_cast<long long>(split_rows), (total + room - 1) / room);

  int cnt = 0;
  for (int t = t0; t < t1; ++t)
    cnt += max(1, static_cast<int>((items_cum[t] + w_rows - 1) / w_rows));
  int v = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_cnt[warp] = v;
  __syncthreads();
  int base = v - cnt;
  for (int w = 0; w < warp; ++w) base += warp_cnt[w];
  for (int t = t0; t < t1; ++t) {
    const int n = max(1, static_cast<int>((items_cum[t] + w_rows - 1) /
                                          w_rows));
    for (int j = 0; j < n; ++j) item_unit[base + j] = t;
    base += n;
    items_cum[t] = base;
  }
  if (tid == kPlanThreads - 1) {
    sched[0] = base;  // items of the call
    sched[1] = 0;     // the next ticket to hand out
    sched[2] = static_cast<int>(w_rows);
  }
  if (front != nullptr) {
    // A warp tests 32 units at a time and resets the split ones together.
    __syncthreads();  // items_cum is final
    const int inf_key = depth_key(__int_as_float(0x7f800000));
    const int4 fill = make_int4(inf_key, inf_key, inf_key, inf_key);
    for (int t0w = warp * 32; t0w < num_units; t0w += kPlanThreads) {
      const int t = t0w + lane;
      const bool split =
          t < num_units && items_cum[t] - (t > 0 ? items_cum[t - 1] : 0) > 1;
      unsigned mask = __ballot_sync(0xffffffffu, split);
      while (mask) {
        const int u = t0w + __ffs(mask) - 1;
        mask &= mask - 1;
        int4* f = reinterpret_cast<int4*>(front +
                                          static_cast<long long>(u) *
                                              kUnitPix);
        for (int i = lane; i < kUnitPix / 4; i += 32) f[i] = fill;
      }
    }
  }
  if (!waves) return;

  // The waves: wave j holds the units with more than j items.  Count
  // them, scan the counts into each wave's first ticket, then place every
  // item at the next ticket of its wave.
  int* ticket_item = sched + 3;
  int* wave = ticket_item + max_items;
  __syncthreads();  // items_cum and sched[0] are final
  const int n_items = sched[0];
  for (int j = tid; j < n_items; j += kPlanThreads) wave[j] = 0;
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const int n = items_cum[t] - (t > 0 ? items_cum[t - 1] : 0);
    for (int j = 0; j < n; ++j) atomicAdd(&wave[j], 1);
  }
  __syncthreads();
  int running = 0;  // the same in every thread
  for (int c = 0; c < n_items; c += kPlanThreads) {
    const int x = c + tid < n_items ? wave[c + tid] : 0;
    int y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    if (lane == 31) warp_cnt[warp] = y;
    __syncthreads();
    int off = running, tot = 0;
    for (int w = 0; w < kPlanThreads / 32; ++w) {
      off += w < warp ? warp_cnt[w] : 0;
      tot += warp_cnt[w];
    }
    if (c + tid < n_items) wave[c + tid] = off + y - x;
    running += tot;
    __syncthreads();
  }
  for (int t = t0; t < t1; ++t) {
    const int first = t > 0 ? items_cum[t - 1] : 0;
    const int n = items_cum[t] - first;
    for (int j = 0; j < n; ++j)
      ticket_item[atomicAdd(&wave[j], 1)] = first + j;
  }
}

// The next ticket of a persistent CTA's item counter (the same in every
// thread).  Starts with a barrier: the CTA's last item is done with its
// shared memory.
__device__ __forceinline__ int next_item(int* sched, int* s_item) {
  __syncthreads();
  if (threadIdx.x == 0) *s_item = atomicAdd(&sched[1], 1);
  __syncthreads();
  return *s_item;
}

// Item `item` of a unit whose items are [first, first + n): the slice
// [*lo, *hi) of the unit's `rows` flat rows.
__device__ __forceinline__ void item_slice(long long rows, int item,
                                           int first, int n, int* lo,
                                           int* hi) {
  *lo = static_cast<int>(rows * (item - first) / n);
  *hi = static_cast<int>(rows * (item - first + 1) / n);
}

// Fold the (depth, id) minima of items [first, first + n) of `partial`
// ((items, kPlanes, kUnitPix) floats) into this thread's pixels tid + 256
// k.  With kPlanes 4 the items also carry the winner's (u, v), which are
// taken where merge_pair takes the item's minimum (they change only under
// the predicate that changes depth and id).
template <int kPlanes = 2>
__device__ __forceinline__ void fold_partials(const float* __restrict__
                                                  partial,
                                              int first, int n, float* d,
                                              float* di, float* u = nullptr,
                                              float* v = nullptr) {
  for (int j = 0; j < n; ++j) {
    const float* p =
        partial + static_cast<long long>(first + j) * kPlanes * kUnitPix;
#pragma unroll
    for (int k = 0; k < kUnitPixPerThread; ++k) {
      const int o = threadIdx.x + kWalkThreads * k;
      const float d0 = d[k], di0 = di[k];
      merge_pair(true, p[o], p[kUnitPix + o], &d[k], &di[k]);
      // merge_pair took the item's minimum exactly when (d, di) changed:
      // a strictly smaller depth, or the same depth and a smaller id.
      if (kPlanes == 4 && (d[k] != d0 || di[k] != di0)) {
        u[k] = p[2 * kUnitPix + o];
        v[k] = p[3 * kUnitPix + o];
      }
    }
  }
}

// This thread's minima (and with kPlanes 4 its (u, v)) as item `item`'s
// partial; its pixel k is p0 + dp * k of the unit.
template <int kPlanes = 2>
__device__ __forceinline__ void write_partial(
    float* __restrict__ partial, int item, const float* d, const float* di,
    const float* u = nullptr, const float* v = nullptr,
    int p0 = threadIdx.x, int dp = kWalkThreads) {
  float* out = partial + static_cast<long long>(item) * kPlanes * kUnitPix;
#pragma unroll
  for (int k = 0; k < kUnitPixPerThread; ++k) {
    const int o = p0 + dp * k;
    out[o] = d[k];
    out[kUnitPix + o] = di[k];
    if (kPlanes == 4) {
      out[2 * kUnitPix + o] = u[k];
      out[3 * kUnitPix + o] = v[k];
    }
  }
}

// ---- the early exit --------------------------------------------------------

// Whether every pixel of the CTA lies nearer than `bound`, at this item's
// minimum d or at the depths the unit's other items shared (bound_d: +inf
// in a unit of one item, -inf off the image, so those pixels never hold
// the exit).  Strict: at equality a later row with a lower id could win.
// A barrier of the whole CTA.
__device__ __forceinline__ bool exit_past(const float* d,
                                          const float* bound_d,
                                          float bound) {
  bool past = true;
#pragma unroll
  for (int k = 0; k < kUnitPixPerThread; ++k)
    past = past && fminf(d[k], bound_d[k]) < bound;
  return __syncthreads_and(past) != 0;
}

// The step of a walk with an exit after a binned chunk: fold this
// thread's minima into the unit's shared depths (unit_front, null in a
// unit of one item; pixel k at p0 + dp * k, in-image ones only) and
// lower bound_d to the result, then, where rows past the chunk could be
// left (`goes_on`, the same in every thread), whether they may be:
// exit_past against `bound`, the least depth any of them can have.
__device__ __forceinline__ bool exit_step(int* unit_front, int p0, int dp,
                                          const bool* in_image,
                                          const float* d, float* bound_d,
                                          bool goes_on, float bound) {
  if (unit_front != nullptr) {
#pragma unroll
    for (int k = 0; k < kUnitPixPerThread; ++k) {
      if (!in_image[k]) continue;
      const int key = depth_key(d[k]);
      const int old = atomicMin(&unit_front[p0 + dp * k], key);
      bound_d[k] = key_depth(min(old, key));
    }
  }
  return goes_on && exit_past(d, bound_d, bound);
}

// One resident CTA per free slot of every SM: the grid of a persistent
// walk kernel.
template <class Kernel>
int persistent_ctas(Kernel kernel, int smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kWalkThreads, smem_bytes);
  return max(sms * per_sm, 1);
}

}  // namespace
