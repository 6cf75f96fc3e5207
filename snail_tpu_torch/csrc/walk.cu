// BVH walk kernels for Hopper (sm_90a): the primary, shadow and bounce
// wavefronts of a scene traced through its node tree, with no worklist leaf
// tables.
//
// Replaces, in snail_tpu/ops/traverse_pallas.py:
//   walk_camera_kernel<false> <- _camera_ival_kernel       (B9a)
//                                _camera_ival_kernel_paged (B10a)
//   walk_shadow_kernel<false> <- _shadow_ival_kernel       (B9b)
//                                _shadow_ival_kernel_paged (B10b)
//   walk_closest_g_kernel     <- _closest_ival_kernel_g    (B9c)
//                                _closest_ival_kernel_g_paged (B10c)
//   walk_shadow_g_kernel      <- _shadow_ival_kernel_g     (B9d)
//                                _shadow_ival_kernel_g_paged (B10d)
//   walk_camera_kernel<true>  <- _camera_ival_kernel_stats (B9e)
//   walk_shadow_kernel<true>  <- _shadow_ival_kernel_stats (B9f)
// The plain PyTorch versions are in snail_tpu_torch/ops/traverse_ref.py,
// the node layout in snail_tpu_torch/ops/traverse.py (NodeTables). Plain C
// interface at the bottom, loaded with ctypes, compiled with --fmad=false.
//
// Design: the reference's packet walk at warp size (walk.cuh), near child
// first by the warp's direction signs (the sign of the midpoint of its live
// lanes' inverse directions, as _ival_bounds takes the packet's). At a
// leaf, the lanes that enter it test its triangles with the device
// functions of the worklist kernels (rays.cuh), on the raw triangle rows
// (B9a/B9b with the full Moller test from their shared origin, as B2 and
// B4 take it; no per-frame table). B9c copies each leaf it visits into the
// warp's shared memory once and tests it lane per triangle where few lanes
// enter it (walk.cuh leaf_closest_staged): on reflection rays a warp's
// lanes scatter, and a visit has a handful of entering lanes. Its walk
// tests both children of a node in one step (walk.cuh walk_pairs), the
// same leaves in the same order in fewer dependent steps. B9d and B9b
// walk so too, and stage their leaves and test them lane per triangle
// where few lanes enter, each lane per ray up to its first occluder where
// many do (rays.cuh leaf_blocks_staged; B9b's shared light makes a
// visit's lanes few on the terrain). B9a stages its leaves too and tests
// them lane per triangle where few lanes enter (rays.cuh
// staged_closest_sh, B2's, on raw rows), on walk_pairs, its warps on
// 8 x 4 pixel tiles (rays.cuh tile_ray), as B2's. Any-hit warps stop once every live lane is blocked
// (_shadow_ival_drain's exit, :1698). B9e/B9f are B9a/B9b with
// STATS: the walk counts what each warp did (walk.cuh WalkCounts) and lane
// 0 adds it to the packet's (P, 8) int32 row with integer atomics, so the
// counts do not depend on the order the warps run in; with STATS false the
// counting compiles away.
//
// What the TPU kernels needed and these do not: the node tables staged in
// SMEM once per launch (_stage_tables), capped at SMEM_NODE_CAP nodes and
// paged beyond it (B10, bvh/pages.py), the XLA node-mask pre-pass
// (compute_masks) that moved node tests off the scalar core, the leaf DMA
// ring and the per-quarter culls. Here a node is one 32-byte row read from
// global memory through the read-only path (a 1 Mtri scene's ~88k nodes,
// 2.8 MB, stay in the 50 MB L2), a node test is one slab test per lane, and
// nothing persists between blocks, which run in no order. With no node cap
// the same kernels compute what B10 computes.
//
// What bounds them on this card: each warp's walk is a chain of dependent
// steps (node load -> slab test -> vote -> next node), so a walk is bound
// by load latency and by divergence in the leaf tests, not by device
// memory or float rate; the card hides the latency with many warps (8 per
// block, blocks limited by registers). The shared-memory stack costs a few
// hundred bytes per warp; the counters five registers and five atomics per
// warp. Each kernel's leaf stage adds 8 warps x 32 rows x 48 B
// = 12 KB a block at leaf 32: the SM's 228 KB would hold 18 such blocks,
// more than its 2,048 threads (8 blocks) or its registers let in, so it
// costs no occupancy, only some of the L1 that shares the SM's 256 KB.

#include "walk.cuh"

namespace {

// B9c's leaf stage: leaves of at most IVAL_LEAF = 32 rows, tested lane per
// triangle where at most kWalkLaneTriMax lanes enter (set by a sweep on
// the H100, PERF.md).
constexpr int kWalkLeafRows = 32;
constexpr int kWalkLaneTriMax = 12;
// B9d's leaf stage: the same leaves, tested lane per triangle where at
// most kWalkAnyLaneTriMax lanes enter (set by a sweep on the H100,
// PERF.md).
constexpr int kWalkAnyLaneTriMax = 12;
// B9b's (and B9f's) leaf stage: the same leaves, tested lane per
// triangle where at most kWalkShadowLaneTriMax lanes enter.
constexpr int kWalkShadowLaneTriMax = 12;
// B9a's (and B9e's) leaf stage: the same leaves, tested lane per
// triangle where at most kWalkCamLaneTriMax lanes enter (set by a sweep
// on the H100, PERF.md).
constexpr int kWalkCamLaneTriMax = 12;

// B9a / B10a: camera raygen + closest hit on the raw rows. A
// ray's bound starts at its root-box exit (0 when it misses the box);
// outputs as camera_wl_kernel's: a miss has dist BIG and tri -1. A warp's
// rays are an 8 x 4 pixel tile (rays.cuh tile_ray), whose near-child
// signs are its own (warp_signs); each thread writes its own ray's slot.
// Leaves go through the staged shared-origin closest-hit stage (rays.cuh
// stage_leaf into the warp's stage, then staged_closest_sh on raw rows,
// the full Moller test from the camera's position), lane per
// triangle where at most kWalkCamLaneTriMax lanes enter. B9a walks with
// walk_pairs (both children of a node in one step). B9e (STATS) walks
// with ``walk``, whose node steps its counters count, into ``stats`` (P,
// 8): the same leaves in the same order with the same lanes entering
// them, and a closest hit changes only on a strictly nearer hit, so its
// outputs are B9a's. Asked for at least 2 blocks an SM, ptxas gives B9a
// 62 registers and B9e 68 and spills none. On the shared-origin rows it
// gave them 50 (48 and 4 bytes spilled with no minimum) and 64: B9e 2 %
// faster, B9a within 1 %; at 3 or 4 blocks both were slower (PERF.md).
template <bool STATS>
__global__ void __launch_bounds__(kWalkThreads, 2)
walk_camera_kernel(const float* __restrict__ cam,
                   const float* __restrict__ rows,
                   const float4* __restrict__ nodes, int stack_cap,
                   int leaf_max, float* __restrict__ out_dist,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int32_t* __restrict__ out_tri, float* __restrict__ out_dx,
                   float* __restrict__ out_dy, float* __restrict__ out_dz,
                   int32_t* __restrict__ stats) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(t / kPacketR), k = tile_ray((int)(t % kPacketR));
  const size_t g = (size_t)pid * kPacketR + k;
  const int lane = threadIdx.x & 31;
  const PrimaryRay r = camera_ray(cam, pid, k);
  const float o[3] = {cam[9], cam[10], cam[11]};
  float best = r.t_exit, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  float4* stage = warp_stage(stack_cap, leaf_max);
  const Signs sg = warp_signs(r.idir, best > 0.0f);
  auto bound = [&] { return best; };
  auto leaf = [&](bool enter, int first, int count) {
    stage_leaf(rows, first, count, stage);
    staged_closest_sh<kWalkCamLaneTriMax, true>(stage, first, count, enter,
                                                o, r.d, best, tri, bu, bv,
                                                lane);
  };
  if constexpr (STATS) {
    WalkCounts wc;
    walk<true>(nodes, warp_stack(stack_cap), o, r.idir, sg, bound,
               [&](bool enter, int first, int count, int& tested) {
                 leaf(enter, first, count);
                 if (enter) tested = count;
                 return false;
               },
               wc);
    wc.add_to(stats + 8 * pid);
  } else {
    walk_pairs(nodes, warp_stack(stack_cap), o, r.idir, sg, bound, leaf);
  }
  out_dist[g] = tri >= 0 ? best : kBig;
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = tri;
  out_dx[g] = r.d[0];
  out_dy[g] = r.d[1];
  out_dz[g] = r.d[2];
}

// B9b / B10b: any-hit from a shared origin on the raw rows; blocked as
// 1.0f, a masked ray (tmax < 0) never blocked. Leaves go through the
// staged any-hit leaf stage on raw rows (rays.cuh leaf_blocks_staged, the
// full Moller test from ``orig``), lane per triangle where at most
// kWalkShadowLaneTriMax lanes enter; B9b walks with walk_pairs (both
// children of a node in one step). B9f (STATS) walks with ``walk``, whose
// node steps its counters count: the same leaves in the same order, with
// the same lanes entering them, so its verdicts are B9b's. With no
// minimum of blocks an SM, ptxas gives B9b 48 registers and spills 12
// bytes; asked for 2 it gave 55 and spilled none, and ran within 2 %, no
// faster beyond the noise (PERF.md).
template <bool STATS>
__global__ void __launch_bounds__(kWalkThreads)
walk_shadow_kernel(const float* __restrict__ orig,
                   const float* __restrict__ dx, const float* __restrict__ dy,
                   const float* __restrict__ dz, const float* __restrict__ tm,
                   const float* __restrict__ rows,
                   const float4* __restrict__ nodes, int stack_cap,
                   int leaf_max, float* __restrict__ out_blocked,
                   int32_t* __restrict__ stats) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {orig[0], orig[1], orig[2]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float limit = tm[g] >= 0.0f ? tm[g] : -kBig;
  float4* stage = warp_stage(stack_cap, leaf_max);
  bool blocked = false;
  const Signs sg = warp_signs(idir, limit > 0.0f);
  auto bound = [&] { return blocked ? -kBig : limit; };
  auto leaf = [&](bool enter, int first, int count, int* tested) {
    if (leaf_blocks_staged<kWalkLeafRows, kWalkShadowLaneTriMax, true,
                           STATS>(rows, stage, first, count, enter, o, d,
                                  limit, tested))
      blocked = true;
    return __all_sync(kFull, blocked || !(limit > 0.0f));
  };
  if constexpr (STATS) {
    WalkCounts wc;
    walk<true>(nodes, warp_stack(stack_cap), o, idir, sg, bound,
               [&](bool enter, int first, int count, int& tested) {
                 return leaf(enter, first, count, &tested);
               },
               wc);
    wc.add_to(stats + 8 * (int)(g / kPacketR));
  } else {
    walk_pairs(nodes, warp_stack(stack_cap), o, idir, sg, bound,
               [&](bool enter, int first, int count) {
                 return leaf(enter, first, count, nullptr);
               });
  }
  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

// B9c / B10c: closest hit of rays with their own origins on the raw rows.
// A live ray (tmax >= 0) starts at min(tmax, BIG); a miss returns BIG, a
// masked ray -BIG, and tri is clamped at 0 (_closest_ival_impl_g
// :2169-2175). The walk tests a node's two children at once (walk.cuh
// walk_pairs), and leaves go through the staged leaf stage, lane per
// triangle where at most kWalkLaneTriMax lanes enter.
__global__ void __launch_bounds__(kWalkThreads)
walk_closest_g_kernel(const float* __restrict__ ox,
                      const float* __restrict__ oy,
                      const float* __restrict__ oz,
                      const float* __restrict__ dx,
                      const float* __restrict__ dy,
                      const float* __restrict__ dz,
                      const float* __restrict__ tm,
                      const float* __restrict__ rows,
                      const float4* __restrict__ nodes, int stack_cap,
                      int leaf_max, float* __restrict__ out_dist,
                      float* __restrict__ out_u, float* __restrict__ out_v,
                      int32_t* __restrict__ out_tri) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {ox[g], oy[g], oz[g]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const bool active = tm[g] >= 0.0f;
  float best = active ? fminf(tm[g], kBig) : -kBig, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  float4* stage = warp_stage(stack_cap, leaf_max);
  walk_pairs(nodes, warp_stack(stack_cap), o, idir,
             warp_signs(idir, best > 0.0f), [&] { return best; },
             [&](bool enter, int first, int count) {
               leaf_closest_staged<kWalkLeafRows, kWalkLaneTriMax>(
                   rows, stage, first, count, enter, o, d, best, tri, bu,
                   bv);
             });
  out_dist[g] = tri >= 0 ? best : (active ? kBig : -kBig);
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = max(tri, 0);
}

// B9d / B10d: any-hit of rays with their own origins on the raw rows.
// The walk tests a node's two children at once (walk.cuh walk_pairs) and
// ends once every live lane is blocked; leaves go through the staged
// any-hit leaf stage (rays.cuh leaf_blocks_staged), lane per triangle
// where at most kWalkAnyLaneTriMax lanes enter. Asked for at least 2
// blocks an SM, ptxas gives it 52 registers and spills none; with no
// minimum it gave 48 and spilled, with 4 it gave 55 and ran 3 % slower
// (PERF.md).
__global__ void __launch_bounds__(kWalkThreads, 2)
walk_shadow_g_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tm,
                     const float* __restrict__ rows,
                     const float4* __restrict__ nodes, int stack_cap,
                     int leaf_max, float* __restrict__ out_blocked) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {ox[g], oy[g], oz[g]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float limit = tm[g] >= 0.0f ? tm[g] : -kBig;
  float4* stage = warp_stage(stack_cap, leaf_max);
  bool blocked = false;
  walk_pairs(nodes, warp_stack(stack_cap), o, idir,
             warp_signs(idir, limit > 0.0f),
             [&] { return blocked ? -kBig : limit; },
             [&](bool enter, int first, int count) {
               if (leaf_blocks_staged<kWalkLeafRows, kWalkAnyLaneTriMax>(
                       rows, stage, first, count, enter, o, d, limit))
                 blocked = true;
               return __all_sync(kFull, blocked || !(limit > 0.0f));
             });
  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

// ``stats``: null for B9a, a zeroed (P, 8) int32 row per packet for B9e.
// ``leaf_max``: as snail_walk_closest_g's.
int snail_walk_camera(const float* cam, const float* rows, const float* nodes,
                      int n_nodes, int stack_cap, int leaf_max, int n_packets,
                      float* dist, float* u, float* v, int32_t* tri,
                      float* dx, float* dy, float* dz, int32_t* stats,
                      void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kWalkLeafRows)
    return (int)cudaErrorInvalidValue;
  auto kernel = stats ? walk_camera_kernel<true> : walk_camera_kernel<false>;
  kernel<<<walk_blocks(n_packets), kWalkThreads,
           walk_smem(stack_cap, leaf_max), (cudaStream_t)stream>>>(
      cam, rows, reinterpret_cast<const float4*>(nodes), stack_cap, leaf_max,
      dist, u, v, tri, dx, dy, dz, stats);
  return (int)cudaGetLastError();
}

// ``stats``: null for B9b, a zeroed (P, 8) int32 row per packet for B9f.
// ``leaf_max``: as snail_walk_closest_g's.
int snail_walk_shadow(const float* orig, const float* dx, const float* dy,
                      const float* dz, const float* tm, const float* rows,
                      const float* nodes, int n_nodes, int stack_cap,
                      int leaf_max, int n_packets, float* blocked,
                      int32_t* stats, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kWalkLeafRows)
    return (int)cudaErrorInvalidValue;
  auto kernel = stats ? walk_shadow_kernel<true> : walk_shadow_kernel<false>;
  kernel<<<walk_blocks(n_packets), kWalkThreads,
           walk_smem(stack_cap, leaf_max), (cudaStream_t)stream>>>(
      orig, dx, dy, dz, tm, rows, reinterpret_cast<const float4*>(nodes),
      stack_cap, leaf_max, blocked, stats);
  return (int)cudaGetLastError();
}

// ``leaf_max``: the tree's largest leaf, at most kWalkLeafRows; it sizes
// each warp's leaf stage.
int snail_walk_closest_g(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         const float* tm, const float* rows,
                         const float* nodes, int n_nodes, int stack_cap,
                         int leaf_max, int n_packets, float* dist, float* u,
                         float* v, int32_t* tri, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kWalkLeafRows)
    return (int)cudaErrorInvalidValue;
  walk_closest_g_kernel<<<walk_blocks(n_packets), kWalkThreads,
                          walk_smem(stack_cap, leaf_max),
                          (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, rows, reinterpret_cast<const float4*>(nodes),
      stack_cap, leaf_max, dist, u, v, tri);
  return (int)cudaGetLastError();
}

// ``leaf_max``: as snail_walk_closest_g's.
int snail_walk_shadow_g(const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* tm, const float* rows,
                        const float* nodes, int n_nodes, int stack_cap,
                        int leaf_max, int n_packets, float* blocked,
                        void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kWalkLeafRows)
    return (int)cudaErrorInvalidValue;
  walk_shadow_g_kernel<<<walk_blocks(n_packets), kWalkThreads,
                         walk_smem(stack_cap, leaf_max),
                         (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, rows, reinterpret_cast<const float4*>(nodes),
      stack_cap, leaf_max, blocked);
  return (int)cudaGetLastError();
}

}  // extern "C"
