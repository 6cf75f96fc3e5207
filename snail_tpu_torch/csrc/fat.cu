// Fat-leaf kernels for Hopper (sm_90a): the primary, shadow and bounce
// wavefronts of a scene whose BVH leaves hold up to LEAF_PAD = 64 triangles
// (a BVH built with leaf_size 33-64), traced through its node tree.
//
// Replaces, in snail_tpu/ops/traverse_pallas.py (the round-1 kernels that
// camera_trace, closest_hit_c, any_hit_shared and any_hit_c take when
// leaf_max > IVAL_LEAF):
//   fat_camera_kernel   <- _camera_kernel   (B11a)
//   fat_closest_kernel  <- _closest_kernel  (B11b)
//   fat_shadow_kernel   <- _shadow_kernel   (B11c)
//   fat_shadow_g_kernel <- _shadow_kernel_g (B11d)
// The plain PyTorch versions are in snail_tpu_torch/ops/traverse_ref.py.
// Plain C interface at the bottom, loaded with ctypes, compiled with
// --fmad=false.
//
// Design: the walk kernels' warp walk (walk.cuh), with what the TPU
// kernels compute:
// - the near child by the signs of the packet's ray 0 (_signs_of :3517),
//   given by the host per packet, so every warp of a packet meets the
//   leaves in the order the TPU kernel's ordered stack walk (_traverse
//   :498) meets them, and closest-hit ties resolve alike;
// - the full Moller test on the raw triangle rows for every kernel, with
//   the camera or the light as the origin where it is shared (_intersect4
//   :431 on pk_tris), not the shared-origin rows of B9a/B9b;
// - B11a starts each ray at BIG with no root-box clip and a miss keeps tri
//   0 (:619-622); B11b starts at min(tmax, BIG), or -BIG when masked, and
//   returns its best: a live miss with a finite tmax returns tmax (:655,
//   :665); B11c/B11d use the one-sided rule with limit tmax, or -BIG when
//   masked, and a warp stops once every live lane is blocked (:711-713).
// B11a and B11b copy each leaf they visit into the warp's shared memory
// once and test it lane per triangle, two rows a lane, where few lanes
// enter it (walk.cuh leaf_closest_staged); B11a's warps take 8 x 4 pixel
// tiles (rays.cuh tile_ray), as B2's. B11c and B11d stage their leaves
// too and test them lane per triangle where few lanes enter, lane per
// ray up to each ray's first occluder where many do (rays.cuh
// leaf_blocks_staged).
//
// What the TPU kernels needed and these do not: the 64-row leaf DMA into
// VMEM per visited leaf, STACK_CAP = 96 (here depth + 2, from the tree),
// the whole-packet slab vote per child (here per warp) and the SMEM node
// tables, capped at SMEM_NODE_CAP = 24,576 nodes (above it the JAX package
// falls to its jnp reference; here the same kernels serve any tree size).
//
// What bounds them on this card: as the walk kernels, the latency of each
// warp's chain of node loads, and here more the leaf tests: a leaf of up
// to 64 raw rows would be 64 dependent 48-byte loads per entering lane,
// with the lanes that enter the leaf diverging from those that do not;
// B11a-d copy it once per warp and test it from shared memory.

#include "walk.cuh"

namespace {

// B11b's leaf stage: leaves of at most LEAF_PAD = 64 rows, tested lane per
// triangle (two rows a lane) where at most kFatLaneTriMax lanes enter (set
// by a sweep on the H100, PERF.md).
constexpr int kFatLeafRows = 64;
constexpr int kFatLaneTriMax = 16;
// B11d's leaf stage: the same leaves, tested lane per triangle where at
// most kFatAnyLaneTriMax lanes enter (set by a sweep on the H100,
// PERF.md).
constexpr int kFatAnyLaneTriMax = 16;
// B11c's leaf stage: the same leaves, tested lane per triangle where at
// most kFatShadowLaneTriMax lanes enter (set by a sweep on the H100,
// PERF.md).
constexpr int kFatShadowLaneTriMax = 24;
// B11a's leaf stage: the same leaves, tested lane per triangle where at
// most kFatCamLaneTriMax lanes enter (set by a sweep on the H100,
// PERF.md).
constexpr int kFatCamLaneTriMax = 16;

// B11a: camera raygen + closest hit on the raw rows. Outputs dist, u, v,
// tri, dx, dy, dz; a miss has dist BIG and tri 0. A warp's rays are an 8
// x 4 pixel tile (rays.cuh tile_ray); each thread writes its own ray's
// slot. The near child comes from the packet's signs, so the leaves a ray
// enters, and their order, do not depend on which rays share its warp:
// the outputs are those of any footprint. Leaves go through the staged
// leaf stage (walk.cuh leaf_closest_staged), lane per triangle where at
// most kFatCamLaneTriMax lanes enter. It walks with walk_pairs (both
// children of a node in one step), 2 % faster here than ``walk``, where
// B11b was slower on it. ptxas gives it 61 registers; asked for at least
// 2 blocks an SM, 69, and it ran 2-3 % slower (PERF.md).
__global__ void __launch_bounds__(kWalkThreads)
fat_camera_kernel(const float* __restrict__ cam,
                  const int32_t* __restrict__ signs,
                  const float* __restrict__ rows,
                  const float4* __restrict__ nodes, int stack_cap,
                  int leaf_max, float* __restrict__ out_dist,
                  float* __restrict__ out_u, float* __restrict__ out_v,
                  int32_t* __restrict__ out_tri, float* __restrict__ out_dx,
                  float* __restrict__ out_dy, float* __restrict__ out_dz) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(t / kPacketR), k = tile_ray((int)(t % kPacketR));
  const size_t g = (size_t)pid * kPacketR + k;
  const PrimaryRay r = camera_ray(cam, pid, k);
  const float o[3] = {cam[9], cam[10], cam[11]};
  float best = kBig, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  float4* stage = warp_stage(stack_cap, leaf_max);
  walk_pairs(nodes, warp_stack(stack_cap), o, r.idir,
             packet_signs(signs, pid), [&] { return best; },
             [&](bool enter, int first, int count) {
               leaf_closest_staged<kFatLeafRows, kFatCamLaneTriMax>(
                   rows, stage, first, count, enter, o, r.d, best, tri, bu,
                   bv);
             });
  out_dist[g] = best;
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = max(tri, 0);
  out_dx[g] = r.d[0];
  out_dy[g] = r.d[1];
  out_dz[g] = r.d[2];
}

// B11b: closest hit of rays with their own origins on the raw rows.
// Returns each ray's best: its hit, else min(tmax, BIG), or -BIG when
// masked; tri 0 where nothing was hit. Leaves through the staged leaf
// stage (walk.cuh), lane per triangle where at most kFatLaneTriMax lanes
// enter. It walks with ``walk``: B9c's walk_pairs was slower here, on
// both leaf-64 bench scenes (PERF.md).
__global__ void __launch_bounds__(kWalkThreads)
fat_closest_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tm,
                   const int32_t* __restrict__ signs,
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
  float best = tm[g] >= 0.0f ? fminf(tm[g], kBig) : -kBig, bu = 0.0f,
        bv = 0.0f;
  int tri = -1;
  float4* stage = warp_stage(stack_cap, leaf_max);
  WalkCounts wc;
  walk<false>(nodes, warp_stack(stack_cap), o, idir,
              packet_signs(signs, (int)(g / kPacketR)), [&] { return best; },
              [&](bool enter, int first, int count, int&) {
                leaf_closest_staged<kFatLeafRows, kFatLaneTriMax>(
                    rows, stage, first, count, enter, o, d, best, tri, bu,
                    bv);
                return false;
              },
              wc);
  out_dist[g] = best;
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = max(tri, 0);
}

// B11c: any-hit from the shared origin ``orig`` (the light) on the raw
// rows: blocked as 1.0f, a masked ray (tmax < 0) never blocked. Leaves go
// through the staged any-hit leaf stage (rays.cuh leaf_blocks_staged),
// lane per triangle, two rows a lane, where at most kFatShadowLaneTriMax
// lanes enter. It walks with ``walk``, as B11d.
__global__ void __launch_bounds__(kWalkThreads)
fat_shadow_kernel(const float* __restrict__ orig,
                  const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ dz, const float* __restrict__ tm,
                  const int32_t* __restrict__ signs,
                  const float* __restrict__ rows,
                  const float4* __restrict__ nodes, int stack_cap,
                  int leaf_max, float* __restrict__ out_blocked) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {orig[0], orig[1], orig[2]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float limit = tm[g] >= 0.0f ? tm[g] : -kBig;
  float4* stage = warp_stage(stack_cap, leaf_max);
  bool blocked = false;
  WalkCounts wc;
  walk<false>(nodes, warp_stack(stack_cap), o, idir,
              packet_signs(signs, (int)(g / kPacketR)),
              [&] { return blocked ? -kBig : limit; },
              [&](bool enter, int first, int count, int&) {
                if (leaf_blocks_staged<kFatLeafRows, kFatShadowLaneTriMax>(
                        rows, stage, first, count, enter, o, d, limit))
                  blocked = true;
                return __all_sync(kFull, blocked || !(limit > 0.0f));
              },
              wc);
  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

// B11d: any-hit of rays with their own origins on the raw rows: blocked
// as 1.0f, a masked ray (tmax < 0) never blocked. Leaves go through the
// staged any-hit leaf stage (rays.cuh leaf_blocks_staged), lane per
// triangle, two rows a lane, where at most kFatAnyLaneTriMax lanes enter.
// It walks with ``walk``, as B11b.
__global__ void __launch_bounds__(kWalkThreads)
fat_shadow_g_kernel(const float* __restrict__ ox,
                    const float* __restrict__ oy,
                    const float* __restrict__ oz,
                    const float* __restrict__ dx,
                    const float* __restrict__ dy,
                    const float* __restrict__ dz,
                    const float* __restrict__ tm,
                    const int32_t* __restrict__ signs,
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
  WalkCounts wc;
  walk<false>(nodes, warp_stack(stack_cap), o, idir,
              packet_signs(signs, (int)(g / kPacketR)),
              [&] { return blocked ? -kBig : limit; },
              [&](bool enter, int first, int count, int&) {
                if (leaf_blocks_staged<kFatLeafRows, kFatAnyLaneTriMax>(
                        rows, stage, first, count, enter, o, d, limit))
                  blocked = true;
                return __all_sync(kFull, blocked || !(limit > 0.0f));
              },
              wc);
  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

// ``leaf_max``: as snail_fat_closest's.
int snail_fat_camera(const float* cam, const int32_t* signs,
                     const float* rows, const float* nodes, int n_nodes,
                     int stack_cap, int leaf_max, int n_packets, float* dist,
                     float* u, float* v, int32_t* tri, float* dx, float* dy,
                     float* dz, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kFatLeafRows)
    return (int)cudaErrorInvalidValue;
  fat_camera_kernel<<<walk_blocks(n_packets), kWalkThreads,
                      walk_smem(stack_cap, leaf_max), (cudaStream_t)stream>>>(
      cam, signs, rows, reinterpret_cast<const float4*>(nodes), stack_cap,
      leaf_max, dist, u, v, tri, dx, dy, dz);
  return (int)cudaGetLastError();
}

// ``leaf_max``: the tree's largest leaf, at most kFatLeafRows; it sizes
// each warp's leaf stage.
int snail_fat_closest(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tm, const int32_t* signs,
                      const float* rows, const float* nodes, int n_nodes,
                      int stack_cap, int leaf_max, int n_packets, float* dist,
                      float* u, float* v, int32_t* tri, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kFatLeafRows)
    return (int)cudaErrorInvalidValue;
  fat_closest_kernel<<<walk_blocks(n_packets), kWalkThreads,
                       walk_smem(stack_cap, leaf_max),
                       (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, signs, rows,
      reinterpret_cast<const float4*>(nodes), stack_cap, leaf_max, dist, u,
      v, tri);
  return (int)cudaGetLastError();
}

// ``leaf_max``: as snail_fat_closest's.
int snail_fat_shadow(const float* orig, const float* dx, const float* dy,
                     const float* dz, const float* tm, const int32_t* signs,
                     const float* rows, const float* nodes, int n_nodes,
                     int stack_cap, int leaf_max, int n_packets,
                     float* blocked, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kFatLeafRows)
    return (int)cudaErrorInvalidValue;
  fat_shadow_kernel<<<walk_blocks(n_packets), kWalkThreads,
                      walk_smem(stack_cap, leaf_max),
                      (cudaStream_t)stream>>>(
      orig, dx, dy, dz, tm, signs, rows,
      reinterpret_cast<const float4*>(nodes), stack_cap, leaf_max, blocked);
  return (int)cudaGetLastError();
}

// ``leaf_max``: as snail_fat_closest's.
int snail_fat_shadow_g(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* tm, const int32_t* signs,
                       const float* rows, const float* nodes, int n_nodes,
                       int stack_cap, int leaf_max, int n_packets,
                       float* blocked, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets, leaf_max) ||
      leaf_max < 1 || leaf_max > kFatLeafRows)
    return (int)cudaErrorInvalidValue;
  fat_shadow_g_kernel<<<walk_blocks(n_packets), kWalkThreads,
                        walk_smem(stack_cap, leaf_max),
                        (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, signs, rows,
      reinterpret_cast<const float4*>(nodes), stack_cap, leaf_max, blocked);
  return (int)cudaGetLastError();
}

}  // extern "C"
