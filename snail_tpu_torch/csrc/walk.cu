// BVH walk kernels for Hopper (sm_90a): the primary, shadow and bounce
// wavefronts of a scene traced through its node tree, with no worklist leaf
// tables.
//
// Replaces, in snail_tpu/ops/traverse_pallas.py:
//   walk_camera_kernel    <- _camera_ival_kernel      (B9a)
//                            _camera_ival_kernel_paged (B10a)
//   walk_shadow_kernel    <- _shadow_ival_kernel      (B9b)
//                            _shadow_ival_kernel_paged (B10b)
//   walk_closest_g_kernel <- _closest_ival_kernel_g   (B9c)
//                            _closest_ival_kernel_g_paged (B10c)
//   walk_shadow_g_kernel  <- _shadow_ival_kernel_g    (B9d)
//                            _shadow_ival_kernel_g_paged (B10d)
// The plain PyTorch versions are in snail_tpu_torch/ops/traverse_ref.py,
// the node layout in snail_tpu_torch/ops/traverse.py (NodeTables). Plain C
// interface at the bottom, loaded with ctypes, compiled with --fmad=false.
//
// Design: the reference's packet walk at warp size. One warp walks the tree
// for its 32 rays with warp-uniform control flow: it pops a node, each
// lane slab-tests the node against its own ray and current bound, and the
// warp descends if __any_sync says some lane enters it, near child first
// by the warp's direction signs (the sign of the midpoint of its live
// lanes' inverse directions, as _ival_bounds takes the packet's), the far
// child on a stack in shared memory of depth + 2 entries per warp (the
// host sizes it from the tree; a walk holds at most one far child per
// level). At a leaf, the lanes that enter it test its triangles with the
// device functions of the worklist kernels (rays.cuh): shared-origin rows
// for B9a/B9b, raw rows for B9c/B9d. Any-hit warps stop once every live
// lane is blocked (_shadow_ival_drain's exit, :1698).
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
// hundred bytes per warp.

#include "rays.cuh"

namespace {

constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;

// One 32-byte node row: lo.xyz, hi.x | hi.yz, child, meta, where child
// (the left child, or a leaf's first triangle) and meta = count | axis << 16
// | first_node << 18 are int32 bits.
struct Node {
  float lo[3], hi[3];
  int child, count, axis, first;
};

__device__ __forceinline__ Node load_node(const float4* nodes, int n) {
  const float4 a = __ldg(nodes + 2 * n), b = __ldg(nodes + 2 * n + 1);
  const int meta = __float_as_int(b.w);
  return Node{{a.x, a.y, a.z},   {a.w, b.x, b.y}, __float_as_int(b.z),
              meta & 0xffff,     (meta >> 16) & 3, (meta >> 18) & 1};
}

// The warp's near-child signs: 1 on an axis whose inverse directions, over
// its live lanes, have a negative midpoint.
struct Signs {
  int s[3];
};

__device__ __forceinline__ Signs warp_signs(const float idir[3], bool live) {
  Signs w;
  for (int k = 0; k < 3; ++k)
    w.s[k] = warp_min(live ? idir[k] : kBig) +
                     warp_max(live ? idir[k] : -kBig) <
             0.0f;
  return w;
}

// The walk of one warp. ``bound()`` is this lane's distance limit for a
// node test (its best, or its shadow limit; <= 0 once it needs nothing);
// ``leaf(enter, first, count)`` runs at every leaf some lane enters (enter:
// this lane does) and returns true to end the warp's walk. ``stack``: the
// warp's stack_cap ints of shared memory, written by lane 0.
template <typename BoundFn, typename LeafFn>
__device__ __forceinline__ void walk(const float4* nodes, int* stack,
                                     const float o[3], const float idir[3],
                                     const Signs& sg, BoundFn bound,
                                     LeafFn leaf) {
  const int lane = threadIdx.x & 31;
  int sp = 0, node = 0;
  for (;;) {
    const Node nd = load_node(nodes, node);
    float tf;
    bool enter;
    const float tn = slab_entry(nd.lo, nd.hi, o, idir, tf, enter);
    enter = enter && tn < bound();
    if (__any_sync(kFull, enter)) {
      if (nd.count > 0) {
        if (leaf(enter, nd.child, nd.count)) return;
      } else {
        const int s = nd.axis == 0 ? sg.s[0] : nd.axis == 1 ? sg.s[1] : sg.s[2];
        const int bit = nd.first ^ s;
        if (lane == 0) stack[sp] = nd.child + 1 - bit;  // far
        ++sp;
        node = nd.child + bit;  // near
        continue;
      }
    }
    if (sp == 0) return;
    __syncwarp();  // lane 0's pushes are visible to every lane
    node = stack[--sp];
  }
}

__device__ __forceinline__ int* warp_stack(int stack_cap) {
  extern __shared__ int s_stack[];
  return s_stack + (threadIdx.x >> 5) * stack_cap;
}

// B9a / B10a: camera raygen + closest hit on the shared-origin rows. A
// ray's bound starts at its root-box exit (0 when it misses the box);
// outputs as camera_wl_kernel's: a miss has dist BIG and tri -1.
__global__ void __launch_bounds__(kWalkThreads)
walk_camera_kernel(const float* __restrict__ cam,
                   const float* __restrict__ rows,
                   const float4* __restrict__ nodes, int stack_cap,
                   float* __restrict__ out_dist, float* __restrict__ out_u,
                   float* __restrict__ out_v, int32_t* __restrict__ out_tri,
                   float* __restrict__ out_dx, float* __restrict__ out_dy,
                   float* __restrict__ out_dz) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(g / kPacketR), k = (int)(g % kPacketR);
  const PrimaryRay r = camera_ray(cam, pid, k);
  const float o[3] = {cam[9], cam[10], cam[11]};
  float best = r.t_exit, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  walk(nodes, warp_stack(stack_cap), o, r.idir, warp_signs(r.idir, best > 0.0f),
       [&] { return best; },
       [&](bool enter, int first, int count) {
         if (enter) leaf_closest<false>(rows, first, count, o, r.d, best, tri,
                                        bu, bv);
         return false;
       });
  out_dist[g] = tri >= 0 ? best : kBig;
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = tri;
  out_dx[g] = r.d[0];
  out_dy[g] = r.d[1];
  out_dz[g] = r.d[2];
}

// B9b / B10b: any-hit from a shared origin on the shared-origin rows;
// blocked as 1.0f, a masked ray (tmax < 0) never blocked.
__global__ void __launch_bounds__(kWalkThreads)
walk_shadow_kernel(const float* __restrict__ orig,
                   const float* __restrict__ dx, const float* __restrict__ dy,
                   const float* __restrict__ dz, const float* __restrict__ tm,
                   const float* __restrict__ rows,
                   const float4* __restrict__ nodes, int stack_cap,
                   float* __restrict__ out_blocked) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {orig[0], orig[1], orig[2]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float limit = tm[g] >= 0.0f ? tm[g] : -kBig;
  bool blocked = false;
  walk(nodes, warp_stack(stack_cap), o, idir, warp_signs(idir, limit > 0.0f),
       [&] { return blocked ? -kBig : limit; },
       [&](bool enter, int first, int count) {
         int tested = 0;
         if (enter)
           blocked = leaf_blocks<false>(rows, first, count, o, d, limit,
                                        tested);
         return __all_sync(kFull, blocked || !(limit > 0.0f));
       });
  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

// B9c / B10c: closest hit of rays with their own origins on the raw rows.
// A live ray (tmax >= 0) starts at min(tmax, BIG); a miss returns BIG, a
// masked ray -BIG, and tri is clamped at 0 (_closest_ival_impl_g
// :2169-2175).
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
                      float* __restrict__ out_dist, float* __restrict__ out_u,
                      float* __restrict__ out_v,
                      int32_t* __restrict__ out_tri) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {ox[g], oy[g], oz[g]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const bool active = tm[g] >= 0.0f;
  float best = active ? fminf(tm[g], kBig) : -kBig, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  walk(nodes, warp_stack(stack_cap), o, idir, warp_signs(idir, best > 0.0f),
       [&] { return best; },
       [&](bool enter, int first, int count) {
         if (enter) leaf_closest<true>(rows, first, count, o, d, best, tri,
                                       bu, bv);
         return false;
       });
  out_dist[g] = tri >= 0 ? best : (active ? kBig : -kBig);
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = max(tri, 0);
}

// B9d / B10d: any-hit of rays with their own origins on the raw rows.
__global__ void __launch_bounds__(kWalkThreads)
walk_shadow_g_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tm,
                     const float* __restrict__ rows,
                     const float4* __restrict__ nodes, int stack_cap,
                     float* __restrict__ out_blocked) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float o[3] = {ox[g], oy[g], oz[g]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float limit = tm[g] >= 0.0f ? tm[g] : -kBig;
  bool blocked = false;
  walk(nodes, warp_stack(stack_cap), o, idir, warp_signs(idir, limit > 0.0f),
       [&] { return blocked ? -kBig : limit; },
       [&](bool enter, int first, int count) {
         int tested = 0;
         if (enter)
           blocked = leaf_blocks<true>(rows, first, count, o, d, limit,
                                       tested);
         return __all_sync(kFull, blocked || !(limit > 0.0f));
       });
  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

// Launch geometry: one thread per ray, kWalkThreads per block; the rays
// are whole packets. Returns cudaErrorInvalidValue for arguments the
// kernels do not take.
bool walk_args_ok(int n_nodes, int stack_cap, int n_packets) {
  return n_nodes > 0 && stack_cap >= 2 && n_packets > 0 &&
         kWalkWarps * stack_cap * (int)sizeof(int) <= 48 * 1024;
}

int walk_blocks(int n_packets) { return n_packets * (kPacketR / kWalkThreads); }

size_t walk_smem(int stack_cap) {
  return (size_t)kWalkWarps * stack_cap * sizeof(int);
}

}  // namespace

extern "C" {

int snail_walk_camera(const float* cam, const float* rows, const float* nodes,
                      int n_nodes, int stack_cap, int n_packets, float* dist,
                      float* u, float* v, int32_t* tri, float* dx, float* dy,
                      float* dz, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets))
    return (int)cudaErrorInvalidValue;
  walk_camera_kernel<<<walk_blocks(n_packets), kWalkThreads,
                       walk_smem(stack_cap), (cudaStream_t)stream>>>(
      cam, rows, reinterpret_cast<const float4*>(nodes), stack_cap, dist, u,
      v, tri, dx, dy, dz);
  return (int)cudaGetLastError();
}

int snail_walk_shadow(const float* orig, const float* dx, const float* dy,
                      const float* dz, const float* tm, const float* rows,
                      const float* nodes, int n_nodes, int stack_cap,
                      int n_packets, float* blocked, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets))
    return (int)cudaErrorInvalidValue;
  walk_shadow_kernel<<<walk_blocks(n_packets), kWalkThreads,
                       walk_smem(stack_cap), (cudaStream_t)stream>>>(
      orig, dx, dy, dz, tm, rows, reinterpret_cast<const float4*>(nodes),
      stack_cap, blocked);
  return (int)cudaGetLastError();
}

int snail_walk_closest_g(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         const float* tm, const float* rows,
                         const float* nodes, int n_nodes, int stack_cap,
                         int n_packets, float* dist, float* u, float* v,
                         int32_t* tri, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets))
    return (int)cudaErrorInvalidValue;
  walk_closest_g_kernel<<<walk_blocks(n_packets), kWalkThreads,
                          walk_smem(stack_cap), (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, rows, reinterpret_cast<const float4*>(nodes),
      stack_cap, dist, u, v, tri);
  return (int)cudaGetLastError();
}

int snail_walk_shadow_g(const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* tm, const float* rows,
                        const float* nodes, int n_nodes, int stack_cap,
                        int n_packets, float* blocked, void* stream) {
  if (!walk_args_ok(n_nodes, stack_cap, n_packets))
    return (int)cudaErrorInvalidValue;
  walk_shadow_g_kernel<<<walk_blocks(n_packets), kWalkThreads,
                         walk_smem(stack_cap), (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, rows, reinterpret_cast<const float4*>(nodes),
      stack_cap, blocked);
  return (int)cudaGetLastError();
}

}  // extern "C"
