// The warp walk of the node tree, shared by the walk kernels (walk.cu,
// B9a-f) and the fat-leaf kernels (fat.cu, B11a-d): the node row, the
// near-child signs, the walk loop, its counters and the launch geometry.
//
// One warp walks the tree for its 32 rays with warp-uniform control flow:
// it pops a node, each lane slab-tests the node against its own ray and
// current bound, and the warp descends if __any_sync says some lane enters
// it, near child first by the signs the kernel gives it, the far child on a
// stack in shared memory of depth + 2 entries per warp (the host sizes it
// from the tree; a walk holds at most one far child per level). At a leaf,
// the lanes that enter it test its triangles (the kernel's leaf function).

#pragma once

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

// The near-child signs of a walk: 1 on an axis whose near child is the
// second one in the node's order (first_node ^ sign picks it).
struct Signs {
  int s[3];
};

// The walk kernels' signs (B9): 1 on an axis whose inverse directions, over
// the warp's live lanes, have a negative midpoint (_ival_bounds' packet
// sign).
__device__ __forceinline__ Signs warp_signs(const float idir[3], bool live) {
  Signs w;
  for (int k = 0; k < 3; ++k)
    w.s[k] = warp_min(live ? idir[k] : kBig) +
                     warp_max(live ? idir[k] : -kBig) <
             0.0f;
  return w;
}

// The fat-leaf kernels' signs (B11): the packet's ray 0, as the host
// computed them (ops/traverse.py camera_signs / packet_signs), int32 (P, 3).
__device__ __forceinline__ Signs packet_signs(const int32_t* signs, int pid) {
  return Signs{{signs[3 * pid], signs[3 * pid + 1], signs[3 * pid + 2]}};
}

// The counters of a counting walk (B9e/B9f), per warp: the slots of the
// kernels' (P, 8) int32 row, summed over the packet's 128 warps (the JAX
// package's names and slots, ops/traverse.py STATS; slots 5-7 stay 0):
//   [0] nodes      node rows the warp loads (one per loop step);
//   [1] leaves     of those, the rows that are leaves;
//   [2] quarters   leaves some lane enters: the (leaf, warp) pairs that
//                  are intersected;
//   [3] tri_blocks triangles the warp tests in those leaves: per pair, the
//                  most triangles a lane tested, up to its any-hit stop
//                  (the leaf's count for a closest hit);
//   [4] chunks     stack pops.
// Control flow is warp-uniform, so every lane holds the same counts.
struct WalkCounts {
  int nodes = 0, leaves = 0, quarters = 0, tri_blocks = 0, chunks = 0;

  // Lane 0 adds the warp's counts to its packet's row.
  __device__ __forceinline__ void add_to(int32_t* row) const {
    if ((threadIdx.x & 31) != 0) return;
    atomicAdd(row + 0, nodes);
    atomicAdd(row + 1, leaves);
    atomicAdd(row + 2, quarters);
    atomicAdd(row + 3, tri_blocks);
    atomicAdd(row + 4, chunks);
  }
};

// The walk of one warp. ``bound()`` is this lane's distance limit for a
// node test (its best, or its shadow limit; <= 0 once it needs nothing);
// ``leaf(enter, first, count, tested)`` runs at every leaf some lane enters
// (enter: this lane does), sets ``tested`` to the triangles this lane
// tested and returns true to end the warp's walk. ``stack``: the warp's
// stack_cap ints of shared memory, written by lane 0. With STATS the walk
// counts into ``wc``; without, the counting compiles away.
template <bool STATS, typename BoundFn, typename LeafFn>
__device__ __forceinline__ void walk(const float4* nodes, int* stack,
                                     const float o[3], const float idir[3],
                                     const Signs& sg, BoundFn bound,
                                     LeafFn leaf, WalkCounts& wc) {
  const int lane = threadIdx.x & 31;
  int sp = 0, node = 0;
  for (;;) {
    const Node nd = load_node(nodes, node);
    if constexpr (STATS) {
      ++wc.nodes;
      wc.leaves += nd.count > 0;
    }
    float tf;
    bool enter;
    const float tn = slab_entry(nd.lo, nd.hi, o, idir, tf, enter);
    enter = enter && tn < bound();
    if (__any_sync(kFull, enter)) {
      if (nd.count > 0) {
        int tested = 0;
        const bool stop = leaf(enter, nd.child, nd.count, tested);
        if constexpr (STATS) {
          ++wc.quarters;
          wc.tri_blocks += (int)__reduce_max_sync(kFull, (unsigned)tested);
        }
        if (stop) return;
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
    if constexpr (STATS) ++wc.chunks;
    node = stack[--sp];
  }
}

__device__ __forceinline__ int* warp_stack(int stack_cap) {
  extern __shared__ int s_stack[];
  return s_stack + (threadIdx.x >> 5) * stack_cap;
}

// Launch geometry: one thread per ray, kWalkThreads per block; the rays
// are whole packets. The launchers return cudaErrorInvalidValue for
// arguments the kernels do not take.
inline bool walk_args_ok(int n_nodes, int stack_cap, int n_packets) {
  return n_nodes > 0 && stack_cap >= 2 && n_packets > 0 &&
         kWalkWarps * stack_cap * (int)sizeof(int) <= 48 * 1024;
}

inline int walk_blocks(int n_packets) {
  return n_packets * (kPacketR / kWalkThreads);
}

inline size_t walk_smem(int stack_cap) {
  return (size_t)kWalkWarps * stack_cap * sizeof(int);
}

}  // namespace
