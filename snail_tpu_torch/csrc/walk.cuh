// The warp walk of the node tree, shared by the walk kernels (walk.cu,
// B9a-f) and the fat-leaf kernels (fat.cu, B11a-d): the node row, the
// near-child signs, the walk loop, its counters, B9c's walk that tests a
// node's two children at once, the staged closest-hit leaf stage of B9c,
// B11a and B11b, and the launch geometry.
//
// One warp walks the tree for its 32 rays with warp-uniform control flow:
// it pops a node, each lane slab-tests the node against its own ray and
// current bound, and the warp descends if __any_sync says some lane enters
// it, near child first by the signs the kernel gives it, the far child on a
// stack in shared memory of depth + 2 entries per warp (the host sizes it
// from the tree; a walk holds at most one far child per level). At a leaf,
// the lanes that enter it test its triangles (the kernel's leaf function).

#pragma once

#include <type_traits>

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

// The walk of B9c: the leaves of ``walk``, in its order, each with the
// same lanes entering it, in fewer dependent steps. A step at an entered
// inner node tests both children, adjacent rows (64 bytes), against each
// lane's bound; the warp goes on into the near child if some lane enters
// it, else into the far one, and pushes the far child only if some lane
// enters it and the near one too. Bounds only fall, so a child no lane
// enters now is entered by none later; a pushed child is tested again when
// it is popped, since the leaves between may have lowered the bounds, as
// ``walk`` tests it then. ``leaf(enter, first, count)`` runs at every leaf
// some lane enters; where it returns a bool (an any-hit), true ends the
// warp's walk, as ``walk``'s leaf function does. On the H100 it took
// B9c 3-18 %, B9d 2-7 %, B9a 4-5 % and B11a 2 % less time than ``walk``;
// on B11b, whose leaves are larger, it was slower (PERF.md).
template <typename BoundFn, typename LeafFn>
__device__ __forceinline__ void walk_pairs(const float4* nodes, int* stack,
                                           const float o[3],
                                           const float idir[3],
                                           const Signs& sg, BoundFn bound,
                                           LeafFn leaf) {
  const int lane = threadIdx.x & 31;
  auto test = [&](const Node& nd) {
    float tf;
    bool enter;
    const float tn = slab_entry(nd.lo, nd.hi, o, idir, tf, enter);
    return enter && tn < bound();
  };
  int sp = 0;
  Node nd = load_node(nodes, 0);
  bool enter = test(nd);
  if (!__any_sync(kFull, enter)) return;
  for (;;) {
    if (nd.count > 0) {
      if constexpr (std::is_same_v<decltype(leaf(enter, 0, 0)), bool>) {
        if (leaf(enter, nd.child, nd.count)) return;
      } else {
        leaf(enter, nd.child, nd.count);
      }
    } else {
      const int s = nd.axis == 0 ? sg.s[0] : nd.axis == 1 ? sg.s[1] : sg.s[2];
      const int bit = nd.first ^ s;
      const Node cn = load_node(nodes, nd.child + bit),
                 cf = load_node(nodes, nd.child + 1 - bit);
      const bool en = test(cn), ef = test(cf);
      const bool any_n = __any_sync(kFull, en), any_f = __any_sync(kFull, ef);
      if (any_n) {
        if (any_f) {
          if (lane == 0) stack[sp] = nd.child + 1 - bit;
          ++sp;
        }
        nd = cn;
        enter = en;
        continue;
      }
      if (any_f) {
        nd = cf;
        enter = ef;
        continue;
      }
    }
    for (;;) {  // pop, up to a node some lane enters
      if (sp == 0) return;
      __syncwarp();  // lane 0's pushes are visible to every lane
      nd = load_node(nodes, stack[--sp]);
      enter = test(nd);
      if (__any_sync(kFull, enter)) break;
    }
  }
}

__device__ __forceinline__ int* warp_stack(int stack_cap) {
  extern __shared__ int s_stack[];
  return s_stack + (threadIdx.x >> 5) * stack_cap;
}

// --- The staged closest-hit leaf stage of B9c, B11a and B11b -------------
//
// At a leaf some lane enters, the warp first copies the leaf's rows into
// its own slice of shared memory (rays.cuh stage_leaf: 48-byte rows, one
// coalesced cp.async copy in place of a chain of dependent global loads
// in every entering lane).
// Then the warp tests the rows one of two ways, by how many lanes entered:
// - few (at most LANE_TRI_MAX): lane per triangle. The warp takes the
//   entering rays one at a time, broadcasts the ray and its best, lane j
//   tests rows j and j + 32, and a warp argmin over (distance, row) picks
//   the hit, the lower row on a tie;
// - many: lane per ray, each entering lane looping over the staged rows.
// Both give exactly what the serial loop of leaf_closest gives: its
// first strictly nearer hit is the nearest row below the best the ray
// brought into the leaf, the first of equal ones, which is the argmin.
// Every test is moller_raw + closer_hit, as there.

// The warp's slice of ``leaf_max`` staged rows, after the warps' stacks
// (rounded up to 16 bytes).
__device__ __forceinline__ float4* warp_stage(int stack_cap, int leaf_max) {
  extern __shared__ int s_stack[];
  const int off = (kWalkWarps * stack_cap + 3) & ~3;
  return reinterpret_cast<float4*>(s_stack + off) +
         (threadIdx.x >> 5) * leaf_max * kStageVec;
}

// The closest hit of this lane's ray over the ``count`` (<= MAX_ROWS) rows
// from ``first`` of a leaf, if it entered it (``enter``); every lane of
// the warp calls it. Updates best, tri, bu and bv as leaf_closest.
template <int MAX_ROWS, int LANE_TRI_MAX>
__device__ __forceinline__ void leaf_closest_staged(
    const float* rows, float4* stage, int first, int count, bool enter,
    const float o[3], const float d[3], float& best, int& tri, float& bu,
    float& bv) {
  static_assert(MAX_ROWS % 32 == 0, "rows are tested 32 a step");
  const int lane = threadIdx.x & 31;
  stage_leaf(rows, first, count, stage);
  const unsigned in = __ballot_sync(kFull, enter);
  if (__popc(in) > LANE_TRI_MAX) {
    if (enter)
      for (int j = 0; j < count; ++j) {
        float dist, u, v;
        if (closer_hit(moller_raw(o, d, staged_row(stage, j)), best, dist, u,
                       v)) {
          best = dist;
          tri = first + j;
          bu = u;
          bv = v;
        }
      }
    return;
  }
  for (unsigned m = in; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    float ro[3], rd[3];
    for (int k = 0; k < 3; ++k) {
      ro[k] = __shfl_sync(kFull, o[k], src);
      rd[k] = __shfl_sync(kFull, d[k], src);
    }
    const float rb = __shfl_sync(kFull, best, src);
    // this lane's nearest hit below rb over its rows; a hit's distance is
    // > 0, so its bits order as the floats do, and no hit is ~0u
    unsigned key = ~0u;
    int jb = 0;
    float hu = 0.0f, hv = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_ROWS / 32; ++r) {
      const int j = lane + 32 * r;
      float dist, u, v;
      if (j < count &&
          closer_hit(moller_raw(ro, rd, staged_row(stage, j)), rb, dist, u,
                     v) &&
          __float_as_uint(dist) < key) {
        key = __float_as_uint(dist);
        jb = j;
        hu = u;
        hv = v;
      }
    }
    const unsigned kmin = __reduce_min_sync(kFull, key);
    if (kmin == ~0u) continue;
    const unsigned jmin =
        __reduce_min_sync(kFull, key == kmin ? (unsigned)jb : ~0u);
    const float wu = __shfl_sync(kFull, hu, jmin & 31),
                wv = __shfl_sync(kFull, hv, jmin & 31);
    if (lane == src) {
      best = __uint_as_float(kmin);
      tri = first + (int)jmin;
      bu = wu;
      bv = wv;
    }
  }
}

// Launch geometry: one thread per ray, kWalkThreads per block; the rays
// are whole packets. The launchers return cudaErrorInvalidValue for
// arguments the kernels do not take. ``leaf_rows``: the rows of each
// warp's leaf stage (the tree's largest leaf), 0 for a kernel without one.
inline size_t walk_smem(int stack_cap, int leaf_rows = 0) {
  const size_t stack = (size_t)kWalkWarps * stack_cap * sizeof(int);
  if (leaf_rows == 0) return stack;
  return (stack + 15) / 16 * 16 +
         (size_t)kWalkWarps * leaf_rows * kStageVec * sizeof(float4);
}

inline bool walk_args_ok(int n_nodes, int stack_cap, int n_packets,
                         int leaf_rows = 0) {
  return n_nodes > 0 && stack_cap >= 2 && n_packets > 0 && leaf_rows >= 0 &&
         walk_smem(stack_cap, leaf_rows) <= 48 * 1024;
}

inline int walk_blocks(int n_packets) {
  return n_packets * (kPacketR / kWalkThreads);
}

}  // namespace
