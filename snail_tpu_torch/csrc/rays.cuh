// Ray, warp and triangle helpers shared by the worklist kernels
// (worklist.cu), the walk kernels (walk.cu) and the fat-leaf kernels
// (fat.cu), with the camera kernels' 8 x 4 pixel warps, the staged
// any-hit leaf stage and the staged shared-origin closest-hit stage.
// Every function here is the arithmetic that the plain PyTorch versions
// in snail_tpu_torch/ops repeat operation for operation; the sources are
// compiled with --fmad=false, so every product and sum is rounded on its
// own, as there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e37f;
constexpr float kInvEps = 1e-8f;
constexpr int kTile = 64;
constexpr int kPacketR = kTile * kTile;
constexpr unsigned kFull = 0xffffffffu;

// Camera scalars (ops/traverse.py cam_vec): right 0:3, up 3:6,
// front*plane_dist 6:9, pos 9:12, w/2 12, h/2 13, 1/h 14, tiles_x 15,
// root lo 16:19, root hi 19:22.
struct PrimaryRay {
  float d[3];
  float idir[3];
  float t_exit;
};

// Slab test of the ray o + t d (idir = 1 / d) against the box [lo, hi]:
// entry distance, and pass = the ray enters the box in front of it.
__device__ __forceinline__ float slab_entry(const float lo[3],
                                            const float hi[3],
                                            const float o[3],
                                            const float idir[3],
                                            float& t_far, bool& pass) {
  float t1[3], t2[3];
  for (int k = 0; k < 3; ++k) {
    t1[k] = (lo[k] - o[k]) * idir[k];
    t2[k] = (hi[k] - o[k]) * idir[k];
  }
  const float tn = fmaxf(fmaxf(fminf(t1[0], t2[0]), fminf(t1[1], t2[1])),
                         fminf(t1[2], t2[2]));
  t_far = fminf(fminf(fmaxf(t1[0], t2[0]), fmaxf(t1[1], t2[1])),
                fmaxf(t1[2], t2[2]));
  pass = tn <= t_far && t_far > 0.0f;
  return tn;
}

// Exit distance of the ray from the box [lo, hi], times 1.0001; 0 when the
// ray misses the box or the box lies behind it.
__device__ __forceinline__ float box_exit(const float* lo, const float* hi,
                                          const float* o,
                                          const float* idir) {
  float tf;
  bool pass;
  slab_entry(lo, hi, o, idir, tf, pass);
  return pass ? tf * 1.0001f : 0.0f;
}

__device__ __forceinline__ PrimaryRay camera_ray(const float* cam, int pid,
                                                 int k) {
  const int tiles_x = (int)cam[15];
  const int tx = pid % tiles_x, ty = pid / tiles_x;
  const int q = k >> 10, i = k & 1023;
  const float px = (float)(tx * kTile + ((q & 1) << 5) + (i & 31));
  const float py = (float)(ty * kTile + ((q >> 1) << 5) + (i >> 5));
  const float x = (px + 0.5f - cam[12]) * cam[14];
  const float y = (cam[13] - py - 0.5f) * cam[14];
  PrimaryRay r;
  float d[3];
  for (int c = 0; c < 3; ++c) d[c] = cam[c] * x + cam[3 + c] * y + cam[6 + c];
  const float inv_len = __frsqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  for (int c = 0; c < 3; ++c) {
    r.d[c] = d[c] * inv_len;
    r.idir[c] = 1.0f / (r.d[c] + kInvEps);
  }
  r.t_exit = box_exit(cam + 16, cam + 19, cam + 9, r.idir);
  return r;
}

// The ray (packet-order index, camera_ray's k) of thread ``t`` of a packet
// in the camera kernels B2 (B8a), B9a (B9e) and B11a: each warp takes an
// 8 x 4 pixel tile of its 32 x 32 quarter, 4 tiles across and 8 down
// (lane l: pixel (l % 8, l / 8) of its tile), where the other kernels'
// warps take 32 consecutive rays. Its rays' directions span less, so
// fewer leaves are visited and more of its lanes enter each
// (ops/traverse.py camera_wl_order).
__device__ __forceinline__ int tile_ray(int t) {
  const int q = t >> 10, w = (t >> 5) & 31, l = t & 31;
  return (q << 10) | ((((w >> 2) << 2) + (l >> 3)) << 5) |
         (((w & 3) << 3) + (l & 7));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int s = 16; s; s >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// Triangle row of the shared-origin table: n, c1, c2, tmul, pad.
struct TriRow {
  float nx, ny, nz, c1x, c1y, c1z, c2x, c2y, c2z, tmul;
};

__device__ __forceinline__ TriRow load_row(const float* rows, int t) {
  const float4* p = reinterpret_cast<const float4*>(rows) + (size_t)t * 4;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  return TriRow{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y};
}

// Raw triangle row: a, ba, ca, n = ba x ca, pad.
struct RawRow {
  float ax, ay, az, bax, bay, baz, cax, cay, caz, nx, ny, nz;
};

__device__ __forceinline__ RawRow load_raw_row(const float* rows, int t) {
  const float4* p = reinterpret_cast<const float4*>(rows) + (size_t)t * 4;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  return RawRow{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

// The Moller terms of one ray against one triangle: det = d.n, u, v and
// tmul = -(tv.n), tv = o - a.
struct Moller {
  float det, u, v, tmul;
};

// Shared-origin rows (ops/traverse.py shared_rows): the origin terms are
// per-triangle constants, so a ray needs its direction only.
__device__ __forceinline__ Moller moller_sh(const float d[3],
                                            const TriRow& t) {
  return Moller{d[0] * t.nx + d[1] * t.ny + d[2] * t.nz,
                d[0] * t.c1x + d[1] * t.c1y + d[2] * t.c1z,
                d[0] * t.c2x + d[1] * t.c2y + d[2] * t.c2z, t.tmul};
}

// Raw rows, the full Moller test in the order of _intersect4 (:431-458).
__device__ __forceinline__ Moller moller_raw(const float o[3],
                                             const float d[3],
                                             const RawRow& t) {
  const float tvx = o[0] - t.ax, tvy = o[1] - t.ay, tvz = o[2] - t.az;
  Moller m;
  m.det = d[0] * t.nx + d[1] * t.ny + d[2] * t.nz;
  m.tmul = -(tvx * t.nx + tvy * t.ny + tvz * t.nz);
  m.u = d[0] * (tvy * t.caz - tvz * t.cay) + d[1] * (tvz * t.cax - tvx * t.caz) +
        d[2] * (tvx * t.cay - tvy * t.cax);
  m.v = d[0] * (t.bay * tvz - t.baz * tvy) + d[1] * (t.baz * tvx - t.bax * tvz) +
        d[2] * (t.bax * tvy - t.bay * tvx);
  return m;
}

// The closest-hit rule, two-sided: u, v and det - u - v share a sign, the
// hit lies in front and strictly nearer than ``best`` (the first hit found
// keeps a tie). Gives the hit's distance and barycentrics.
__device__ __forceinline__ bool closer_hit(const Moller& m, float best,
                                           float& dist, float& u, float& v) {
  const float duv = m.det - m.u - m.v;
  const bool side = fmaxf(m.u, fmaxf(m.v, duv)) <= 0.0f ||
                    fminf(m.u, fminf(m.v, duv)) >= 0.0f;
  const float idet = 1.0f / (m.det == 0.0f ? 1e-30f : m.det);
  dist = m.tmul * idet;
  u = m.u * idet;
  v = m.v * idet;
  return side && m.det != 0.0f && dist > 0.0f && dist < best;
}

// The shadow rule, one-sided as the reference's (triangle.cpp:95-96): an
// occluder in (0, limit).
__device__ __forceinline__ bool occludes(const Moller& m, float limit) {
  return fminf(m.u, m.v) >= 0.0f && m.u + m.v <= m.det && m.tmul > 0.0f &&
         m.tmul < limit * m.det;
}

// Closest hit of one ray over the ``cnt`` raw rows from ``first``, each
// loaded from global memory (B6; the other closest hits test a staged
// copy of the leaf: walk.cuh leaf_closest_staged, staged_closest_sh
// below).
__device__ __forceinline__ void leaf_closest(const float* rows, int first,
                                             int cnt, const float o[3],
                                             const float d[3], float& best,
                                             int& tri, float& bu, float& bv) {
  for (int j = 0; j < cnt; ++j) {
    float dist, u, v;
    if (closer_hit(moller_raw(o, d, load_raw_row(rows, first + j)), best,
                   dist, u, v)) {
      best = dist;
      tri = first + j;
      bu = u;
      bv = v;
    }
  }
}

// Whether one of the ``cnt`` rows from ``first`` occludes the ray from
// ``o`` along ``d`` before ``limit``: shared-origin rows (``o`` unused),
// or with RAW raw rows and the full Moller test; the ray stops at its
// first blocker. ``tested`` counts the triangles it tested. (B4 on raw
// rows, B8b on shared-origin rows; the other any-hits test their leaves
// through leaf_blocks_staged below.)
template <bool RAW = false>
__device__ __forceinline__ bool leaf_blocks(const float* rows, int first,
                                            int cnt, const float o[3],
                                            const float d[3], float limit,
                                            int& tested) {
  for (int j = 0; j < cnt; ++j) {
    ++tested;
    Moller m;
    if constexpr (RAW)
      m = moller_raw(o, d, load_raw_row(rows, first + j));
    else
      m = moller_sh(d, load_row(rows, first + j));
    if (occludes(m, limit)) return true;
  }
  return false;
}

// --- Staged leaves: a leaf's rows copied once per warp ----------------------
//
// At a leaf some lane enters, a warp copies the leaf's rows into its own
// slice of shared memory, 16 bytes a lane with cp.async: one coalesced
// copy of at most 1.5 KB (32 rows) or 3 KB (64 rows) in place of a chain
// of 32-64 dependent global loads in every entering lane. A staged row
// keeps a, ba, ca and n (48 bytes; the row's pad is not copied), so that
// lanes reading consecutive rows 16 bytes at a time meet no bank
// conflict: 48 B is 12 banks, and the 8 lanes of each quarter-warp phase
// cover the 32 banks once. Used by walk.cuh's closest-hit stage (B9c,
// B11a, B11b), the any-hit stage below (B7, B9b, B9d, B11c, B11d) and
// the shared-origin closest-hit stage at the end (B9a, B9e), and by
// worklist.cu's two-slot stage of B2 (B8a), whose copies overlap its
// tests. A shared-origin row's 48-byte prefix holds n, c1, c2 and tmul,
// so the same copy and bank pattern serve it.

constexpr int kStageVec = 3;  // float4 of a staged row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copies rows first .. first + count - 1 of ``rows`` into the warp's
// ``stage``; every lane of the warp calls it.
__device__ __forceinline__ void stage_leaf(const float* rows, int first,
                                           int count, float4* stage) {
  const int lane = threadIdx.x & 31;
  const float4* src = reinterpret_cast<const float4*>(rows) + (size_t)first * 4;
  __syncwarp();  // every lane is done with the previous leaf's rows
  for (int c = lane; c < count * kStageVec; c += 32) {
    const int r = c / kStageVec;
    cp_async16(stage + c, src + 4 * r + (c - kStageVec * r));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

__device__ __forceinline__ RawRow staged_row(const float4* stage, int j) {
  const float4 a = stage[kStageVec * j], b = stage[kStageVec * j + 1],
               c = stage[kStageVec * j + 2];
  return RawRow{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

// --- The staged any-hit leaf stage of B7, B9b, B9d, B11c and B11d ---------
//
// An any-hit needs one occluder, and its verdict does not depend on the
// order in which a ray tests the rows: every (ray, row) test is the same
// ``occludes(moller_raw(...), limit)`` (B9b's and B9f's on shared-origin
// rows: ``occludes(moller_sh(...), limit)``). So at a leaf some unblocked
// lane enters, the warp stages the leaf's rows (stage_leaf, as walk.cuh's
// closest-hit stage) and tests them one of two ways, by how many lanes
// entered:
// - few (at most LANE_TRI_MAX): lane per triangle. The warp takes the
//   entering rays one at a time, broadcasts the ray and its limit, lane j
//   tests rows j and j + 32, and __any_sync gives the ray's verdict;
// - many: lane per ray, each entering lane looping over the staged rows
//   up to its first occluder.
// Staging B11d's leaves of 33-64 rows 32 at a time, the second half only
// for lanes the first did not block, was slower on the H100: most visits
// need the second half (PERF.md).
// Its staging, branch and broadcast are walk.cuh leaf_closest_staged's,
// line for line: change one, change the other. They are not one template
// because every form of one tried changed the register allocation of
// B11b (fat_closest_kernel), whose SASS stays as it was (PERF.md).

// A staged shared-origin row (ops/traverse.py shared_rows): its 48-byte
// prefix holds n, c1, c2 and tmul.
__device__ __forceinline__ TriRow staged_tri_row(const float4* stage, int j) {
  const float4 a = stage[kStageVec * j], b = stage[kStageVec * j + 1],
               c = stage[kStageVec * j + 2];
  return TriRow{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y};
}

// The Moller terms of staged row j against one ray: raw rows with the
// ray's origin ``o``, or (RAW false) shared-origin rows.
template <bool RAW>
__device__ __forceinline__ Moller staged_moller(const float4* stage, int j,
                                                const float o[3],
                                                const float d[3]) {
  if constexpr (RAW)
    return moller_raw(o, d, staged_row(stage, j));
  else
    return moller_sh(d, staged_tri_row(stage, j));
}

// Whether this lane's ray, if it entered the leaf (``enter``) of ``count``
// (<= MAX_ROWS) rows from ``first``, is occluded before ``limit`` by one
// of them; every lane of the warp calls it, and a lane that did not enter
// gets false. RAW false: shared-origin rows, ``o`` unused. With COUNT
// (leaves of at most 32 rows), ``*tested`` becomes the rows this lane's
// ray needs up to its first occluder, the leaf_blocks loop's count, in
// either way of testing (a lane that did not enter keeps its value).
template <int MAX_ROWS, int LANE_TRI_MAX, bool RAW = true, bool COUNT = false>
__device__ __forceinline__ bool leaf_blocks_staged(
    const float* rows, float4* stage, int first, int count, bool enter,
    const float o[3], const float d[3], float limit, int* tested = nullptr) {
  static_assert(MAX_ROWS % 32 == 0, "rows are tested 32 a step");
  static_assert(!COUNT || MAX_ROWS == 32, "a count is one ballot a ray");
  const int lane = threadIdx.x & 31;
  stage_leaf(rows, first, count, stage);
  const unsigned in = __ballot_sync(kFull, enter);
  bool hit = false;
  if (__popc(in) > LANE_TRI_MAX) {
    if (enter)
      for (int j = 0; j < count; ++j) {
        if constexpr (COUNT) ++*tested;
        if (occludes(staged_moller<RAW>(stage, j, o, d), limit)) {
          hit = true;
          break;
        }
      }
    return hit;
  }
  for (unsigned m = in; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    float ro[3], rd[3];
    for (int k = 0; k < 3; ++k) {
      if constexpr (RAW) ro[k] = __shfl_sync(kFull, o[k], src);
      rd[k] = __shfl_sync(kFull, d[k], src);
    }
    const float rl = __shfl_sync(kFull, limit, src);
    bool occ = false;
#pragma unroll
    for (int r = 0; r < MAX_ROWS / 32; ++r) {
      const int j = lane + 32 * r;
      occ = occ || (j < count &&
                    occludes(staged_moller<RAW>(stage, j, ro, rd), rl));
    }
    if constexpr (COUNT) {
      const unsigned om = __ballot_sync(kFull, occ);
      if (lane == src) {
        hit = om != 0;
        *tested = om ? __ffs(om) : count;
      }
    } else {
      const bool any = __any_sync(kFull, occ);
      if (lane == src) hit = any;
    }
  }
  return hit;
}

// --- The staged shared-origin closest-hit stage of B2, B8a, B9a and B9e --
//
// The closest hit of this lane's ray over the ``count`` (<= 32) staged
// rows of ``slot`` (tri ids from ``first``), if it entered the leaf
// (``go``); every lane of the warp calls it. The rays share the origin
// ``o``: the rows are shared-origin rows (``o`` unused), or with RAW raw
// rows tested with the full Moller test from ``o`` (B2). Updates
// best, tri, bu and bv as a serial loop over the rows would: where at
// most LANE_TRI_MAX lanes
// entered, lane per triangle (the warp takes the entering rays one at a
// time, broadcasts the ray's direction and best, lane j tests row j, and
// a warp argmin over (distance, row) picks the hit, the lower row on a
// tie), else lane per ray over the staged rows. Both keep the serial
// loop's first strictly nearer hit. The stage is the caller's: B2's
// two-slot stage (worklist.cu), B9a's stage_leaf (walk.cu). Every lane
// holds the same origin, so no origin is broadcast.
template <int LANE_TRI_MAX, bool RAW = false>
__device__ __forceinline__ void staged_closest_sh(
    const float4* slot, int first, int count, bool go, const float o[3],
    const float d[3], float& best, int& tri, float& bu, float& bv,
    int lane) {
  const unsigned in = __ballot_sync(kFull, go);
  if (__popc(in) > LANE_TRI_MAX) {
    if (go)
      for (int j = 0; j < count; ++j) {
        float dist, u, v;
        if (closer_hit(staged_moller<RAW>(slot, j, o, d), best, dist, u,
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
    float rd[3];
    for (int k = 0; k < 3; ++k) rd[k] = __shfl_sync(kFull, d[k], src);
    const float rb = __shfl_sync(kFull, best, src);
    // row ``lane``'s hit below rb: a hit's distance is > 0, so its bits
    // order as the floats do, and no hit is ~0u
    unsigned key = ~0u;
    float hu = 0.0f, hv = 0.0f;
    float dist, u, v;
    if (lane < count &&
        closer_hit(staged_moller<RAW>(slot, lane, o, rd), rb, dist, u, v)) {
      key = __float_as_uint(dist);
      hu = u;
      hv = v;
    }
    const unsigned kmin = __reduce_min_sync(kFull, key);
    if (kmin == ~0u) continue;
    const unsigned jmin =
        __reduce_min_sync(kFull, key == kmin ? (unsigned)lane : ~0u);
    const float wu = __shfl_sync(kFull, hu, jmin),
                wv = __shfl_sync(kFull, hv, jmin);
    if (lane == src) {
      best = __uint_as_float(kmin);
      tri = first + (int)jmin;
      bu = wu;
      bv = wv;
    }
  }
}

}  // namespace
