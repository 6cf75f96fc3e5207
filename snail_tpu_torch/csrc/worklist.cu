// Worklist traversal kernels for Hopper (sm_90a): the primary and shadow
// wavefronts of the forward frame.
//
// Replaces, in snail_tpu/ops/traverse_pallas.py:
//   words_kernel<CAMERA>  <- _words_camera_kernel (B1)
//   words_kernel<SHARED>  <- _words_shared_kernel (B3)
//   camera_wl_kernel      <- _camera_wl_kernel    (B2)
//   shadow_wl_kernel      <- _shadow_wl_kernel    (B4)
// The plain PyTorch versions are in snail_tpu_torch/ops/traverse.py, which
// documents the word layout. The file has a plain C interface (bottom) and
// is loaded with ctypes; it is compiled with --fmad=false so every product
// and sum is rounded as in the plain versions.
//
// What bounds these kernels on this card:
// - words: one block per 64x64-pixel packet streams the planar leaf boxes
//   (24 B per leaf) three times and does ~40 flops per leaf and pass. The
//   boxes of a whole scene (1 MB at 44k leaves) stay in the 50 MB L2, so
//   the pass is bound by issue rate, not by device memory. Verdicts become
//   bit words by __ballot_sync, band membership by a 32-bin shared-memory
//   histogram (the TPU packed bits on its matrix unit instead).
// - trace: one thread per ray, warps independent. Each warp scans its
//   packet's bit words in band order (uniform control flow: every lane
//   reads the same word), tests a word's 32 leaves in parallel against
//   the interval and segment box of its own 32 rays, then culls each
//   surviving leaf box against each ray and runs the Moller test only in
//   lanes whose ray passed; triangle rows are 64 B, read as three float4
//   broadcast loads. Bound by the serial per-leaf loop (latency of
//   dependent loads) and divergence; no shared memory and no block
//   barriers. The TPU's grid ran in order and kept a leaf ring and the
//   leaf table staged across grid steps; here all state is per warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.4e37f;
constexpr float kInvEps = 1e-8f;
constexpr int kTile = 64;
constexpr int kPacketR = kTile * kTile;
constexpr int kLeafBlock = 1024;
constexpr int kBins = 32;
constexpr int kMaxBands = 8;
constexpr int kWordsThreads = 256;
constexpr int kTraceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Origin { CAMERA = 0, SHARED = 1 };

// Camera scalars (ops/traverse.py cam_vec): right 0:3, up 3:6,
// front*plane_dist 6:9, pos 9:12, w/2 12, h/2 13, 1/h 14, tiles_x 15,
// root lo 16:19, root hi 19:22.
struct PrimaryRay {
  float d[3];
  float idir[3];
  float t_exit;
};

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
  float tn, tf;
  {
    float t1[3], t2[3];
    for (int c = 0; c < 3; ++c) {
      t1[c] = (cam[16 + c] - cam[9 + c]) * r.idir[c];
      t2[c] = (cam[19 + c] - cam[9 + c]) * r.idir[c];
    }
    tn = fmaxf(fmaxf(fminf(t1[0], t2[0]), fminf(t1[1], t2[1])),
               fminf(t1[2], t2[2]));
    tf = fminf(fminf(fmaxf(t1[0], t2[0]), fmaxf(t1[1], t2[1])),
               fmaxf(t1[2], t2[2]));
  }
  r.t_exit = (tn <= tf && tf > 0.0f) ? tf * 1.0001f : 0.0f;
  return r;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int s = 16; s; s >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// Block-wide min or max of one value per thread; every thread gets it.
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_min(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : (MAX ? -kBig : kBig);
    v = MAX ? warp_max(v) : warp_min(v);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// Conservative widening of a reduced bound pair (traverse.py _widen).
__device__ __forceinline__ float widen_lo(float lo) {
  return lo - fabsf(lo) * 1e-6f - 1e-30f;
}
__device__ __forceinline__ float widen_hi(float hi) {
  return hi + fabsf(hi) * 1e-6f + 1e-30f;
}

struct Interval {
  float o[3];   // shared origin
  float im[3];  // inverse-direction bounds
  float iM[3];
  float mb;     // packet distance bound
};

// Interval entry distance of leaf l; ok = the packet may hit the box.
__device__ __forceinline__ float leaf_entry(const float* box, int lp, int l,
                                            int n_leaf, const Interval& iv,
                                            bool& ok) {
  float tn = 0.0f, tf = iv.mb;
  for (int k = 0; k < 3; ++k) {
    const float a = box[k * lp + l] - iv.o[k];
    const float c = box[(3 + k) * lp + l] - iv.o[k];
    const float a1 = a * iv.im[k], a2 = a * iv.iM[k];
    const float c1 = c * iv.im[k], c2 = c * iv.iM[k];
    tn = fmaxf(tn, fminf(fminf(a1, a2), fminf(c1, c2)));
    tf = fminf(tf, fmaxf(fmaxf(a1, a2), fmaxf(c1, c2)));
  }
  // padding slots never pass: inverted boxes alone are not enough when a
  // direction interval spans zero
  ok = tn <= tf && tf > 0.0f && l < n_leaf;
  return tn;
}

// B1 / B3. One block per packet. Dynamic shared memory: K * NS summary
// words.
template <int MODE>
__global__ void __launch_bounds__(kWordsThreads)
words_kernel(const float* __restrict__ cam_or_orig,
             const float* __restrict__ dx, const float* __restrict__ dy,
             const float* __restrict__ dz, const float* __restrict__ tm,
             const float* __restrict__ box, int lp, int n_leaf, int k_bands,
             int32_t* __restrict__ words, int32_t* __restrict__ summ,
             float* __restrict__ floors) {
  extern __shared__ unsigned s_summ[];
  __shared__ float s_red[32];
  __shared__ int s_hist[kBins];
  __shared__ float s_los[kMaxBands];

  const int pid = blockIdx.x;
  const int nw = lp / 32, ns = lp / kLeafBlock;

  // 1. ray interval bounds of the packet
  float imn[3] = {kBig, kBig, kBig}, imx[3] = {-kBig, -kBig, -kBig};
  float mb_local = -kBig;
  for (int k = threadIdx.x; k < kPacketR; k += blockDim.x) {
    float idir[3];
    if (MODE == CAMERA) {
      const PrimaryRay r = camera_ray(cam_or_orig, pid, k);
      for (int c = 0; c < 3; ++c) idir[c] = r.idir[c];
      mb_local = fmaxf(mb_local, r.t_exit);
    } else {
      const size_t g = (size_t)pid * kPacketR + k;
      idir[0] = 1.0f / (dx[g] + kInvEps);
      idir[1] = 1.0f / (dy[g] + kInvEps);
      idir[2] = 1.0f / (dz[g] + kInvEps);
      const float t = tm[g];
      mb_local = fmaxf(mb_local, t >= 0.0f ? t : -kBig);
    }
    for (int c = 0; c < 3; ++c) {
      imn[c] = fminf(imn[c], idir[c]);
      imx[c] = fmaxf(imx[c], idir[c]);
    }
  }
  Interval iv;
  for (int c = 0; c < 3; ++c) {
    iv.o[c] = cam_or_orig[MODE == CAMERA ? 9 + c : c];
    iv.im[c] = widen_lo(block_reduce<false>(imn[c], s_red));
    iv.iM[c] = widen_hi(block_reduce<true>(imx[c], s_red));
  }
  iv.mb = block_reduce<true>(mb_local, s_red) * 1.0001f + 1e-30f;

  for (int i = threadIdx.x; i < k_bands * ns; i += blockDim.x) s_summ[i] = 0;
  if (threadIdx.x < kBins) s_hist[threadIdx.x] = 0;

  // 2. nearest passing entry -> band range
  float tmin = kBig;
  for (int l = threadIdx.x; l < lp; l += blockDim.x) {
    bool ok;
    const float tn = leaf_entry(box, lp, l, n_leaf, iv, ok);
    if (ok) tmin = fminf(tmin, tn);
  }
  const float t0 = fminf(block_reduce<false>(tmin, s_red), iv.mb);
  const float span = fmaxf(iv.mb - t0, 1e-6f);

  // 3. equal-count band edges from a 32-bin histogram of entry distances
  if (k_bands > 1) {
    const float scale = (float)kBins / span;
    for (int l = threadIdx.x; l < lp; l += blockDim.x) {
      bool ok;
      const float tn = leaf_entry(box, lp, l, n_leaf, iv, ok);
      if (ok) {
        const float f = fminf((tn - t0) * scale, (float)kBins);
        const int b = min(max((int)f, 0), kBins - 1);
        atomicAdd(&s_hist[b], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int c[kBins];
      int run = 0;
      for (int j = 0; j < kBins; ++j) c[j] = (run += s_hist[j]);
      const int total = max(c[kBins - 1], 1);
      s_los[0] = t0;
      for (int b = 1; b < k_bands; ++b) {
        const int tgt = (total * b + k_bands - 1) / k_bands;
        int e = 0;
        for (int j = 0; j < kBins; ++j) e += c[j] < tgt;
        s_los[b] = t0 + (float)e * (span / (float)kBins);
      }
    }
  } else if (threadIdx.x == 0) {
    s_los[0] = t0;
  }
  __syncthreads();

  // 4. verdict bits by ballot, one warp per 32 leaves
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t* wout = words + (size_t)pid * k_bands * nw;
  for (int g = warp; g < nw; g += nwarps) {
    bool ok;
    const float tn = leaf_entry(box, lp, g * 32 + lane, n_leaf, iv, ok);
    int band = 0;
    for (int b = 1; b < k_bands; ++b) band += tn >= s_los[b];
    unsigned mine = 0;
    for (int b = 0; b < k_bands; ++b) {
      const unsigned m = __ballot_sync(kFull, ok && band == b);
      if (lane == b) mine = m;
    }
    if (lane < k_bands) {
      wout[lane * nw + g] = (int32_t)mine;
      if (mine) atomicOr(&s_summ[lane * ns + (g >> 5)], 1u << (g & 31));
    }
  }
  __syncthreads();

  int32_t* sout = summ + (size_t)pid * k_bands * ns;
  for (int i = threadIdx.x; i < k_bands * ns; i += blockDim.x)
    sout[i] = (int32_t)s_summ[i];
  if (threadIdx.x < k_bands) {
    const int b = threadIdx.x;
    unsigned any = 0;
    for (int s = 0; s < ns; ++s) any |= s_summ[b * ns + s];
    floors[pid * k_bands + b] = any ? s_los[b] : kBig;
  }
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

// Per-ray slab test of leaf l: entry distance, and pass = the ray enters
// the box in front of it.
__device__ __forceinline__ float ray_slab(const float* box, int lp, int l,
                                          const float o[3],
                                          const float idir[3], bool& pass) {
  float t1[3], t2[3];
  for (int k = 0; k < 3; ++k) {
    t1[k] = (__ldg(box + k * lp + l) - o[k]) * idir[k];
    t2[k] = (__ldg(box + (3 + k) * lp + l) - o[k]) * idir[k];
  }
  const float tn = fmaxf(fmaxf(fminf(t1[0], t2[0]), fminf(t1[1], t2[1])),
                         fminf(t1[2], t2[2]));
  const float tf = fminf(fminf(fmaxf(t1[0], t2[0]), fmaxf(t1[1], t2[1])),
                         fmaxf(t1[2], t2[2]));
  pass = tn <= tf && tf > 0.0f;
  return tn;
}

// What a warp culls leaves with: the interval bounds of its live rays
// (the words pass's packet test narrowed to 32 rays) and the box around
// their segments from the origin to their distance limits. The box keeps
// the cull tight where a direction interval spans zero (rays straight
// below a light), which the interval test alone cannot.
struct WarpCull {
  Interval iv;
  float lo[3], hi[3];
};

__device__ __forceinline__ WarpCull warp_cull(const float o[3],
                                              const float d[3],
                                              const float idir[3],
                                              float limit) {
  const bool live = limit > 0.0f;
  WarpCull c;
  for (int k = 0; k < 3; ++k) {
    c.iv.o[k] = o[k];
    c.iv.im[k] = widen_lo(warp_min(live ? idir[k] : kBig));
    c.iv.iM[k] = widen_hi(warp_max(live ? idir[k] : -kBig));
    const float end = o[k] + d[k] * limit;
    const float lo = warp_min(live ? fminf(o[k], end) : kBig);
    const float hi = warp_max(live ? fmaxf(o[k], end) : -kBig);
    // widened far beyond rounding: a cull may only ever keep too much
    const float pad = 1e-4f * fmaxf(fabsf(lo), fabsf(hi)) + 1e-4f;
    c.lo[k] = lo - pad;
    c.hi[k] = hi + pad;
  }
  c.iv.mb = 0.0f;
  return c;
}

// The warp-level cull of leaf l: the interval test, then the segment box.
__device__ __forceinline__ bool warp_keeps(const float* box, int lp, int l,
                                           const WarpCull& c) {
  bool ok;
  leaf_entry(box, lp, l, lp, c.iv, ok);
  for (int k = 0; k < 3; ++k)
    ok = ok && box[k * lp + l] <= c.hi[k] && box[(3 + k) * lp + l] >= c.lo[k];
  return ok;
}

// Scan of one packet's words in band order, shared by B2 and B4. Band b
// is skipped once its floor is at or above the warp's bound
// (bound_fn() = max over lanes of the distance still of interest, <= 0
// when the warp is done); every leaf in a band has its interval entry at
// or above the floor. Each word's 32 leaves are first tested in parallel,
// one per lane, against the warp's cull ``wc`` with its current bound (a
// packet whose direction interval spans zero can pass every leaf of a
// scene; its warps' culls do not); leaf_fn(l) then runs for the
// survivors, in order, and returns true to end the scan.
template <typename BoundFn, typename LeafFn>
__device__ __forceinline__ void scan_words(const int32_t* words,
                                           const int32_t* summ,
                                           const float* floors, int k_bands,
                                           int nw, int ns, const float* box,
                                           int lp, WarpCull& wc,
                                           BoundFn bound_fn, LeafFn leaf_fn) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < k_bands; ++b) {
    const float bound = bound_fn();
    if (!(bound > 0.0f)) return;
    if (floors[b] >= bound) continue;
    for (int s = 0; s < ns; ++s) {
      unsigned sw = (unsigned)summ[b * ns + s];
      while (sw) {
        const int w = s * 32 + __ffs(sw) - 1;
        sw &= sw - 1;
        unsigned word = (unsigned)words[b * nw + w];
        wc.iv.mb = bound_fn();
        if (!(wc.iv.mb > 0.0f)) return;
        const bool ok = ((word >> lane) & 1u) &&
                        warp_keeps(box, lp, w * 32 + lane, wc);
        word = __ballot_sync(kFull, ok);
        while (word) {
          const int l = w * 32 + __ffs(word) - 1;
          word &= word - 1;
          if (leaf_fn(l)) return;
        }
      }
    }
  }
}

// B2: camera raygen + closest hit, one thread per ray.
__global__ void __launch_bounds__(kTraceThreads)
camera_wl_kernel(const float* __restrict__ cam, const float* __restrict__ rows,
                 const float* __restrict__ box,
                 const int32_t* __restrict__ lfirst,
                 const int32_t* __restrict__ lcount, int lp,
                 const int32_t* __restrict__ words,
                 const int32_t* __restrict__ summ,
                 const float* __restrict__ floors, int k_bands,
                 float* __restrict__ out_dist, float* __restrict__ out_u,
                 float* __restrict__ out_v, int32_t* __restrict__ out_tri,
                 float* __restrict__ out_dx, float* __restrict__ out_dy,
                 float* __restrict__ out_dz) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(g / kPacketR), k = (int)(g % kPacketR);
  const int nw = lp / 32, ns = lp / kLeafBlock;
  const PrimaryRay r = camera_ray(cam, pid, k);
  const float o[3] = {cam[9], cam[10], cam[11]};
  float best = r.t_exit, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  // a ray that misses the root box (best = 0) can hit nothing
  WarpCull wc = warp_cull(o, r.d, r.idir, best);

  scan_words(
      words + (size_t)pid * k_bands * nw, summ + (size_t)pid * k_bands * ns,
      floors + (size_t)pid * k_bands, k_bands, nw, ns, box, lp, wc,
      [&] { return warp_max(fmaxf(best, 0.0f)); },
      [&](int l) {
        bool pass;
        const float tn = ray_slab(box, lp, l, o, r.idir, pass);
        if (pass && tn < best) {
          const int first = __ldg(lfirst + l), cnt = __ldg(lcount + l);
          for (int j = 0; j < cnt; ++j) {
            const TriRow t = load_row(rows, first + j);
            const float det = r.d[0] * t.nx + r.d[1] * t.ny + r.d[2] * t.nz;
            const float u = r.d[0] * t.c1x + r.d[1] * t.c1y + r.d[2] * t.c1z;
            const float v = r.d[0] * t.c2x + r.d[1] * t.c2y + r.d[2] * t.c2z;
            const float duv = det - u - v;
            // two-sided: u, v and det - u - v share a sign
            const bool side = fmaxf(u, fmaxf(v, duv)) <= 0.0f ||
                              fminf(u, fminf(v, duv)) >= 0.0f;
            const float idet = 1.0f / (det == 0.0f ? 1e-30f : det);
            const float dist = t.tmul * idet;
            // strictly nearer only: the first hit found keeps a tie
            if (side && det != 0.0f && dist > 0.0f && dist < best) {
              best = dist;
              tri = first + j;
              bu = u * idet;
              bv = v * idet;
            }
          }
        }
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

// B4: any-hit from a shared origin, one thread per ray; a warp stops once
// every live ray in it is blocked.
__global__ void __launch_bounds__(kTraceThreads)
shadow_wl_kernel(const float* __restrict__ orig, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const float* __restrict__ tm, const float* __restrict__ rows,
                 const float* __restrict__ box,
                 const int32_t* __restrict__ lfirst,
                 const int32_t* __restrict__ lcount, int lp,
                 const int32_t* __restrict__ words,
                 const int32_t* __restrict__ summ,
                 const float* __restrict__ floors, int k_bands,
                 float* __restrict__ out_blocked) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(g / kPacketR);
  const int nw = lp / 32, ns = lp / kLeafBlock;
  const float o[3] = {orig[0], orig[1], orig[2]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float tmax = tm[g];
  const float limit = tmax >= 0.0f ? tmax : -kBig;
  bool blocked = false;
  WarpCull wc = warp_cull(o, d, idir, limit);

  scan_words(
      words + (size_t)pid * k_bands * nw, summ + (size_t)pid * k_bands * ns,
      floors + (size_t)pid * k_bands, k_bands, nw, ns, box, lp, wc,
      [&] { return warp_max(fmaxf(blocked ? -kBig : limit, 0.0f)); },
      [&](int l) {
        const float lim = blocked ? -kBig : limit;
        bool pass;
        const float tn = ray_slab(box, lp, l, o, idir, pass);
        if (pass && tn < lim) {
          const int first = __ldg(lfirst + l), cnt = __ldg(lcount + l);
          for (int j = 0; j < cnt && !blocked; ++j) {
            const TriRow t = load_row(rows, first + j);
            const float det = d[0] * t.nx + d[1] * t.ny + d[2] * t.nz;
            const float u = d[0] * t.c1x + d[1] * t.c1y + d[2] * t.c1z;
            const float v = d[0] * t.c2x + d[1] * t.c2y + d[2] * t.c2z;
            // one-sided, as the reference's shadow test (triangle.cpp:95-96)
            blocked = fminf(u, v) >= 0.0f && u + v <= det &&
                      t.tmul > 0.0f && t.tmul < limit * det;
          }
        }
        return __all_sync(kFull, blocked || !(limit > 0.0f));
      });

  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

int words_smem(int k_bands, int lp) {
  return k_bands * (lp / kLeafBlock) * (int)sizeof(unsigned);
}

bool words_args_ok(int lp, int n_leaf, int k_bands, int n_packets) {
  return lp > 0 && lp % kLeafBlock == 0 && n_leaf <= lp && k_bands >= 1 &&
         k_bands <= kMaxBands && n_packets > 0 &&
         words_smem(k_bands, lp) <= 48 * 1024;
}

}  // namespace

extern "C" {

int snail_words_camera(const float* cam, const float* box, int lp, int n_leaf,
                       int k_bands, int n_packets, int32_t* words,
                       int32_t* summ, float* floors, void* stream) {
  if (!words_args_ok(lp, n_leaf, k_bands, n_packets))
    return (int)cudaErrorInvalidValue;
  words_kernel<CAMERA>
      <<<n_packets, kWordsThreads, words_smem(k_bands, lp),
         (cudaStream_t)stream>>>(cam, nullptr, nullptr, nullptr, nullptr, box,
                                 lp, n_leaf, k_bands, words, summ, floors);
  return (int)cudaGetLastError();
}

int snail_words_shared(const float* orig, const float* dx, const float* dy,
                       const float* dz, const float* tm, const float* box,
                       int lp, int n_leaf, int k_bands, int n_packets,
                       int32_t* words, int32_t* summ, float* floors,
                       void* stream) {
  if (!words_args_ok(lp, n_leaf, k_bands, n_packets))
    return (int)cudaErrorInvalidValue;
  words_kernel<SHARED>
      <<<n_packets, kWordsThreads, words_smem(k_bands, lp),
         (cudaStream_t)stream>>>(orig, dx, dy, dz, tm, box, lp, n_leaf,
                                 k_bands, words, summ, floors);
  return (int)cudaGetLastError();
}

int snail_camera_wl(const float* cam, const float* rows, const float* box,
                    const int32_t* lfirst, const int32_t* lcount, int lp,
                    const int32_t* words, const int32_t* summ,
                    const float* floors, int k_bands, int n_packets,
                    float* dist, float* u, float* v, int32_t* tri, float* dx,
                    float* dy, float* dz, void* stream) {
  if (lp <= 0 || lp % kLeafBlock || k_bands < 1 || n_packets <= 0)
    return (int)cudaErrorInvalidValue;
  camera_wl_kernel<<<n_packets * (kPacketR / kTraceThreads), kTraceThreads, 0,
                     (cudaStream_t)stream>>>(
      cam, rows, box, lfirst, lcount, lp, words, summ, floors, k_bands, dist,
      u, v, tri, dx, dy, dz);
  return (int)cudaGetLastError();
}

int snail_shadow_wl(const float* orig, const float* dx, const float* dy,
                    const float* dz, const float* tm, const float* rows,
                    const float* box, const int32_t* lfirst,
                    const int32_t* lcount, int lp, const int32_t* words,
                    const int32_t* summ, const float* floors, int k_bands,
                    int n_packets, float* blocked, void* stream) {
  if (lp <= 0 || lp % kLeafBlock || k_bands < 1 || n_packets <= 0)
    return (int)cudaErrorInvalidValue;
  shadow_wl_kernel<<<n_packets * (kPacketR / kTraceThreads), kTraceThreads, 0,
                     (cudaStream_t)stream>>>(
      orig, dx, dy, dz, tm, rows, box, lfirst, lcount, lp, words, summ,
      floors, k_bands, blocked);
  return (int)cudaGetLastError();
}

}  // extern "C"
