// The volume march for Hopper (sm_90a): V1, the min/max-brick march of
// snail_tpu_torch/volume/vtree.py over every ray of a frame.
//
// Replaces snail_tpu/volume/vtree.py:_march (:115-172), a jax.lax.while_loop
// of jnp ops that XLA compiles into one loop on the TPU; it is not a Pallas
// kernel. Its plain PyTorch version is volume/vtree.py:_march_plain, the
// wrapper ops/march.py. Plain C interface at the bottom, loaded with ctypes,
// compiled with --fmad=false: every product and sum is rounded on its own,
// in the order of the plain version's tensor ops, so V1 equals it bit for
// bit in best and hit_t.
//
// march_kernel<ISO|MIP>: one thread per ray runs the loop body of _march
// until its ray is done or max_steps steps were taken. A step reads the
// coarse (16^3 voxels) and brick (4^3) maxima at the ray's position
// (clamped cell lookups), computes the exact exit planes of both cells plus
// 1e-2, and either skips to one of them or takes a 0.5-voxel step with an
// 8-tap trilinear sample; iso mode accepts a brick whose minimum reaches the
// threshold without the sample.
//
// The lockstep coupling of the mip mode (ROADMAP C19). The JAX loop runs
// every ray's body until no ray is live, and best = max(best, rho) also
// runs for rays already done, at their frozen t. max is idempotent, so its
// result is each ray's own march plus one extra sample at its frozen
// position when the loop's step count K = min(max_steps, max_i k_i)
// exceeds the ray's own k_i (no step at all when every ray starts done).
// In mip mode march_kernel writes k_i and the frozen t and folds k_i into
// K with one atomicMax per warp; mip_extra_kernel, a launch of its own,
// then takes that one step for the rays with k_i < K. Iso mode has no
// coupling (a done ray is never newly hit) and writes neither.
//
// What bounds it on this card: the bytes the march needs over the HBM
// rate, that is the bricks some ray samples (each 4^3-voxel brick, 256
// bytes, read once), the rays' own tables (d, t0, t1 in, best, hit_t out:
// 28 bytes a ray) and the origin all rays of a frame share (12 bytes),
// against the steps the march takes (47 float operations a skip step, 50
// with a sample, counted below) over the float32 rate; the smoke counts
// both from the steps of the plain loop in its run. A 512^2 frame of a
// 512^3 sphere: 262,144 rays, 32,408 bricks, 15.6 MB, 0.0047 ms; the
// operations ~0.003 ms. The kernel is far above that, bound by the latency
// of each step's dependent loads (the cell maxima, then the eight taps),
// hidden only by the warps in flight. The design does the simple thing
// about it: the pyramid tables are small (8 MB each brick table, 128 KB
// the coarse one at 512^3) and stay in L2, the volume is read through the
// read-only path, a shared origin is read once a ray from L1, and there is
// no shared memory, so 9 blocks of 128 threads fit an SM. Rays of one warp
// are neighbouring pixels, whose steps and taps mostly coincide. Beyond
// the bound's bytes, mip mode moves the scratch t and k (8 bytes a ray)
// and the second launch's reads.
//
// Float operations of a step: the position 6; a cell lookup 3 divides and
// its compare; an exit distance 9 per axis and 4 to combine; the sample 9
// and 7 lerps of 4; t's add and compare 2. A skip step: 6 + 4 + 4 + 31 + 2
// = 47; a step with a sample: 6 + 4 + 37 + 1 + 2 = 50 (iso: 4 more where
// the brick minimum is read).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBrick = 4;
constexpr int kCoarse = 16;
constexpr float kFine = 0.5f;

struct Vol {
  const float* __restrict__ vol;
  const float* __restrict__ bmax;
  const float* __restrict__ bmin;
  const float* __restrict__ cmax;
  int d, h, w;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// _cell_lookup: trunc(p / cell) per axis, clamped to the table.
__device__ __forceinline__ float cell_lookup(const float* __restrict__ table,
                                             const Vol& v, float pz, float py,
                                             float px, int cell) {
  const float c = (float)cell;
  const int nz = (v.d + cell - 1) / cell, ny = (v.h + cell - 1) / cell,
            nx = (v.w + cell - 1) / cell;
  const int iz = clampi(__float2int_rz(__fdiv_rn(pz, c)), 0, nz - 1);
  const int iy = clampi(__float2int_rz(__fdiv_rn(py, c)), 0, ny - 1);
  const int ix = clampi(__float2int_rz(__fdiv_rn(px, c)), 0, nx - 1);
  return __ldg(table + ((size_t)iz * ny + iy) * nx + ix);
}

// One axis of _exit_dist: the distance to the exit plane of p's cell.
__device__ __forceinline__ float axis_exit(float p, float dir, float c) {
  const float ib = floorf(__fdiv_rn(p, c));
  const float nxt = __fmul_rn(__fadd_rn(ib, dir > 0.0f ? 1.0f : 0.0f), c);
  const bool tiny = fabsf(dir) < 1e-9f;
  const float safe = tiny ? (dir >= 0.0f ? 1e-9f : -1e-9f) : dir;
  return tiny ? 1e30f : __fdiv_rn(__fsub_rn(nxt, p), safe);
}

// _exit_dist: max(min over the axes, 0) + 1e-2.
__device__ __forceinline__ float exit_dist(float pz, float py, float px,
                                           float dz, float dy, float dx,
                                           int cell) {
  const float c = (float)cell;
  const float m = fminf(fminf(axis_exit(pz, dz, c), axis_exit(py, dy, c)),
                        axis_exit(px, dx, c));
  return __fadd_rn(fmaxf(m, 0.0f), 1e-2f);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // a * (1 - f) + b * f, each operation rounded
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// _sample: the trilinear density at voxel-space p, taps clamped.
__device__ __forceinline__ float sample(const Vol& v, float pz, float py,
                                        float px) {
  const float qz = __fsub_rn(pz, 0.5f), qy = __fsub_rn(py, 0.5f),
              qx = __fsub_rn(px, 0.5f);
  const float fz0 = floorf(qz), fy0 = floorf(qy), fx0 = floorf(qx);
  const float fz = __fsub_rn(qz, fz0), fy = __fsub_rn(qy, fy0),
              fx = __fsub_rn(qx, fx0);
  const int z0 = __float2int_rz(fz0), y0 = __float2int_rz(fy0),
            x0 = __float2int_rz(fx0);
  const int za = clampi(z0, 0, v.d - 1), zb = clampi(z0 + 1, 0, v.d - 1);
  const int ya = clampi(y0, 0, v.h - 1), yb = clampi(y0 + 1, 0, v.h - 1);
  const int xa = clampi(x0, 0, v.w - 1), xb = clampi(x0 + 1, 0, v.w - 1);
  auto at = [&](int z, int y, int x) {
    return __ldg(v.vol + ((size_t)z * v.h + y) * v.w + x);
  };
  const float c00 = lerp_rn(at(za, ya, xa), at(za, ya, xb), fx);
  const float c01 = lerp_rn(at(za, yb, xa), at(za, yb, xb), fx);
  const float c10 = lerp_rn(at(zb, ya, xa), at(zb, ya, xb), fx);
  const float c11 = lerp_rn(at(zb, yb, xa), at(zb, yb, xb), fx);
  const float c0 = lerp_rn(c00, c01, fy);
  const float c1 = lerp_rn(c10, c11, fy);
  return lerp_rn(c0, c1, fz);
}

// The ray's origin: its own row of o, or (o_stride 0) the one origin every
// ray shares.
__device__ __forceinline__ void origin(const float* __restrict__ o,
                                       int o_stride, int i, float& oz,
                                       float& oy, float& ox) {
  const float* r = o + (size_t)o_stride * i;
  oz = r[0];
  oy = r[1];
  ox = r[2];
}

template <bool ISO>
__global__ void __launch_bounds__(kThreads)
march_kernel(Vol v, const float* __restrict__ o, int o_stride,
             const float* __restrict__ d, const float* __restrict__ t0,
             const float* __restrict__ t1, float iso, int n_rays,
             int max_steps, float* __restrict__ best_out,
             float* __restrict__ hit_out, float* __restrict__ t_out,
             int32_t* __restrict__ k_out, int32_t* __restrict__ k_max) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int k = 0;
  if (i < n_rays) {
    float oz, oy, ox;
    origin(o, o_stride, i, oz, oy, ox);
    const float dz = d[3 * i], dy = d[3 * i + 1], dx = d[3 * i + 2];
    const float ta = t0[i], tb = t1[i];
    float t = fmaxf(ta, 0.0f);
    bool done = ta > tb;
    float best = 0.0f, hit_t = -1.0f;
    for (; !done && k < max_steps; ++k) {
      const float pz = __fadd_rn(oz, __fmul_rn(dz, t));
      const float py = __fadd_rn(oy, __fmul_rn(dy, t));
      const float px = __fadd_rn(ox, __fmul_rn(dx, t));
      const float bmax = cell_lookup(v.bmax, v, pz, py, px, kBrick);
      float step;
      if constexpr (ISO) {
        if (bmax >= iso) {
          const float rho = sample(v, pz, py, px);
          if (rho >= iso ||
              cell_lookup(v.bmin, v, pz, py, px, kBrick) >= iso) {
            hit_t = t;
            done = true;
          }
          step = kFine;
        } else {
          step = cell_lookup(v.cmax, v, pz, py, px, kCoarse) < iso
                     ? exit_dist(pz, py, px, dz, dy, dx, kCoarse)
                     : exit_dist(pz, py, px, dz, dy, dx, kBrick);
        }
      } else {
        if (bmax > best) {
          best = fmaxf(best, sample(v, pz, py, px));
          step = kFine;
        } else {
          step = cell_lookup(v.cmax, v, pz, py, px, kCoarse) <= best
                     ? exit_dist(pz, py, px, dz, dy, dx, kCoarse)
                     : exit_dist(pz, py, px, dz, dy, dx, kBrick);
        }
      }
      if (!done) t = __fadd_rn(t, step);
      done = done || t >= tb;
    }
    best_out[i] = best;
    hit_out[i] = hit_t;
    if constexpr (!ISO) {
      t_out[i] = t;
      k_out[i] = k;
    }
  }
  if constexpr (!ISO) {
    // K = max over the rays of k_i (k_i <= max_steps): one atomic a warp
    for (int off = 16; off > 0; off >>= 1)
      k = max(k, __shfl_xor_sync(0xffffffffu, k, off));
    if ((threadIdx.x & 31) == 0 && k > 0) atomicMax(k_max, k);
  }
}

// C19: the one body step the lockstep loop takes, after a mip ray is done,
// at its frozen t: best = max(best, sample) where the brick's max beats it.
__global__ void __launch_bounds__(kThreads)
mip_extra_kernel(Vol v, const float* __restrict__ o, int o_stride,
                 const float* __restrict__ d, int n_rays,
                 const float* __restrict__ t_in,
                 const int32_t* __restrict__ k_in,
                 const int32_t* __restrict__ k_max, float* __restrict__ best) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays || k_in[i] >= *k_max) return;
  const float t = t_in[i];
  float oz, oy, ox;
  origin(o, o_stride, i, oz, oy, ox);
  const float pz = __fadd_rn(oz, __fmul_rn(d[3 * i], t));
  const float py = __fadd_rn(oy, __fmul_rn(d[3 * i + 1], t));
  const float px = __fadd_rn(ox, __fmul_rn(d[3 * i + 2], t));
  const float b = best[i];
  if (cell_lookup(v.bmax, v, pz, py, px, kBrick) > b)
    best[i] = fmaxf(b, sample(v, pz, py, px));
}

}  // namespace

extern "C" {

// march_kernel. mode 0: iso, 1: mip. o: (n_rays, 3), or one origin for
// every ray with o_stride 0 (else 3). Mip mode only: ``t``, ``k`` (R,)
// float32 / int32 scratch for snail_march_mip_extra, ``k_max`` one zeroed
// int32; iso mode takes null for all three.
int snail_march(const float* vol, const float* bmax, const float* bmin,
                const float* cmax, const float* o, int o_stride,
                const float* d, const float* t0, const float* t1, float iso,
                int dz, int dy, int dx, int n_rays, int mode, int max_steps,
                float* best, float* hit_t, float* t, int32_t* k,
                int32_t* k_max, void* stream) {
  if (n_rays <= 0 || dz <= 0 || dy <= 0 || dx <= 0 || max_steps < 0 ||
      (mode != 0 && mode != 1) || (o_stride != 0 && o_stride != 3) ||
      (mode == 1 && (!t || !k || !k_max)))
    return (int)cudaErrorInvalidValue;
  const Vol v{vol, bmax, bmin, cmax, dz, dy, dx};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  auto s = (cudaStream_t)stream;
  if (mode == 0)
    march_kernel<true><<<blocks, kThreads, 0, s>>>(
        v, o, o_stride, d, t0, t1, iso, n_rays, max_steps, best, hit_t,
        nullptr, nullptr, nullptr);
  else
    march_kernel<false><<<blocks, kThreads, 0, s>>>(
        v, o, o_stride, d, t0, t1, iso, n_rays, max_steps, best, hit_t, t,
        k, k_max);
  return (int)cudaGetLastError();
}

// mip_extra_kernel, after snail_march in mip mode on the same rays and
// scratch: C19's extra sample, into ``best``.
int snail_march_mip_extra(const float* vol, const float* bmax,
                          const float* bmin, const float* cmax,
                          const float* o, int o_stride, const float* d,
                          int dz, int dy, int dx, int n_rays, const float* t,
                          const int32_t* k, const int32_t* k_max,
                          float* best, void* stream) {
  if (n_rays <= 0 || dz <= 0 || dy <= 0 || dx <= 0 ||
      (o_stride != 0 && o_stride != 3))
    return (int)cudaErrorInvalidValue;
  const Vol v{vol, bmax, bmin, cmax, dz, dy, dx};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  mip_extra_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      v, o, o_stride, d, n_rays, t, k, k_max, best);
  return (int)cudaGetLastError();
}

}  // extern "C"
