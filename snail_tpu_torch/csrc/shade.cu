// The hit-row gather of the forward frame for Hopper (sm_90a):
// surface_gather_kernel, the sh_pack columns that one traced wavefront's
// shading reads (render/fast.py _surface).
//
// It replaces no kernel of the JAX package: there the gather is a jnp
// take of scene.sh_pack, which XLA fuses into the shading that reads it.
// In eager PyTorch the same gather was one index_select of the whole
// 128-byte row of every ray, read back by each elementwise op of the
// shading through a stride-32 view. Its plain PyTorch version is the CPU
// path of ops/gather.py surface_rows, the wrapper. Plain C interface at
// the bottom, loaded with ctypes.
//
// One thread per ray. The ray's row is tri where 0 < dist < kBig (a hit)
// and row 0 otherwise (a miss), as render/fast.py's
// torch.where(hit, tri, 0). The requested columns are a bit mask, the same
// for every thread: the kernel reads, with 16-byte read-only loads, only
// the 4-column chunks of the row that hold one, and writes the requested
// columns in increasing order, each to its own contiguous (n_rays,) plane
// of the (C, n_rays) output, so a warp's 32 stores to a plane are one
// 128-byte line. It copies float32 bits and computes nothing, so it equals
// the plain version bit for bit. A hit whose tri lies outside the table
// (the traversal kernels give none) reads row 0, as the plain version
// does, never memory beyond the table.
//
// What bounds it on this card: bytes. A ray needs its dist and tri (8
// bytes), the 32-byte sectors of its row that hold a requested chunk, once
// for all the rays that hit that row, and 4 bytes a plane written. With
// the forward frame's 17 columns (the normal rows 0:9, the material's
// 16:24) that is three of the row's four sectors: at most 96 + 8 + 68 =
// 172 bytes a ray, 0.72 GB for a 2048^2 wavefront, 0.22 ms at 3.35 TB/s.
// The design does the simple thing about it: no shared memory, every load
// of a thread issued before its first store, 256 threads a block; rays of
// neighbouring pixels often hit one triangle, so their sectors come from
// L1 or L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e37f;  // core/vecmath.py BIG
constexpr int kRowCols = 32;     // sh_pack's columns
constexpr int kChunks = kRowCols / 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
surface_gather_kernel(const float4* __restrict__ rows, int n_rows,
                      const float* __restrict__ dist,
                      const int32_t* __restrict__ tri, int n_rays,
                      uint32_t cols, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float d = dist[i];
  int r = (d > 0.0f && d < kBig) ? tri[i] : 0;
  if ((unsigned)r >= (unsigned)n_rows) r = 0;
  const float4* row = rows + (size_t)r * kChunks;
  float v[kRowCols];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if ((cols >> (4 * c)) & 0xFu) {
      const float4 q = __ldg(row + c);
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
  }
  size_t at = (size_t)i;
#pragma unroll
  for (int k = 0; k < kRowCols; ++k) {
    if ((cols >> k) & 1u) {
      out[at] = v[k];
      at += (size_t)n_rays;
    }
  }
}

}  // namespace

extern "C" {

// surface_gather_kernel over n_rays rays. rows: (n_rows, 32) float32,
// contiguous, 16-byte aligned; dist float32, tri int32, (n_rays,); cols:
// the mask of the row's columns to gather (bit k: column k); out:
// (popcount(cols), n_rays) float32, the columns in increasing order.
int snail_surface_gather(const float* rows, int n_rows, const float* dist,
                         const int32_t* tri, int n_rays, uint32_t cols,
                         float* out, void* stream) {
  if (n_rows <= 0 || n_rays <= 0 || cols == 0u ||
      (reinterpret_cast<uintptr_t>(rows) & 15u))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  surface_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rows), n_rows, dist, tri, n_rays, cols,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
