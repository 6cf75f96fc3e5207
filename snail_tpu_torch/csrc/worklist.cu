// Worklist traversal kernels for Hopper (sm_90a): the primary, shadow and
// bounce wavefronts of the frame.
//
// Replaces, in snail_tpu/ops/traverse_pallas.py:
//   words_cluster_kernel<CAMERA>  <- _words_camera_kernel  (B1)
//   words_cluster_kernel<SHARED>  <- _words_shared_kernel  (B3)
//   words_cluster_kernel<GENERAL> <- _words_general_kernel (B5)
//   camera_wl_kernel<false> <- _camera_wl_kernel, raw=True (B2)
//   shadow_wl_kernel<false> <- _shadow_wl_kernel, raw=True (B4)
//   closest_wl_g_kernel   <- _closest_wl_kernel_g  (B6)
//   shadow_wl_g_kernel    <- _shadow_wl_kernel_g   (B7)
//   camera_wl_kernel<true> <- _camera_wl_kernel_stats (B8a)
//   shadow_wl_kernel<true> <- _shadow_wl_kernel_stats (B8b)
// The plain PyTorch versions are in snail_tpu_torch/ops/traverse.py, which
// documents the word layout. The file has a plain C interface (bottom) and
// is loaded with ctypes; it is compiled with --fmad=false so every product
// and sum is rounded as in the plain versions. The ray, slab and Moller
// helpers it shares with the walk kernels (walk.cu) are in rays.cuh.
//
// What bounds these kernels on this card:
// - words (B1, B3, B5): per 64x64-pixel packet, the ray interval's bounds
//   (B1 generates its 4,096 camera rays; B3 and B5 read 4 or 7 planes of
//   4,096 floats), then ~45 flops (B5 ~87: an origin interval) of interval
//   test per leaf. The TPU tested every leaf; here a packet tests each
//   32-leaf word's box first (LeafTables wbox, 1/32 of the leaf boxes)
//   and only the leaves of the words that pass (of terrain_724's 1,408
//   words a primary packet passes ~54, a shadow packet ~80 and at most
//   all, a reflection packet ~780), each once, kept in shared memory for
//   the histogram and the verdicts. A packet is split over a thread block
//   cluster (B1 2 blocks, B3 and B5 4: ops/traverse.py WORDS_CLUSTER),
//   whose blocks store their partial results into each other's shared
//   memory: the ray reduction, the pre-test and the leaf entries are
//   spread over the cluster's SMs. A block's chain of dependent steps and
//   cluster barriers, not its arithmetic, sets the time: at 64 registers
//   four blocks fit an SM, and a cluster size past one wave of blocks
//   (two per packet at 256 packets) pays that chain once more per wave.
//   Verdicts become bit words by __ballot_sync, band membership by a
//   32-bin shared-memory histogram (the TPU packed bits on its matrix
//   unit instead). The boxes of a whole scene (1 MB at 44k leaves) stay
//   in the 50 MB L2: the words passes are bound by latency and issue
//   rate, not by device memory.
// - trace: one thread per ray, warps independent. Each warp scans its
//   packet's bit words in band order (uniform control flow: every lane
//   reads the same word), tests a word's 32 leaves in parallel against
//   the interval and segment box of its own 32 rays, then culls each
//   surviving leaf box against each ray and runs the Moller test only in
//   lanes whose ray passed. B2 (B8a) takes a warp's rays from an 8 x 4
//   pixel tile, not a 32 x 1 row, and stages its leaves: the word's ballot
//   gives a warp its kept leaves up front, so it copies the next one's
//   rows (48 B each) into one slot of a two-slot stage with cp.async
//   while it tests the current one from the other, reads each leaf's box
//   from a word table its lanes filled, and tests lane per ray (lane per
//   triangle where few lanes enter). Bound by the serial per-leaf loop
//   (latency of dependent loads) and divergence; no block barriers. The
//   TPU's grid ran in order and kept a leaf ring and the leaf table
//   staged across grid steps; here all state is per warp.
// - B4, B6 and B7 (and B8b) scan with scan_boxes: ahead of the leaf level a
//   warp skips each 1024-leaf block and each 32-leaf word whose box
//   (LeafTables bbox/wbox, built once per scene) no lane's ray enters
//   before its current limit, so it works in proportion to the words its
//   rays enter, not to its packet's word list (B6's wide reflection
//   packets keep ~760 words a warp, of which its rays enter ~20). B6
//   reads a word's leaf boxes from shared memory, where cp.async brought
//   them during the previous word. B2's coherent primary warps scan ~15
//   words, and its leaf-level cull already drops the words the boxes
//   would skip: on scan_boxes it was slower, so it keeps scan_words. The
//   slab and Moller tests are float32
//   compares and sums of products of a ray with one box or triangle at a
//   time: no matrix product the tensor cores could take.
// - bounce rays (B5, B6) have an origin per ray: the packet and warp
//   intervals carry origin bounds too, and the leaf test takes the four
//   corner products of origin and inverse-direction bounds per slab. B6
//   intersects the raw 64-B rows (a, ba, ca, n) with the full Moller test,
//   ~2x the flops of the shared-origin test. A 64x64 tile's reflections
//   are far less coherent than its primaries, so its packet interval
//   keeps more leaves; the warp culls are what keep the scan short.
// - B7 is B4 with an origin per ray, on B6's raw rows and warp culls: the
//   full Moller terms (~2x B4's flops per triangle) and B4's exit once
//   every live ray of a warp is blocked. Its leaves go through the staged
//   any-hit leaf stage of the node-table any-hits (rays.cuh
//   leaf_blocks_staged): the instanced frame's shadow rays enter a leaf a
//   few lanes at a time, and an unblocked lane tests every row, so one
//   coalesced copy of the leaf and a lane per triangle replace each
//   entering lane's chain of dependent row loads.
// - B2 and B4 test the raw triangle rows with the full Moller test from
//   the shared origin (the JAX package's raw=True form, which it takes
//   above 2^31 bytes of its 512-B rows): ~2x the flops of a test on a
//   shared-origin row and the same 48 staged bytes a row, but no table of
//   T x 64 bytes (ops/traverse.py shared_rows) written and read each frame
//   and light; at every size the port measured that table cost more than
//   the flops it saves (PERF.md).
// - B8a/B8b are B2/B4 with counters (template STATS; with STATS=false no
//   counting code is compiled in). They take shared-origin rows, as the
//   JAX package's counter frame does at every size (:3665). Every
//   counter is warp-uniform, kept in registers and added to the packet's
//   row by one integer atomicAdd per counter and warp at the end:
//   order-free, so deterministic. Their cost is a few warp votes per word
//   and leaf.

#include <cooperative_groups.h>

#include "rays.cuh"

namespace {

constexpr int kLeafBlock = 1024;
constexpr int kBins = 32;
constexpr int kMaxBands = 8;
constexpr int kWordsThreads = 256;
constexpr int kTraceThreads = 256;
// The most rows of a leaf: IVAL_LEAF (leaf tables hold no larger one:
// ops/traverse.py pack_leaf_tables); the rows of a warp's leaf stage.
constexpr int kWlLeafRows = 32;
// B2's (B8a's) leaf stage: a leaf is tested lane per triangle where at
// most kCamLaneTriMax lanes enter it, lane per ray above (set by a sweep
// on the H100, PERF.md).
constexpr int kCamLaneTriMax = 12;
// The words passes' dynamic shared memory at most: the 48 KB a block may
// hold without opting in, less room for its static shared memory.
constexpr int kWordsSmem = 44 * 1024;
// The most leaf slots the words passes take (ops/traverse.py WL_MAX_LP):
// at 8 bands and one block a packet their list and summary words take
// 40,224 B of kWordsSmem's 45,056, so every cluster size keeps some
// entries.
constexpr int kMaxLp = 419 * kLeafBlock;
constexpr int kMaxRanks = 8;  // the most blocks a words pass's packet takes
// Blocks of the words passes an SM holds at once (their registers): four
// of 256 threads, at most 64 registers a thread.
constexpr int kWordsBlocks = 4;

// The origin of a words pass's rays: the camera's, one shared origin, or
// one per ray.
enum Origin { CAMERA = 0, SHARED = 1, GENERAL = 2 };

// Conservative widening of a reduced bound pair (traverse.py _widen).
__device__ __forceinline__ float widen_lo(float lo) {
  return lo - fabsf(lo) * 1e-6f - 1e-30f;
}
__device__ __forceinline__ float widen_hi(float hi) {
  return hi + fabsf(hi) * 1e-6f + 1e-30f;
}

struct Interval {
  float om[3];  // origin bounds; a shared origin has om == oM
  float oM[3];
  float im[3];  // inverse-direction bounds
  float iM[3];
  float mb;     // packet distance bound
};

// Interval entry distance of leaf l; ok = the packet may hit the box.
// GEN: the origin is an interval, and each slab distance (x - o) * i is
// bounded by its four corner products (_leaf_pass :2671-2684); otherwise
// om is the one origin and two products suffice.
template <bool GEN>
__device__ __forceinline__ float leaf_entry(const float* box, int lp, int l,
                                            int n_leaf, const Interval& iv,
                                            bool& ok) {
  float tn = 0.0f, tf = iv.mb;
  for (int k = 0; k < 3; ++k) {
    const float lo = box[k * lp + l], hi = box[(3 + k) * lp + l];
    if (GEN) {
      const float a1 = lo - iv.om[k], a2 = lo - iv.oM[k];
      const float c1 = hi - iv.om[k], c2 = hi - iv.oM[k];
      const float p0 = a1 * iv.im[k], p1 = a1 * iv.iM[k];
      const float p2 = a2 * iv.im[k], p3 = a2 * iv.iM[k];
      const float q0 = c1 * iv.im[k], q1 = c1 * iv.iM[k];
      const float q2 = c2 * iv.im[k], q3 = c2 * iv.iM[k];
      const float lo_min = fminf(fminf(p0, p1), fminf(p2, p3));
      const float lo_max = fmaxf(fmaxf(p0, p1), fmaxf(p2, p3));
      const float hi_min = fminf(fminf(q0, q1), fminf(q2, q3));
      const float hi_max = fmaxf(fmaxf(q0, q1), fmaxf(q2, q3));
      tn = fmaxf(tn, fminf(lo_min, hi_min));
      tf = fminf(tf, fmaxf(lo_max, hi_max));
    } else {
      const float a = lo - iv.om[k];
      const float c = hi - iv.om[k];
      const float a1 = a * iv.im[k], a2 = a * iv.iM[k];
      const float c1 = c * iv.im[k], c2 = c * iv.iM[k];
      tn = fmaxf(tn, fminf(fminf(a1, a2), fminf(c1, c2)));
      tf = fminf(tf, fmaxf(fmaxf(a1, a2), fmaxf(c1, c2)));
    }
  }
  // padding slots never pass: inverted boxes alone are not enough when a
  // direction interval spans zero
  ok = tn <= tf && tf > 0.0f && l < n_leaf;
  return tn;
}

// The words passes' shared memory of one cluster rank (words_layout): the
// entries of up to ``cap`` passing words (32 floats each), the summary
// words of every band, and the list of the rank's words that pass the
// pre-test (one 16-bit index each). ``cap`` is as many words as fit in
// kWordsSmem, at most the rank's share; at one band the verdicts need no
// entries, and ``cap`` is 0.
struct WordsLayout {
  int per;    // words per rank: whole 32-leaf words, contiguous
  int cap;    // words per rank whose entries shared memory holds
  int bytes;  // dynamic shared memory
};

__host__ __device__ inline WordsLayout words_layout(int lp, int k_bands,
                                                    int n_ranks) {
  const int nw = lp / 32, ns = lp / kLeafBlock;
  WordsLayout w;
  w.per = (nw + n_ranks - 1) / n_ranks;
  const int fixed = k_bands * ns * 4 + (w.per * 2 + 3) / 4 * 4;
  const int room = (kWordsSmem - fixed) / (32 * 4);
  w.cap = k_bands == 1 || room < 0 ? 0 : room < w.per ? room : w.per;
  w.bytes = w.cap * 32 * 4 + fixed;
  return w;
}

// The split cluster barrier: every thread arrives early and waits before
// its block first stores into another block's shared memory, which is
// safe once every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// B1, B3 and B5: the leaf pass of one packet over a thread block cluster
// (blocks pid * n_ranks + rank; the cluster size is the launch's: 1, 2, 4
// or 8). MODE: CAMERA, the primary rays of the camera vector ``origin``
// (B1, raygen in the kernel); SHARED, rays from the one origin ``origin``
// with the planes dx, dy, dz, tm (B3); GENERAL, rays with their own
// origins, the planes ox, oy, oz too (B5). The ranks exchange partial
// results by storing them into each other's shared memory (a store does
// not wait for the other SM, a load would), then one cluster barrier.
// 1. Rank r reduces the bounds of rays [r, r + 1) * kPacketR / n_ranks;
//    with the other ranks' partials every rank holds the packet interval.
// 2. Rank r owns the words [r, r + 1) * per. One thread a word tests the
//    word's box (LeafTables wbox) against the interval with the leaves'
//    own test (leaf_entry); a word whose box fails gets 0 in every band,
//    and its leaves are not tested: a leaf box lies in its word's, and each
//    corner product (x - o) * i is monotone in x under rounding for a
//    fixed o and i, so the leaf's entry is at or above the word's and its
//    exit at or below (scan_boxes' argument). Where a bound of the
//    interval is not finite, 0 x inf = NaN would break that, and every
//    word passes. The words that pass go to a list in shared memory.
// 3. One warp a listed word computes each leaf's entry once (NaN where the
//    leaf fails: a passing entry is never NaN), keeps it in shared memory
//    if the word is among the first ``cap`` of the list (the rest are
//    recomputed where read), and the rank's nearest entry. At one band
//    the ballot of the passing leaves is the word, and nothing is kept.
// 4. At more bands the ranks' nearest entries, then their 32-bin
//    histograms of the kept entries, give every rank the same band edges;
//    then one warp a listed word ballots its verdicts.
// Every rank ORs its summary words into rank 0's; after the last barrier
// rank 0 writes them and the floors. Min, max and integer sums do not
// depend on order, nor on which listed words keep their entries: words,
// summaries and floors are the plain version's bit for bit, at every
// cluster size.
template <int MODE>
__global__ void __launch_bounds__(kWordsThreads, kWordsBlocks)
words_cluster_kernel(const float* __restrict__ origin,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tm,
                     const float* __restrict__ box,
                     const float* __restrict__ wbox, int lp, int n_leaf,
                     int k_bands, int32_t* __restrict__ words,
                     int32_t* __restrict__ summ,
                     float* __restrict__ floors) {
  namespace cg = cooperative_groups;
  constexpr bool GEN = MODE == GENERAL;
  cg::cluster_group cluster = cg::this_cluster();
  // bounds of the packet interval, reduced by min (the first kMins) or max:
  // origin lo.xyz, inverse-direction lo.xyz, origin hi.xyz,
  // inverse-direction hi.xyz, distance bound. A shared origin reduces no
  // origin bounds.
  constexpr int kMins = 6, kBounds = 13, kWarps = kWordsThreads / 32;
  auto used = [](int i) { return GEN || i == 12 || i % 6 >= 3; };
  extern __shared__ float s_tn[];
  __shared__ float s_warp[kWarps][kBounds];
  // what each rank stored here: its bounds, nearest entry and histogram
  __shared__ float s_bounds[kMaxRanks][kBounds];
  __shared__ float s_tmin[kMaxRanks];
  __shared__ int s_hists[kMaxRanks][kBins];
  __shared__ float s_all[kBounds];  // the cluster's bounds
  __shared__ int s_hist[kBins];
  __shared__ float s_los[kMaxBands];
  __shared__ int s_n;  // the rank's words that pass the pre-test

  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pid = blockIdx.x / n_ranks;
  const int nw = lp / 32, ns = lp / kLeafBlock;
  const WordsLayout lay = words_layout(lp, k_bands, n_ranks);
  const int w0 = min(rank * lay.per, nw), n_own = min(lay.per, nw - w0);
  unsigned* s_summ = reinterpret_cast<unsigned*>(s_tn + lay.cap * 32);
  unsigned short* s_list =
      reinterpret_cast<unsigned short*>(s_summ + k_bands * ns);
  unsigned* r0_summ = cluster.map_shared_rank(s_summ, 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float kNone = __int_as_float(0x7fffffff);  // NaN: the leaf fails
  cluster_arrive();

  // 1. the packet interval: this rank's rays, then the cluster's
  float v[kBounds];
  for (int i = 0; i < kBounds; ++i) v[i] = i < kMins ? kBig : -kBig;
  const int share = kPacketR / n_ranks;
  for (int k = rank * share + threadIdx.x; k < (rank + 1) * share;
       k += kWordsThreads) {
    float idir[3], t;
    if constexpr (MODE == CAMERA) {
      const PrimaryRay r = camera_ray(origin, pid, k);
      for (int c = 0; c < 3; ++c) idir[c] = r.idir[c];
      t = r.t_exit;
    } else {
      const size_t g = (size_t)pid * kPacketR + k;
      idir[0] = 1.0f / (dx[g] + kInvEps);
      idir[1] = 1.0f / (dy[g] + kInvEps);
      idir[2] = 1.0f / (dz[g] + kInvEps);
      const float tg = tm[g];
      t = tg >= 0.0f ? (GEN ? fminf(tg, kBig) : tg) : -kBig;
      if constexpr (GEN) {
        const float o[3] = {ox[g], oy[g], oz[g]};
        for (int c = 0; c < 3; ++c) {
          v[c] = fminf(v[c], o[c]);
          v[6 + c] = fmaxf(v[6 + c], o[c]);
        }
      }
    }
    for (int c = 0; c < 3; ++c) {
      v[3 + c] = fminf(v[3 + c], idir[c]);
      v[9 + c] = fmaxf(v[9 + c], idir[c]);
    }
    v[12] = fmaxf(v[12], t);
  }
  for (int i = 0; i < kBounds; ++i) {
    if (!used(i)) continue;
    const float r = i < kMins ? warp_min(v[i]) : warp_max(v[i]);
    if (lane == 0) s_warp[warp][i] = r;
  }
  for (int i = threadIdx.x; i < k_bands * ns; i += kWordsThreads)
    s_summ[i] = 0;
  if (threadIdx.x < kBins) s_hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  cluster_wait();
  if (threadIdx.x < kBounds && used(threadIdx.x)) {
    const int i = threadIdx.x;
    float a = s_warp[0][i];
    for (int w = 1; w < kWarps; ++w)
      a = i < kMins ? fminf(a, s_warp[w][i]) : fmaxf(a, s_warp[w][i]);
    for (int r = 0; r < n_ranks; ++r)
      cluster.map_shared_rank(&s_bounds[rank][i], r)[0] = a;
  }
  cluster.sync();
  if (threadIdx.x < kBounds && used(threadIdx.x)) {
    const int i = threadIdx.x;
    float a = s_bounds[0][i];
    for (int r = 1; r < n_ranks; ++r)
      a = i < kMins ? fminf(a, s_bounds[r][i]) : fmaxf(a, s_bounds[r][i]);
    s_all[i] = a;
  }
  __syncthreads();
  Interval iv;
  bool tame = true;  // every bound finite: the word-box pre-test is exact
  for (int c = 0; c < 3; ++c) {
    if constexpr (GEN) {
      iv.om[c] = widen_lo(s_all[c]);
      iv.oM[c] = widen_hi(s_all[6 + c]);
    } else {
      iv.om[c] = iv.oM[c] = origin[MODE == CAMERA ? 9 + c : c];
    }
    iv.im[c] = widen_lo(s_all[3 + c]);
    iv.iM[c] = widen_hi(s_all[9 + c]);
    tame = tame && isfinite(iv.om[c]) && isfinite(iv.oM[c]) &&
           isfinite(iv.im[c]) && isfinite(iv.iM[c]);
  }
  iv.mb = s_all[12] * 1.0001f + 1e-30f;

  // 2. the word-box pre-test, one word a thread: a word that fails is 0 in
  // every band, one that passes goes to the list
  int32_t* wout = words + (size_t)pid * k_bands * nw;
  for (int i0 = warp * 32; i0 < n_own; i0 += kWordsThreads) {
    const int i = i0 + lane;
    bool ok = i < n_own;
    if (ok && tame) leaf_entry<GEN>(wbox, nw, w0 + i, nw, iv, ok);
    const unsigned m = __ballot_sync(kFull, ok);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_n, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (ok)
      s_list[base + __popc(m & ((1u << lane) - 1u))] = (unsigned short)i;
    else if (i < n_own)
      for (int b = 0; b < k_bands; ++b) wout[b * nw + w0 + i] = 0;
  }
  __syncthreads();
  const int n_pass = s_n;

  // 3. each leaf's entry in the listed words, one warp a word; at one band
  // the verdicts too
  float tmin = kBig;
  for (int j = warp; j < n_pass; j += kWarps) {
    const int g = w0 + s_list[j];
    bool ok;
    const float t = leaf_entry<GEN>(box, lp, g * 32 + lane, n_leaf, iv, ok);
    if (ok) tmin = fminf(tmin, t);
    if (k_bands == 1) {
      const unsigned m = __ballot_sync(kFull, ok);
      if (lane == 0) {
        wout[g] = (int32_t)m;
        if (m) atomicOr(&r0_summ[g >> 5], 1u << (g & 31));
      }
    } else if (j < lay.cap) {
      s_tn[j * 32 + lane] = ok ? t : kNone;
    }
  }
  tmin = warp_min(tmin);
  if (lane == 0) s_warp[warp][0] = tmin;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) tmin = fminf(tmin, s_warp[w][0]);
    // at one band only rank 0 needs the cluster's nearest entry
    for (int r = 0; r < (k_bands == 1 ? 1 : n_ranks); ++r)
      cluster.map_shared_rank(&s_tmin[rank], r)[0] = tmin;
  }

  if (k_bands > 1) {
    // the entry of leaf ``lane`` of listed word j: kept, or recomputed
    auto entry = [&](int j) {
      if (j < lay.cap) return s_tn[j * 32 + lane];
      bool ok;
      const float t = leaf_entry<GEN>(box, lp, (w0 + s_list[j]) * 32 + lane,
                                      n_leaf, iv, ok);
      return ok ? t : kNone;
    };
    cluster.sync();
    float t0 = s_tmin[0];
    for (int r = 1; r < n_ranks; ++r) t0 = fminf(t0, s_tmin[r]);
    t0 = fminf(t0, iv.mb);
    const float span = fmaxf(iv.mb - t0, 1e-6f);

    // 4. equal-count band edges from the cluster's 32-bin histogram
    const float scale = (float)kBins / span;
    for (int j = warp; j < n_pass; j += kWarps) {
      const float tn = entry(j);
      if (!isnan(tn)) {
        const float f = fminf((tn - t0) * scale, (float)kBins);
        atomicAdd(&s_hist[min(max((int)f, 0), kBins - 1)], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x < kBins)
      for (int r = 0; r < n_ranks; ++r)
        cluster.map_shared_rank(&s_hists[rank][threadIdx.x], r)[0] =
            s_hist[threadIdx.x];
    cluster.sync();
    if (warp == 0) {
      // lane j: the passing leaves in bins 0..j; the edge of band b is the
      // first bin whose count reaches b/K of them
      int c = 0;
      for (int r = 0; r < n_ranks; ++r) c += s_hists[r][lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(kFull, c, o);
        if (lane >= o) c += n;
      }
      const int total = max(__shfl_sync(kFull, c, kBins - 1), 1);
      for (int b = 1; b < k_bands; ++b) {
        const int tgt = (total * b + k_bands - 1) / k_bands;
        const int e = __popc(__ballot_sync(kFull, c < tgt));
        if (lane == 0) s_los[b] = t0 + (float)e * (span / (float)kBins);
      }
      if (lane == 0) s_los[0] = t0;
    }
    __syncthreads();

    // verdict bits of the listed words by ballot, one warp a word
    for (int j = warp; j < n_pass; j += kWarps) {
      const int g = w0 + s_list[j];
      const float tn = entry(j);
      const bool ok = !isnan(tn);
      int band = 0;
      for (int b = 1; b < k_bands; ++b) band += tn >= s_los[b];
      unsigned mine = 0;
      for (int b = 0; b < k_bands; ++b) {
        const unsigned m = __ballot_sync(kFull, ok && band == b);
        if (lane == b) mine = m;
      }
      if (lane < k_bands) {
        wout[lane * nw + g] = (int32_t)mine;
        if (mine) atomicOr(&r0_summ[lane * ns + (g >> 5)], 1u << (g & 31));
      }
    }
  }

  // 5. rank 0, once every rank's summary words are in: the summaries and
  // the floors
  cluster.sync();
  if (rank != 0) return;
  if (k_bands == 1 && threadIdx.x == 0) {
    float t0 = s_tmin[0];
    for (int r = 1; r < n_ranks; ++r) t0 = fminf(t0, s_tmin[r]);
    s_los[0] = fminf(t0, iv.mb);
  }
  int32_t* sout = summ + (size_t)pid * k_bands * ns;
  for (int i = threadIdx.x; i < k_bands * ns; i += kWordsThreads)
    sout[i] = (int32_t)s_summ[i];
  __syncthreads();
  if (threadIdx.x < k_bands) {
    const int b = threadIdx.x;
    unsigned any = 0;
    for (int s = 0; s < ns; ++s) any |= s_summ[b * ns + s];
    floors[pid * k_bands + b] = any ? s_los[b] : kBig;
  }
}

// Per-ray slab test of leaf l: entry distance, and pass = the ray enters
// the box in front of it.
__device__ __forceinline__ float ray_slab(const float* box, int lp, int l,
                                          const float o[3],
                                          const float idir[3], bool& pass) {
  float lo[3], hi[3], tf;
  for (int k = 0; k < 3; ++k) {
    lo[k] = __ldg(box + k * lp + l);
    hi[k] = __ldg(box + (3 + k) * lp + l);
  }
  return slab_entry(lo, hi, o, idir, tf, pass);
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

// GEN: every lane has its own origin, and the interval's origin bounds
// are those of the warp's live lanes.
template <bool GEN>
__device__ __forceinline__ WarpCull warp_cull(const float o[3],
                                              const float d[3],
                                              const float idir[3],
                                              float limit) {
  const bool live = limit > 0.0f;
  WarpCull c;
  for (int k = 0; k < 3; ++k) {
    if (GEN) {
      c.iv.om[k] = widen_lo(warp_min(live ? o[k] : kBig));
      c.iv.oM[k] = widen_hi(warp_max(live ? o[k] : -kBig));
    } else {
      c.iv.om[k] = c.iv.oM[k] = o[k];
    }
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
template <bool GEN>
__device__ __forceinline__ bool warp_keeps(const float* box, int lp, int l,
                                           const WarpCull& c) {
  bool ok;
  leaf_entry<GEN>(box, lp, l, lp, c.iv, ok);
  for (int k = 0; k < 3; ++k)
    ok = ok && box[k * lp + l] <= c.hi[k] && box[(3 + k) * lp + l] >= c.lo[k];
  return ok;
}

// Traversal counters of one warp (B8), the slots of its packet's (P, 8)
// int32 row; every lane holds the same values:
//   [0] nodes      populated bit words the warp tests against its cull at
//                  the leaf level (B8b: those left after scan_boxes' block
//                  and word skips)
//   [1] leaves     leaves the warp keeps after its cull (ballot survivors)
//   [2] quarters   (leaf, warp) pairs in which some lane passes its slab
//                  test and intersects the leaf's triangles
//   [3] tri_blocks triangles tested, summed over those pairs: the most any
//                  lane tested, one unit = one triangle against a 32-ray
//                  warp (B4's lanes stop at their first blocker)
//   [4] chunks     bands the warp enters (not skipped by their floor)
//   [5..7] 0
struct Counters {
  int nodes = 0, leaves = 0, quarters = 0, tri_blocks = 0, chunks = 0;
};

__device__ __forceinline__ void add_counters(const Counters& c,
                                             int32_t* row) {
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(row + 0, c.nodes);
    atomicAdd(row + 1, c.leaves);
    atomicAdd(row + 2, c.quarters);
    atomicAdd(row + 3, c.tri_blocks);
    atomicAdd(row + 4, c.chunks);
  }
}

// Counts one (leaf, warp) pair: ``go`` = this lane intersects the leaf,
// ``tested`` = the triangles it tested.
__device__ __forceinline__ void count_leaf(Counters& c, bool go,
                                           int tested) {
  c.quarters += __any_sync(kFull, go) ? 1 : 0;
  c.tri_blocks += (int)__reduce_max_sync(kFull, (unsigned)tested);
}

// Scan of one packet's words in band order, B2's (B8a's). Band b
// is skipped once its floor is at or above the warp's bound
// (bound_fn() = max over lanes of the distance still of interest, <= 0
// when the warp is done); every leaf in a band has its interval entry at
// or above the floor. Each word's 32 leaves are first tested in parallel,
// one per lane, against the warp's cull ``wc`` with its current bound (a
// packet whose direction interval spans zero can pass every leaf of a
// scene; its warps' culls do not); word_fn(w, kept) then runs for a word
// with survivors, ``kept`` their bits (leaf 32w + j for bit j), and tests
// them in order. With STATS the scan counts into ``st`` (chunks, nodes,
// leaves; word_fn the rest).
template <bool STATS = false, typename BoundFn, typename WordFn>
__device__ __forceinline__ void scan_words(const int32_t* words,
                                           const int32_t* summ,
                                           const float* floors, int k_bands,
                                           int nw, int ns, const float* box,
                                           int lp, WarpCull& wc,
                                           Counters& st, BoundFn bound_fn,
                                           WordFn word_fn) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < k_bands; ++b) {
    const float bound = bound_fn();
    if (!(bound > 0.0f)) return;
    if (floors[b] >= bound) continue;
    if constexpr (STATS) ++st.chunks;
    for (int s = 0; s < ns; ++s) {
      unsigned sw = (unsigned)summ[b * ns + s];
      while (sw) {
        const int w = s * 32 + __ffs(sw) - 1;
        sw &= sw - 1;
        unsigned word = (unsigned)words[b * nw + w];
        wc.iv.mb = bound_fn();
        if (!(wc.iv.mb > 0.0f)) return;
        if constexpr (STATS) ++st.nodes;
        const bool ok = ((word >> lane) & 1u) &&
                        warp_keeps<false>(box, lp, w * 32 + lane, wc);
        word = __ballot_sync(kFull, ok);
        if constexpr (STATS) st.leaves += __popc(word);
        if (word) word_fn(w, word);
      }
    }
  }
}

// Whether some lane's ray enters column c of the planar box table t (6, n)
// before its limit ``lim``: each lane's slab test (ray_slab), then
// __any_sync. A ``wild`` lane always passes.
__device__ __forceinline__ bool warp_enters(const float* t, int n, int c,
                                            const float o[3],
                                            const float idir[3], float lim,
                                            bool wild) {
  bool pass;
  const float tn = ray_slab(t, n, c, o, idir, pass);
  return __any_sync(kFull, wild || (pass && tn < lim));
}

// cp.async of 4 bytes from global to shared memory, and its group fences.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int kSlot = 6 * 32;  // the planar boxes of one word's leaves

// Starts the copy of word w's 32 leaf boxes into ``slot``, one leaf a lane.
__device__ __forceinline__ void fetch_word(float* slot, const float* box,
                                           int lp, int w, int lane) {
  for (int k = 0; k < 6; ++k)
    cp_async4(slot + k * 32 + lane, box + (size_t)k * lp + w * 32 + lane);
  cp_async_commit();
}

// Scan of one packet's words for B4/B6/B7 (B8b with STATS): the visit order
// and leaf level of scan_words, with two skip levels ahead of the leaf
// level, so that a warp works in proportion to the words its rays enter,
// not to its packet's word list. Per band, per summary word s:
// 1. block: unless some lane's ray enters bbox[:, s] (the box around
//    leaves 1024s..1024s+1023) before its limit lim_fn(), all of s's
//    words are skipped;
// 2. word: lane j tests the box of word 32s+j, if it is populated in the
//    band, against the warp's cull (warp_keeps on wbox); for each
//    survivor in order, unless some lane's ray enters its box before its
//    limit, the word is skipped;
// 3. leaf: as scan_words: the warp cull of the word's 32 leaf boxes, a
//    ballot, then leaf_fn(l, tn, pass) for each survivor in order with the
//    lane's slab test of leaf l (ray_slab); true ends the scan.
// The outputs are scan_words' bit for bit: a leaf box lies inside its
// word's and block's box, and every step of slab_entry (a difference, a
// product with a fixed idir, min, max) is monotone under rounding, so a
// ray that enters a leaf before its limit enters the word and the block
// no later; the warp cull is monotone in the box in the same way; limits
// and bounds only fall during a scan, so an early skip stays right. That
// fails only where a product is 0 x inf = NaN, which fminf/fmaxf drop: a
// lane whose idir is not finite (``wild``) passes every box test, and a
// cull with a bound that is not finite keeps every word. With STATS,
// ``nodes`` counts the words that reach the leaf level. With PREFETCH the
// leaf level reads its 32 leaf boxes from ``buf``, the warp's two slots
// of shared memory: while it works on one word, cp.async brings the next
// survivor of the word ballot into the other slot (the caller waits for
// the last copy after the scan).
template <bool GEN, bool STATS, bool PREFETCH, typename BoundFn,
          typename LimFn, typename LeafFn>
__device__ __forceinline__ void scan_boxes(
    const int32_t* words, const int32_t* summ, const float* floors,
    int k_bands, int nw, int ns, const float* box, const float* wbox,
    const float* bbox, int lp, WarpCull& wc, const float o[3],
    const float idir[3], Counters& st, float* buf, BoundFn bound_fn,
    LimFn lim_fn, LeafFn leaf_fn) {
  const int lane = threadIdx.x & 31;
  int pre_w = -1, pre = 0;  // the word in flight to slot ``pre``
  const bool wild =
      !(isfinite(idir[0]) && isfinite(idir[1]) && isfinite(idir[2]));
  bool tame = true;  // warp-uniform
  for (int k = 0; k < 3; ++k)
    tame = tame && isfinite(wc.iv.om[k]) && isfinite(wc.iv.oM[k]) &&
           isfinite(wc.iv.im[k]) && isfinite(wc.iv.iM[k]);
  for (int b = 0; b < k_bands; ++b) {
    const float bound = bound_fn();
    if (!(bound > 0.0f)) return;
    if (floors[b] >= bound) continue;
    if constexpr (STATS) ++st.chunks;
    for (int s = 0; s < ns; ++s) {
      const unsigned sw = (unsigned)summ[b * ns + s];
      if (!sw || !warp_enters(bbox, ns, s, o, idir, lim_fn(), wild))
        continue;
      wc.iv.mb = bound_fn();
      if (!(wc.iv.mb > 0.0f)) return;
      unsigned ws = __ballot_sync(
          kFull, ((sw >> lane) & 1u) &&
                     (!tame || warp_keeps<GEN>(wbox, nw, s * 32 + lane, wc)));
      while (ws) {
        const int w = s * 32 + __ffs(ws) - 1;
        ws &= ws - 1;
        if (!warp_enters(wbox, nw, w, o, idir, lim_fn(), wild)) continue;
        wc.iv.mb = bound_fn();
        if (!(wc.iv.mb > 0.0f)) return;
        if constexpr (STATS) ++st.nodes;
        // the word's leaf boxes: column c0 + j of the planar table t (6, n)
        const float* t = box;
        int n = lp, c0 = w * 32;
        if constexpr (PREFETCH) {
          if (pre_w != w) {
            cp_async_wait_all();
            fetch_word(buf + pre * kSlot, box, lp, w, lane);
          }
          cp_async_wait_all();
          __syncwarp();  // every lane's copies landed; the other slot is free
          t = buf + pre * kSlot;
          n = 32;
          c0 = 0;
          pre ^= 1;
          pre_w = ws ? s * 32 + __ffs(ws) - 1 : -1;
          if (pre_w >= 0) fetch_word(buf + pre * kSlot, box, lp, pre_w, lane);
        }
        unsigned word = (unsigned)words[b * nw + w];
        const bool ok = ((word >> lane) & 1u) &&
                        warp_keeps<GEN>(t, n, c0 + lane, wc);
        word = __ballot_sync(kFull, ok);
        if constexpr (STATS) st.leaves += __popc(word);
        while (word) {
          const int j = __ffs(word) - 1;
          word &= word - 1;
          bool pass;
          float tn;
          if constexpr (PREFETCH) {
            const float lo[3] = {t[j], t[32 + j], t[64 + j]};
            const float hi[3] = {t[96 + j], t[128 + j], t[160 + j]};
            float tf;
            tn = slab_entry(lo, hi, o, idir, tf, pass);
          } else {
            tn = ray_slab(box, lp, w * 32 + j, o, idir, pass);
          }
          if (leaf_fn(w * 32 + j, tn, pass)) return;
        }
      }
    }
  }
}

// cp.async group fence: all but the newest ``N`` groups of this thread
// have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- B2's (B8a's) leaf stage: two slots, the next leaf's copy in flight
// while the warp tests the current one ---------------------------------
//
// The word's ballot gives the warp its kept leaves before it tests any of
// them, and lane j has just read leaf 32w + j's box for its cull. So lane
// j writes that box, the leaf's first row and its count into the warp's
// word table in shared memory (coalesced loads, one set a word), the warp
// copies the first kept leaf's rows into slot 0 of its stage
// (stage_rows: 48-byte prefixes, cp.async), and for each kept leaf in
// order it starts the copy of the next one into the other slot before it
// waits for and tests the current one. The leaf loop reads boxes and rows
// from shared memory only: no scattered box or row loads are left in it.
// (Holding the box in lane j's registers and taking it by __shfl_sync
// spilled 28 bytes at the same 80 registers.) The entering lanes then
// test the staged rows lane per ray (leaf_closest's loop, in row order),
// or lane per triangle where at most kCamLaneTriMax enter (rays.cuh
// staged_closest_sh, which B9a and B9e share): both keep the first
// strictly nearer hit, so dist, u, v and tri are the loop's bit for bit.

// Starts the copy of rows first .. first + count - 1 (<= kWlLeafRows) of
// ``rows`` (raw rows, or B8a's shared-origin rows) into ``slot`` as one
// cp.async group; every lane of the warp calls it.
__device__ __forceinline__ void stage_rows(const float* rows, int first,
                                           int count, float4* slot,
                                           int lane) {
  const float4* src =
      reinterpret_cast<const float4*>(rows) + (size_t)first * 4;
  for (int c = lane; c < count * kStageVec; c += 32) {
    const int r = c / kStageVec;
    cp_async16(slot + c, src + 4 * r + (c - kStageVec * r));
  }
  cp_async_commit();
}

// B2 (B8a with STATS): camera raygen + closest hit, one thread per ray;
// STATS adds the packet's counters to ``out_stats`` (P, 8). B2's ``rows``
// are the raw triangle rows, staged by their 48-byte prefix (a, ba, ca,
// n) and tested with the full Moller test from the camera position; B8a's
// are the camera's shared-origin rows; the same stage, warps,
// lane-per-triangle threshold and tie rule. A warp's rays
// are an 8 x 4 pixel tile (rays.cuh tile_ray); each thread writes its own
// ray's slot. Each warp's leaf stage is two slots of kWlLeafRows staged rows
// (3 KB) and its word table 1 KB: 32 KB a block of 8 warps. Asked for 4
// blocks an SM, as its 63 registers gave it before the stage, ptxas gives
// B2 64 registers and spills 48 bytes; with no minimum it took 80 and 3
// blocks and was 1-2 % slower, with 2 blocks 27 % slower. B8a, 3 blocks:
// 80 registers, 12 bytes spilled, 2-3 % faster than at 4 (PERF.md).
template <bool STATS>
__global__ void __launch_bounds__(kTraceThreads, STATS ? 3 : 4)
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
                 float* __restrict__ out_dz, int32_t* __restrict__ out_stats) {
  constexpr bool RAW = !STATS;
  constexpr int kSlotVec = kWlLeafRows * kStageVec;
  constexpr int kWarps = kTraceThreads / 32;
  __shared__ float4 s_stage[kWarps * 2 * kSlotVec];
  // the word's leaves, one column a lane: box planes lo.xyz, hi.xyz,
  // then first row and count (as float bits)
  __shared__ float s_word[kWarps * 8 * 32];
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(t / kPacketR), k = tile_ray((int)(t % kPacketR));
  const size_t g = (size_t)pid * kPacketR + k;
  const int lane = threadIdx.x & 31;
  const int nw = lp / 32, ns = lp / kLeafBlock;
  float4* stage = s_stage + (threadIdx.x >> 5) * 2 * kSlotVec;
  float* leaf = s_word + (threadIdx.x >> 5) * 8 * 32;
  const PrimaryRay r = camera_ray(cam, pid, k);
  const float o[3] = {cam[9], cam[10], cam[11]};
  float best = r.t_exit, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  // a ray that misses the root box (best = 0) can hit nothing
  WarpCull wc = warp_cull<false>(o, r.d, r.idir, best);
  Counters st;

  scan_words<STATS>(
      words + (size_t)pid * k_bands * nw, summ + (size_t)pid * k_bands * ns,
      floors + (size_t)pid * k_bands, k_bands, nw, ns, box, lp, wc, st,
      [&] { return warp_max(fmaxf(best, 0.0f)); },
      [&](int w, unsigned kept) {
        __syncwarp();  // every lane is done with the last word's leaves
        const int c = w * 32 + lane;
        for (int q = 0; q < 6; ++q)
          leaf[q * 32 + lane] = __ldg(box + q * lp + c);
        leaf[6 * 32 + lane] = __int_as_float(__ldg(lfirst + c));
        leaf[7 * 32 + lane] = __int_as_float(__ldg(lcount + c));
        __syncwarp();
        const auto first = [&](int i) {
          return __float_as_int(leaf[6 * 32 + i]);
        };
        const auto count = [&](int i) {
          return __float_as_int(leaf[7 * 32 + i]);
        };
        int j = __ffs(kept) - 1, slot = 0;
        stage_rows(rows, first(j), count(j), stage, lane);
        for (;;) {
          kept &= kept - 1;
          const int jn = kept ? __ffs(kept) - 1 : -1;
          if (jn >= 0) {
            stage_rows(rows, first(jn), count(jn),
                       stage + (slot ^ 1) * kSlotVec, lane);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncwarp();  // every lane's copies of the current leaf landed
          float lo[3], hi[3], tf;
          for (int q = 0; q < 3; ++q) {
            lo[q] = leaf[q * 32 + j];
            hi[q] = leaf[(3 + q) * 32 + j];
          }
          bool pass;
          const float tn = slab_entry(lo, hi, o, r.idir, tf, pass);
          const bool go = pass && tn < best;
          if constexpr (STATS) count_leaf(st, go, go ? count(j) : 0);
          staged_closest_sh<kCamLaneTriMax, RAW>(stage + slot * kSlotVec,
                                                 first(j), count(j), go, o,
                                                 r.d, best, tri, bu, bv,
                                                 lane);
          if (jn < 0) break;
          __syncwarp();  // every lane is done with this slot's rows
          j = jn;
          slot ^= 1;
        }
      });

  out_dist[g] = tri >= 0 ? best : kBig;
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = tri;
  out_dx[g] = r.d[0];
  out_dy[g] = r.d[1];
  out_dz[g] = r.d[2];
  if constexpr (STATS) add_counters(st, out_stats + pid * 8);
}

// B4 (B8b with STATS): any-hit from a shared origin, one thread per ray,
// over scan_boxes; a warp stops once every live ray in it is blocked.
// B4's ``rows`` are the raw triangle rows, each tested with the full
// Moller test from ``orig`` (leaf_blocks<true>); B8b's the shared-origin
// rows of ``orig``; the one-sided rule either way.
template <bool STATS>
__global__ void __launch_bounds__(kTraceThreads)
shadow_wl_kernel(const float* __restrict__ orig, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const float* __restrict__ tm, const float* __restrict__ rows,
                 const float* __restrict__ box,
                 const float* __restrict__ wbox,
                 const float* __restrict__ bbox,
                 const int32_t* __restrict__ lfirst,
                 const int32_t* __restrict__ lcount, int lp,
                 const int32_t* __restrict__ words,
                 const int32_t* __restrict__ summ,
                 const float* __restrict__ floors, int k_bands,
                 float* __restrict__ out_blocked,
                 int32_t* __restrict__ out_stats) {
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
  WarpCull wc = warp_cull<false>(o, d, idir, limit);
  Counters st;

  scan_boxes<false, STATS, false>(
      words + (size_t)pid * k_bands * nw, summ + (size_t)pid * k_bands * ns,
      floors + (size_t)pid * k_bands, k_bands, nw, ns, box, wbox, bbox, lp,
      wc, o, idir, st, nullptr,
      [&] { return warp_max(fmaxf(blocked ? -kBig : limit, 0.0f)); },
      [&] { return blocked ? -kBig : limit; },
      [&](int l, float tn, bool pass) {
        const bool go = pass && tn < (blocked ? -kBig : limit);
        int tested = 0;
        if (go)
          blocked = leaf_blocks<!STATS>(rows, __ldg(lfirst + l),
                                        __ldg(lcount + l), o, d, limit,
                                        tested);
        if constexpr (STATS) count_leaf(st, go, tested);
        return __all_sync(kFull, blocked || !(limit > 0.0f));
      });

  out_blocked[g] = blocked ? 1.0f : 0.0f;
  if constexpr (STATS) add_counters(st, out_stats + pid * 8);
}

// B6: closest hit of rays with their own origins, one thread per ray, on
// the raw triangle rows. A live ray (tmax >= 0) starts at min(tmax, BIG);
// a miss returns BIG, a masked ray -BIG, and tri is clamped at 0
// (_closest_wl_kernel_g :3247-3269). A bounce ray's tmax is BIG, so the
// culls look no further than where it leaves the scene's root box, as
// B2's camera rays do: a segment box as long as BIG culls nothing. The
// scan is scan_boxes, each lane's limit its current best, with the
// prefetch of leaf boxes (faster on terrain_724's reflections on an H100;
// B4's shadow rays were not faster with it: PERF.md).
__global__ void __launch_bounds__(kTraceThreads)
closest_wl_g_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ tm,
                    const float* __restrict__ rows,
                    const float* __restrict__ box,
                    const float* __restrict__ wbox,
                    const float* __restrict__ bbox,
                    const float* __restrict__ root,
                    const int32_t* __restrict__ lfirst,
                    const int32_t* __restrict__ lcount, int lp,
                    const int32_t* __restrict__ words,
                    const int32_t* __restrict__ summ,
                    const float* __restrict__ floors, int k_bands,
                    float* __restrict__ out_dist, float* __restrict__ out_u,
                    float* __restrict__ out_v, int32_t* __restrict__ out_tri) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(g / kPacketR);
  const int nw = lp / 32, ns = lp / kLeafBlock;
  const float o[3] = {ox[g], oy[g], oz[g]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const bool active = tm[g] >= 0.0f;
  float best = active ? fminf(tm[g], kBig) : -kBig, bu = 0.0f, bv = 0.0f;
  int tri = -1;
  const float t_root = box_exit(root, root + 3, o, idir);
  WarpCull wc = warp_cull<true>(o, d, idir, fminf(best, t_root));
  Counters none;
  __shared__ float s_buf[kTraceThreads / 32 * 2 * kSlot];

  scan_boxes<true, false, true>(
      words + (size_t)pid * k_bands * nw, summ + (size_t)pid * k_bands * ns,
      floors + (size_t)pid * k_bands, k_bands, nw, ns, box, wbox, bbox, lp,
      wc, o, idir, none, s_buf + (threadIdx.x >> 5) * 2 * kSlot,
      [&] { return warp_max(fmaxf(fminf(best, t_root), 0.0f)); },
      [&] { return best; },
      [&](int l, float tn, bool pass) {
        if (pass && tn < best)
          leaf_closest(rows, __ldg(lfirst + l), __ldg(lcount + l), o, d,
                       best, tri, bu, bv);
        return false;
      });
  cp_async_wait_all();

  out_dist[g] = tri >= 0 ? best : (active ? kBig : -kBig);
  out_u[g] = bu;
  out_v[g] = bv;
  out_tri[g] = max(tri, 0);
}

// B7's leaf stage: leaves of at most kWlLeafRows rows, tested lane per
// triangle where at most kWlAnyLaneTriMax lanes enter (set by a sweep on
// the H100, PERF.md).
constexpr int kWlAnyLaneTriMax = 12;

// B7: any-hit of rays with their own origins, one thread per ray, on the
// raw triangle rows: B4's scan_boxes and exit (a warp stops once every
// live ray in it is blocked) with B6's per-ray-origin warp culls and
// root-box clip, and the one-sided shadow rule of _shadow_ival_drain_g
// (:2044-2050) on the full Moller terms. A masked ray (tmax < 0) is never
// blocked. At a leaf some unblocked lane enters, the warp stages the
// leaf's rows into its slice of shared memory (8 warps x 32 rows x 48 B =
// 12 KB a block) and tests them lane per triangle where at most
// kWlAnyLaneTriMax lanes enter, lane per ray up to each ray's first
// occluder where more do (rays.cuh leaf_blocks_staged).
__global__ void __launch_bounds__(kTraceThreads)
shadow_wl_g_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tm,
                   const float* __restrict__ rows,
                   const float* __restrict__ box,
                   const float* __restrict__ wbox,
                   const float* __restrict__ bbox,
                   const float* __restrict__ root,
                   const int32_t* __restrict__ lfirst,
                   const int32_t* __restrict__ lcount, int lp,
                   const int32_t* __restrict__ words,
                   const int32_t* __restrict__ summ,
                   const float* __restrict__ floors, int k_bands,
                   float* __restrict__ out_blocked) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int pid = (int)(g / kPacketR);
  const int nw = lp / 32, ns = lp / kLeafBlock;
  const float o[3] = {ox[g], oy[g], oz[g]};
  const float d[3] = {dx[g], dy[g], dz[g]};
  const float idir[3] = {1.0f / (d[0] + kInvEps), 1.0f / (d[1] + kInvEps),
                         1.0f / (d[2] + kInvEps)};
  const float tmax = tm[g];
  const float limit = tmax >= 0.0f ? tmax : -kBig;
  // nothing beyond the root box can block: the culls look no further
  const float reach = fminf(limit, box_exit(root, root + 3, o, idir));
  bool blocked = false;
  WarpCull wc = warp_cull<true>(o, d, idir, reach);
  Counters none;
  __shared__ float4 s_stage[kTraceThreads / 32 * kWlLeafRows * kStageVec];
  float4* stage = s_stage + (threadIdx.x >> 5) * kWlLeafRows * kStageVec;

  scan_boxes<true, false, false>(
      words + (size_t)pid * k_bands * nw, summ + (size_t)pid * k_bands * ns,
      floors + (size_t)pid * k_bands, k_bands, nw, ns, box, wbox, bbox, lp,
      wc, o, idir, none, nullptr,
      [&] { return warp_max(fmaxf(blocked ? -kBig : reach, 0.0f)); },
      [&] { return blocked ? -kBig : limit; },
      [&](int l, float tn, bool pass) {
        const bool go = pass && tn < (blocked ? -kBig : limit);
        // a leaf no lane enters is not staged
        if (__any_sync(kFull, go) &&
            leaf_blocks_staged<kWlLeafRows, kWlAnyLaneTriMax>(
                rows, stage, __ldg(lfirst + l), __ldg(lcount + l), go, o, d,
                limit))
          blocked = true;
        return __all_sync(kFull, blocked || !(reach > 0.0f));
      });

  out_blocked[g] = blocked ? 1.0f : 0.0f;
}

bool words_args_ok(int lp, int n_leaf, int k_bands, int n_packets,
                   int n_ranks) {
  return lp > 0 && lp % kLeafBlock == 0 && lp <= kMaxLp && n_leaf <= lp &&
         k_bands >= 1 && k_bands <= kMaxBands && n_packets > 0 &&
         (n_ranks == 1 || n_ranks == 2 || n_ranks == 4 ||
          n_ranks == kMaxRanks) &&
         words_layout(lp, k_bands, n_ranks).bytes <= kWordsSmem;
}

// Launches words_cluster_kernel<MODE> with clusters of ``n_ranks`` blocks
// per packet.
template <int MODE>
int launch_words(const float* origin, const float* ox, const float* oy,
                 const float* oz, const float* dx, const float* dy,
                 const float* dz, const float* tm, const float* box,
                 const float* wbox, int lp, int n_leaf, int k_bands,
                 int n_packets, int n_ranks, int32_t* words, int32_t* summ,
                 float* floors, void* stream) {
  if (!words_args_ok(lp, n_leaf, k_bands, n_packets, n_ranks))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_packets * n_ranks);
  cfg.blockDim = dim3(kWordsThreads);
  cfg.dynamicSmemBytes = words_layout(lp, k_bands, n_ranks).bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, words_cluster_kernel<MODE>, origin, ox, oy, oz, dx, dy, dz, tm,
      box, wbox, lp, n_leaf, k_bands, words, summ, floors);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// B1, B3 and B5: the words passes, each packet over a cluster of
// ``n_ranks`` blocks (1, 2, 4 or 8). ``wbox``: the word boxes
// (ops/traverse.py LeafTables). Leaf tables of more than kMaxLp slots
// (scenes that large get node tables) are refused.
int snail_words_camera(const float* cam, const float* box, const float* wbox,
                       int lp, int n_leaf, int k_bands, int n_packets,
                       int n_ranks, int32_t* words, int32_t* summ,
                       float* floors, void* stream) {
  return launch_words<CAMERA>(cam, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, box, wbox, lp,
                              n_leaf, k_bands, n_packets, n_ranks, words,
                              summ, floors, stream);
}

int snail_words_shared(const float* orig, const float* dx, const float* dy,
                       const float* dz, const float* tm, const float* box,
                       const float* wbox, int lp, int n_leaf, int k_bands,
                       int n_packets, int n_ranks, int32_t* words,
                       int32_t* summ, float* floors, void* stream) {
  return launch_words<SHARED>(orig, nullptr, nullptr, nullptr, dx, dy, dz,
                              tm, box, wbox, lp, n_leaf, k_bands, n_packets,
                              n_ranks, words, summ, floors, stream);
}

int snail_words_general(const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* tm, const float* box, const float* wbox,
                        int lp, int n_leaf, int k_bands, int n_packets,
                        int n_ranks, int32_t* words, int32_t* summ,
                        float* floors, void* stream) {
  return launch_words<GENERAL>(nullptr, ox, oy, oz, dx, dy, dz, tm, box,
                               wbox, lp, n_leaf, k_bands, n_packets, n_ranks,
                               words, summ, floors, stream);
}

// B2 on the raw triangle rows, or B8a on the shared-origin rows when
// ``stats`` (P, 8) int32, zeroed by the caller, is given.
int snail_camera_wl(const float* cam, const float* rows, const float* box,
                    const int32_t* lfirst, const int32_t* lcount, int lp,
                    const int32_t* words, const int32_t* summ,
                    const float* floors, int k_bands, int n_packets,
                    float* dist, float* u, float* v, int32_t* tri, float* dx,
                    float* dy, float* dz, int32_t* stats, void* stream) {
  if (lp <= 0 || lp % kLeafBlock || k_bands < 1 || n_packets <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = n_packets * (kPacketR / kTraceThreads);
  if (stats)
    camera_wl_kernel<true><<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(
        cam, rows, box, lfirst, lcount, lp, words, summ, floors, k_bands,
        dist, u, v, tri, dx, dy, dz, stats);
  else
    camera_wl_kernel<false><<<blocks, kTraceThreads, 0,
                              (cudaStream_t)stream>>>(
        cam, rows, box, lfirst, lcount, lp, words, summ, floors, k_bands,
        dist, u, v, tri, dx, dy, dz, nullptr);
  return (int)cudaGetLastError();
}

// B4 on the raw triangle rows, or B8b on the shared-origin rows when
// ``stats`` (P, 8) int32, zeroed by the caller, is given.
// ``wbox``/``bbox``: the word and block boxes (ops/traverse.py LeafTables).
int snail_shadow_wl(const float* orig, const float* dx, const float* dy,
                    const float* dz, const float* tm, const float* rows,
                    const float* box, const float* wbox, const float* bbox,
                    const int32_t* lfirst, const int32_t* lcount, int lp,
                    const int32_t* words, const int32_t* summ,
                    const float* floors, int k_bands, int n_packets,
                    float* blocked, int32_t* stats, void* stream) {
  if (lp <= 0 || lp % kLeafBlock || k_bands < 1 || n_packets <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = n_packets * (kPacketR / kTraceThreads);
  if (stats)
    shadow_wl_kernel<true><<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(
        orig, dx, dy, dz, tm, rows, box, wbox, bbox, lfirst, lcount, lp,
        words, summ, floors, k_bands, blocked, stats);
  else
    shadow_wl_kernel<false><<<blocks, kTraceThreads, 0,
                              (cudaStream_t)stream>>>(
        orig, dx, dy, dz, tm, rows, box, wbox, bbox, lfirst, lcount, lp,
        words, summ, floors, k_bands, blocked, nullptr);
  return (int)cudaGetLastError();
}

int snail_closest_wl_g(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* tm, const float* rows, const float* box,
                       const float* wbox, const float* bbox,
                       const float* root, const int32_t* lfirst,
                       const int32_t* lcount, int lp, const int32_t* words,
                       const int32_t* summ,
                       const float* floors, int k_bands, int n_packets,
                       float* dist, float* u, float* v, int32_t* tri,
                       void* stream) {
  if (lp <= 0 || lp % kLeafBlock || k_bands < 1 || n_packets <= 0)
    return (int)cudaErrorInvalidValue;
  closest_wl_g_kernel<<<n_packets * (kPacketR / kTraceThreads), kTraceThreads,
                        0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, rows, box, wbox, bbox, root, lfirst, lcount,
      lp, words, summ, floors, k_bands, dist, u, v, tri);
  return (int)cudaGetLastError();
}

// ``wbox``/``bbox``: as snail_shadow_wl's. Every leaf of the tables holds
// at most kWlLeafRows triangles.
int snail_shadow_wl_g(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tm, const float* rows, const float* box,
                      const float* wbox, const float* bbox,
                      const float* root, const int32_t* lfirst,
                      const int32_t* lcount, int lp, const int32_t* words,
                      const int32_t* summ, const float* floors, int k_bands,
                      int n_packets, float* blocked, void* stream) {
  if (lp <= 0 || lp % kLeafBlock || k_bands < 1 || n_packets <= 0)
    return (int)cudaErrorInvalidValue;
  shadow_wl_g_kernel<<<n_packets * (kPacketR / kTraceThreads), kTraceThreads,
                       0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tm, rows, box, wbox, bbox, root, lfirst, lcount,
      lp, words, summ, floors, k_bands, blocked);
  return (int)cudaGetLastError();
}

}  // extern "C"
