// Cluster-route chunk kernels (sm_90a): the ray x triangle-cluster test
// and the ray x box-page slab test.
//
// Replaces: ray_tracer_tpu/kernels/cluster.py::_cluster_kernel
// (`cluster_pairs`) and ::_box_kernel (`box_hits`).  On the TPU each is one
// Precision.HIGHEST matrix contraction of a whole page against a 128-lane
// chunk, zeros included.  Here only the page entries that the builder
// writes (accel/cluster.py::_mt_pages, ::_box_page) are staged and
// multiplied, and only for the page's real triangles or boxes: every
// dropped term is an exact zero times a finite feature, so the sums keep
// their values (the sign of a zero aside, which no test reads).  Each
// thread keeps its lane's sums in the old row order, so the plain torch
// twins (kernels/cluster.py) round identically: built with --fmad=false
// the two agree bit for bit, and both equal the old full contraction
// (tools/cluster_test_variants.cu).  No tensor cores: TF32 would lose the
// hit distances (a 3xTF32 wgmma form of the products is later work).
//
// Both kernels run a grid of a few 128-thread blocks per SM (8: the
// registers are capped to fit them, 64 per thread) that walk the chunks
// grid-stride: block b takes chunks b, b + gridDim.x, ..., so a dead tail
// of chunks spreads over every block.  A block keeps two page buffers in
// shared memory: it re-stages only when its chunk's page differs from the
// one it holds (at box level 1 every chunk shares one page; elsewhere a
// page is kept where its run of chunks is longer than the grid), and while it
// tests a chunk it prefetches its next chunk's page into the other buffer
// with cp.async.  The 4-byte cp.async copies transpose as they go, so no
// separate pass reorders the staged page.  Walks of tiles of consecutive
// chunks reuse more cluster pages but balance the blocks worse, and on the
// H100 they measured slower (tools/cluster_test_variants.cu holds them,
// tools/measure_cluster_test.py times them).
//
// cluster_pairs: clus_mt (C,16,5*t_c) f32 pages, feats (G,16,128) f32,
//   chunk_cid (G,) i32 (-1 = dead chunk), clus_count (C,) i32 real
//   triangles per cluster -> t (G,128) f32 (BIG = no hit), p (G,128) i32
//   in-cluster index of the closest accepted triangle, the lowest on an
//   exact tie (-1 = none).  Feature rows read: 0-2 o, 3-5 d, 9 (1 on a
//   ray, 0 on a padding lane); o' = o - anchor (page rows 10-12 of
//   column 0) and o' x d stay in registers.  Staged: the 20 written
//   (row, block) coefficients of each real triangle j, as floats
//   [j][20] (five float4 loads): T rows 0,1,2,9 | B rows 3-5 | U rows 3-8
//   | V rows 3-8 | FO row 9; 10 KiB per buffer at t_c = 128.
//   What bounds it: FP32 issue, per live lane x real triangle 20
//   multiplies and 15 adds, an IEEE divide and the accept tests; the
//   page is read from L2 once per change of cluster along a block's walk.
// box_hits: pages (P,16,6*128) f32, feats (G,16,128) f32 (rows 0-2 o, 3-5
//   d with the zero-direction guard applied, 13 tmax), chunk_pid (G,) i32,
//   page_count (P,) i32 real boxes per page -> words (G,4,128) i32, bit b
//   of word w set iff the lane's ray enters box 32w+b within tmax.
//   Staged: each real box's six planes t1x|t2x|t1y|t2y|t1z|t2z, each from
//   its block's own axis row, as floats [b][8] (two float4 loads).  A
//   plane is bound * iv_axis - o * iv_axis; the old form's two other
//   products were 0 * iv, zero while iv is finite, and NaN when a
//   direction component is so small (subnormal) that 1/d is inf.  Such a
//   lane sets no bit here either: on that axis a plane is NaN (inf - inf
//   when the bound has the origin's sign, or 0 * inf) or an infinity, so
//   a box with no NaN plane lies wholly on the other side of the origin
//   and both its planes are the same infinity: +inf fails tmin < tmax,
//   -inf fails tmx > 0.
//   What bounds it: FP32 issue, per live lane x real box 6 multiplies, 6
//   subtracts and 10 one-instruction NaN-propagating min/max.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr float kBig = 99999999.0f;
constexpr int kBoxCols = 6 * 128;
constexpr int kSegs = 20;       // written coefficients per triangle
constexpr int kPairHead = 4;    // floats before the coefficients: anchor
constexpr int kBoxFloats = 8;   // staged floats per box (6 planes + pad)
constexpr int kMaxBlocksPerSm = 8;  // the walk's blocks per SM, at most
constexpr size_t kSmemDefault = 48 * 1024;  // dynamic smem without opt-in

// page row and block of the s-th staged coefficient of a triangle
__host__ __device__ constexpr int seg_row(int s) {
  return s < 3 ? s : s == 3 ? 9 : s < 7 ? s - 1 : s < 13 ? s - 4
         : s < 19 ? s - 10 : 9;
}

__host__ __device__ constexpr int seg_block(int s) {
  return s < 4 ? 0 : s < 7 ? 1 : s < 13 ? 2 : s < 19 ? 3 : 4;
}

__device__ __forceinline__ float min_ptx(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_ptx(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Double-buffered staging along a block's walk: buffer `cur` holds page
// `held` and the other buffer page `other` (or is being filled with it),
// -1 none.  `use` makes buffer `cur` hold page `id`; `prefetch` starts
// filling the other one.
struct Pages {
  int held = -1, other = -1, cur = 0;

  template <typename Stage>
  __device__ __forceinline__ void use(int id, Stage stage) {
    if (held == id) return;
    if (other != id) stage(cur ^ 1, id);
    cp_async_wait_all();
    __syncthreads();
    cur ^= 1;
    other = held;
    held = id;
  }

  template <typename Stage>
  __device__ __forceinline__ void prefetch(int id, Stage stage) {
    if (id < 0 || id == held || id == other) return;
    stage(cur ^ 1, id);
    other = id;
  }
};

// Stage cluster cid's anchor and the written coefficients of its real
// triangles into dst (one page buffer) with cp.async, and commit them.
__device__ __forceinline__ void stage_pairs(float* dst,
                                            const float* __restrict__ clus_mt,
                                            const int* __restrict__ clus_count,
                                            int cid, int t_c) {
  const int lane = threadIdx.x;
  const int cols = 5 * t_c;
  const float* page = clus_mt + static_cast<int64_t>(cid) * 16 * cols;
  const int count = min(clus_count[cid], t_c);
  if (lane < 3) cp_async4(dst + lane, page + (10 + lane) * cols);
#pragma unroll
  for (int s = 0; s < kSegs; ++s) {
    const float* src = page + seg_row(s) * cols + seg_block(s) * t_c;
    for (int j = lane; j < count; j += kLanes)
      cp_async4(dst + kPairHead + j * kSegs + s, src + j);
  }
  cp_async_commit();
}

// Chunk g's lane against cluster cid, staged in buf (cid < 0: dead chunk).
__device__ __forceinline__ void pairs_chunk(const float* buf,
                                            const float* __restrict__ feats,
                                            const int* __restrict__ clus_count,
                                            int cid, int g, int t_c,
                                            float* __restrict__ t_out,
                                            int* __restrict__ p_out) {
  const int lane = threadIdx.x;
  const int64_t out = static_cast<int64_t>(g) * kLanes + lane;
  if (cid < 0) {
    t_out[out] = kBig;
    p_out[out] = -1;
    return;
  }
  const float* fr = feats + static_cast<int64_t>(g) * 16 * kLanes + lane;
  // cluster-local origin o' = o - anchor, and o' x d
  const float ox = fr[0] - buf[0];
  const float oy = fr[kLanes] - buf[1];
  const float oz = fr[2 * kLanes] - buf[2];
  const float dx = fr[3 * kLanes], dy = fr[4 * kLanes], dz = fr[5 * kLanes];
  const float f9 = fr[9 * kLanes];
  const float cx = oy * dz - oz * dy;
  const float cy = oz * dx - ox * dz;
  const float cz = ox * dy - oy * dx;
  const int count = min(clus_count[cid], t_c);
  const float4* coef = reinterpret_cast<const float4*>(buf + kPairHead);

  float best = kBig;
  int best_j = -1;
  for (int j = 0; j < count; ++j) {
    const float4 a = coef[5 * j], b = coef[5 * j + 1], c = coef[5 * j + 2],
                 d = coef[5 * j + 3], e = coef[5 * j + 4];
    // the old contraction's row order, its zero terms left out
    const float T = ((a.x * ox + a.y * oy) + a.z * oz) + a.w * f9;
    const float B = (b.x * dx + b.y * dy) + b.z * dz;
    const float U =
        ((((b.w * dx + c.x * dy) + c.y * dz) + c.z * cx) + c.w * cy) +
        d.x * cz;
    const float V =
        ((((d.y * dx + d.z * dy) + d.w * dz) + e.x * cx) + e.y * cy) +
        e.z * cz;
    const float FO = e.w * f9;
    const float rb = 1.0f / B;
    const float t = T * rb;
    const float u = U * rb;
    const float v = V * rb;
    const float w = 1.0f - u - v;
    const bool front = B >= 1e-8f;
    const bool ok = t >= 0.0f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
                    !(!front && FO > 0.5f);
    const float tt = ok ? t : kBig;
    if (tt < best) {  // strict: the lowest index wins a tie
      best = tt;
      best_j = j;
    }
  }
  t_out[out] = best;
  p_out[out] = best_j;
}

// Stage the six planes of page pid's real boxes into dst with cp.async,
// and commit them.
__device__ __forceinline__ void stage_boxes(float* dst,
                                            const float* __restrict__ pages,
                                            const int* __restrict__ page_count,
                                            int pid) {
  const int lane = threadIdx.x;
  const float* page = pages + static_cast<int64_t>(pid) * 16 * kBoxCols;
  if (lane < min(page_count[pid], kLanes)) {
#pragma unroll
    for (int k = 0; k < 6; ++k)  // block k's plane, on axis row k / 2
      cp_async4(dst + lane * kBoxFloats + k,
                page + (k >> 1) * kBoxCols + k * 128 + lane);
  }
  cp_async_commit();
}

// Chunk g's lane against page pid, staged in box (pid < 0: dead chunk).
__device__ __forceinline__ void boxes_chunk(const float4* box,
                                            const float* __restrict__ feats,
                                            const int* __restrict__ page_count,
                                            int pid, int g,
                                            int* __restrict__ words_out) {
  const int lane = threadIdx.x;
  int* out = words_out + static_cast<int64_t>(g) * 4 * kLanes + lane;
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (pid >= 0) {
    const float* fr = feats + static_cast<int64_t>(g) * 16 * kLanes + lane;
    const float ivx = 1.0f / fr[3 * kLanes], ivy = 1.0f / fr[4 * kLanes],
                ivz = 1.0f / fr[5 * kLanes];
    const float oivx = fr[0] * ivx, oivy = fr[kLanes] * ivy,
                oivz = fr[2 * kLanes] * ivz;
    const float tmax_row = fr[13 * kLanes];
    const int count = min(page_count[pid], kLanes);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = min(count - 32 * w, 32);
      uint32_t word = 0u;
      for (int b = 0; b < n; ++b) {
        const float4 lo = box[2 * (32 * w + b)];
        const float4 hi = box[2 * (32 * w + b) + 1];
        const float t1x = lo.x * ivx - oivx, t2x = lo.y * ivx - oivx;
        const float t1y = lo.z * ivy - oivy, t2y = lo.w * ivy - oivy;
        const float t1z = hi.x * ivz - oivz, t2z = hi.y * ivz - oivz;
        const float tmin = max_ptx(
            max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)),
            min_ptx(t1z, t2z));
        const float tmx = min_ptx(
            min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)),
            max_ptx(t1z, t2z));
        if (tmx >= tmin && tmx > 0.0f && tmin < tmax_row) word |= 1u << b;
      }
      words[w] = word;
    }
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) out[w * kLanes] = static_cast<int>(words[w]);
}

__global__ void __launch_bounds__(kLanes, kMaxBlocksPerSm)
    cluster_pairs_kernel(const float* __restrict__ clus_mt,
                         const float* __restrict__ feats,
                         const int* __restrict__ chunk_cid,
                         const int* __restrict__ clus_count,
                         float* __restrict__ t_out, int* __restrict__ p_out,
                         int n_chunks, int t_c) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int buf_floats = kPairHead + kSegs * t_c;
  auto stage = [&](int buf, int cid) {
    stage_pairs(smem + buf * buf_floats, clus_mt, clus_count, cid, t_c);
  };
  Pages pages;
  for (int g = blockIdx.x; g < n_chunks; g += gridDim.x) {
    const int cid = chunk_cid[g];
    const int gn = g + gridDim.x;
    __syncthreads();  // every thread is done with the last chunk's page
    if (cid >= 0) pages.use(cid, stage);
    pages.prefetch(gn < n_chunks ? chunk_cid[gn] : -1, stage);
    pairs_chunk(smem + pages.cur * buf_floats, feats, clus_count, cid, g,
                t_c, t_out, p_out);
  }
}

__global__ void __launch_bounds__(kLanes, kMaxBlocksPerSm)
    box_hits_kernel(const float* __restrict__ pages,
                    const float* __restrict__ feats,
                    const int* __restrict__ chunk_pid,
                    const int* __restrict__ page_count,
                    int* __restrict__ words_out, int n_chunks) {
  __shared__ float4 boxes4[2][kLanes * kBoxFloats / 4];
  auto stage = [&](int buf, int pid) {
    stage_boxes(reinterpret_cast<float*>(boxes4[buf]), pages, page_count,
                pid);
  };
  Pages staged;
  for (int g = blockIdx.x; g < n_chunks; g += gridDim.x) {
    const int pid = chunk_pid[g];
    const int gn = g + gridDim.x;
    __syncthreads();  // every thread is done with the last chunk's page
    if (pid >= 0) staged.use(pid, stage);
    staged.prefetch(gn < n_chunks ? chunk_pid[gn] : -1, stage);
    boxes_chunk(boxes4[staged.cur], feats, page_count, pid, g, words_out);
  }
}

// Blocks of a walk over `units` work items: as many as fit on the device,
// at most per_sm per SM, never more than there are units.  The SM count
// and the kernel's fit are looked up once per host thread, device and
// shared-memory size.
template <typename Kernel>
int walk_blocks(Kernel kernel, size_t smem, int units, int per_sm,
                int* blocks) {
  thread_local int cached_dev = -1, sms = 0, fit = 0;
  thread_local size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev || smem != cached_smem) {
    cached_dev = -1;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                          kLanes, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_dev = dev;
    cached_smem = smem;
  }
  const int most = sms * (fit < per_sm ? fit : per_sm);
  *blocks = units < most ? units : most;
  return 0;
}

// Let kernel take smem bytes of dynamic shared memory on the current
// device (an attribute of the device's copy, so set on every launch that
// needs more than the default).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Dynamic shared memory of a cluster-pairs walk: two page buffers.
size_t pairs_smem(int t_c) {
  return 2 * sizeof(float) * (kPairHead + kSegs * static_cast<size_t>(t_c));
}

}  // namespace

extern "C" int rt_cluster_pairs(const void* clus_mt, const void* feats,
                                const void* chunk_cid, const void* clus_count,
                                void* t, void* p, int n_chunks, int t_c,
                                void* stream) {
  const size_t smem = pairs_smem(t_c);
  int rc = allow_smem(cluster_pairs_kernel, smem);
  int blocks = 0;
  if (rc == 0)
    rc = walk_blocks(cluster_pairs_kernel, smem, n_chunks, kMaxBlocksPerSm,
                     &blocks);
  if (rc != 0) return rc;
  cluster_pairs_kernel<<<blocks, kLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(clus_mt), static_cast<const float*>(feats),
      static_cast<const int*>(chunk_cid), static_cast<const int*>(clus_count),
      static_cast<float*>(t), static_cast<int*>(p), n_chunks, t_c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_box_hits(const void* pages, const void* feats,
                           const void* chunk_pid, const void* page_count,
                           void* words, int n_chunks, void* stream) {
  int blocks = 0;
  const int rc =
      walk_blocks(box_hits_kernel, 0, n_chunks, kMaxBlocksPerSm, &blocks);
  if (rc != 0) return rc;
  box_hits_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pages), static_cast<const float*>(feats),
      static_cast<const int*>(chunk_pid),
      static_cast<const int*>(page_count), static_cast<int*>(words),
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
