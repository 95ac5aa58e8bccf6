// Cluster-route chunk kernels (sm_90a): the ray x triangle-cluster test
// and the ray x box-page slab test.
//
// Replaces: ray_tracer_tpu/kernels/cluster.py::_cluster_kernel
// (`cluster_pairs`) and ::_box_kernel (`box_hits`).  On the TPU each is one
// Precision.HIGHEST matrix contraction per 128-lane chunk followed by
// vector selects.  Here each block takes one chunk, stages the page it
// reads in shared memory, and each thread computes its lane's column of
// the contraction as written-out sums in a fixed row order, so the plain
// torch twins (kernels/cluster.py) round identically: built with
// --fmad=false the two agree bit for bit.  No tensor cores: TF32 would
// lose the hit distances (a 3xTF32 / wgmma design is later work).
//
// cluster_pairs: clus_mt (C,16,5*t_c) f32 pages, feats (G,16,128) f32,
//   chunk_cid (G,) i32 (-1 = dead chunk) -> t (G,128) f32 (BIG = no hit),
//   p (G,128) i32 in-cluster index of the closest accepted triangle, the
//   lowest on an exact tie (-1 = none).  Page rows: 0-2 o', 3-5 d, 6-8
//   o' x d, 9 const; the cluster anchor sits at rows 10:13 of column 0 and
//   o' = o - anchor.
//   What bounds it: FP32 arithmetic, 5 blocks x 16 multiply-adds per
//   (lane, triangle) plus the divide; the page (40 KiB at t_c = 128) is
//   read once per chunk into shared memory and broadcast to all lanes.
// box_hits: pages (P,16,6*128) f32, feats (G,16,128) f32 (rows 0-2 o, 3-5
//   d with the zero-direction guard applied, 13 tmax), chunk_pid (G,) i32
//   -> words (G,4,128) i32, bit b of word w set iff the lane's ray enters
//   box 32w+b within tmax.  Only page rows 0-2 meet non-zero features, so
//   the slab planes are raw = page[0]*iv.x + page[1]*iv.y + page[2]*iv.z;
//   NaN padding columns fail every test.
//   What bounds it: FP32 arithmetic (768 plane products per lane); rows
//   0-2 of the page (9 KiB) are staged once per chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr float kBig = 99999999.0f;
constexpr int kBoxCols = 6 * 128;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(kLanes)
    cluster_pairs_kernel(const float* __restrict__ clus_mt,
                         const float* __restrict__ feats,
                         const int* __restrict__ chunk_cid,
                         float* __restrict__ t_out, int* __restrict__ p_out,
                         int t_c) {
  extern __shared__ float page[];  // (16, 5*t_c)
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int cid = chunk_cid[g];
  const int64_t out = static_cast<int64_t>(g) * kLanes + lane;
  if (cid < 0) {
    t_out[out] = kBig;
    p_out[out] = -1;
    return;
  }
  const int cols = 5 * t_c;
  const float4* src = reinterpret_cast<const float4*>(
      clus_mt + static_cast<int64_t>(cid) * 16 * cols);
  float4* dst = reinterpret_cast<float4*>(page);
  for (int k = lane; k < 4 * cols; k += kLanes) dst[k] = __ldg(src + k);
  __syncthreads();

  const float* fr = feats + static_cast<int64_t>(g) * 16 * kLanes + lane;
  float f[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) f[r] = fr[r * kLanes];
  // cluster-local origin o' = o - anchor, and o' x d
  const float ox = f[0] - page[10 * cols];
  const float oy = f[1] - page[11 * cols];
  const float oz = f[2] - page[12 * cols];
  const float dx = f[3], dy = f[4], dz = f[5];
  f[0] = ox;
  f[1] = oy;
  f[2] = oz;
  f[6] = oy * dz - oz * dy;
  f[7] = oz * dx - ox * dz;
  f[8] = ox * dy - oy * dx;

  float best = kBig;
  int best_j = -1;
  for (int j = 0; j < t_c; ++j) {
    float q[5];
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const float* col = page + b * t_c + j;
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) acc = acc + col[r * cols] * f[r];
      q[b] = acc;
    }
    const float rb = 1.0f / q[1];
    const float t = q[0] * rb;
    const float u = q[2] * rb;
    const float v = q[3] * rb;
    const float w = 1.0f - u - v;
    const bool front = q[1] >= 1e-8f;
    const bool ok = t >= 0.0f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
                    !(!front && q[4] > 0.5f);
    // zero-padded columns: B == 0 gives t = NaN, which fails every test
    const float tt = ok ? t : kBig;
    if (tt < best) {  // strict: the lowest index wins a tie
      best = tt;
      best_j = j;
    }
  }
  t_out[out] = best;
  p_out[out] = best_j;
}

__global__ void __launch_bounds__(kLanes)
    box_hits_kernel(const float* __restrict__ pages,
                    const float* __restrict__ feats,
                    const int* __restrict__ chunk_pid,
                    int* __restrict__ words_out) {
  __shared__ float rows[3 * kBoxCols];  // page rows 0-2
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int pid = chunk_pid[g];
  int* out = words_out + static_cast<int64_t>(g) * 4 * kLanes + lane;
  if (pid < 0) {
#pragma unroll
    for (int w = 0; w < 4; ++w) out[w * kLanes] = 0;
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(
      pages + static_cast<int64_t>(pid) * 16 * kBoxCols);
  float4* dst = reinterpret_cast<float4*>(rows);
  for (int k = lane; k < 3 * kBoxCols / 4; k += kLanes) dst[k] = __ldg(src + k);
  __syncthreads();

  const float* fr = feats + static_cast<int64_t>(g) * 16 * kLanes + lane;
  const float ivx = 1.0f / fr[3 * kLanes], ivy = 1.0f / fr[4 * kLanes],
              ivz = 1.0f / fr[5 * kLanes];
  const float oivx = fr[0] * ivx, oivy = fr[kLanes] * ivy,
              oivz = fr[2 * kLanes] * ivz;
  const float tmax_row = fr[13 * kLanes];
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0u;
    for (int b = 0; b < 32; ++b) {
      const int box = 32 * w + b;
      float raw[6];
#pragma unroll
      for (int blk = 0; blk < 6; ++blk) {
        const int c = blk * 128 + box;
        raw[blk] = rows[c] * ivx + rows[kBoxCols + c] * ivy +
                   rows[2 * kBoxCols + c] * ivz;
      }
      const float t1x = raw[0] - oivx, t2x = raw[1] - oivx;
      const float t1y = raw[2] - oivy, t2y = raw[3] - oivy;
      const float t1z = raw[4] - oivz, t2z = raw[5] - oivz;
      const float tmin = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                                 min_nan(t1z, t2z));
      const float tmx = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                                max_nan(t1z, t2z));
      if (tmx >= tmin && tmx > 0.0f && tmin < tmax_row) word |= 1u << b;
    }
    out[w * kLanes] = static_cast<int>(word);
  }
}

}  // namespace

extern "C" int rt_cluster_pairs(const void* clus_mt, const void* feats,
                                const void* chunk_cid, void* t, void* p,
                                int n_chunks, int t_c, void* stream) {
  const size_t smem = sizeof(float) * 16 * 5 * static_cast<size_t>(t_c);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_pairs_kernel<<<n_chunks, kLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(clus_mt), static_cast<const float*>(feats),
      static_cast<const int*>(chunk_cid), static_cast<float*>(t),
      static_cast<int*>(p), t_c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_box_hits(const void* pages, const void* feats,
                           const void* chunk_pid, void* words, int n_chunks,
                           void* stream) {
  box_hits_kernel<<<n_chunks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pages), static_cast<const float*>(feats),
      static_cast<const int*>(chunk_pid), static_cast<int*>(words));
  return static_cast<int>(cudaGetLastError());
}
