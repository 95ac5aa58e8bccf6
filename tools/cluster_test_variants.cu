// Other forms of the cluster route's chunk kernels
// (ray_tracer_tpu_torch/csrc/cluster_test.cu); not part of the package's
// library.  Built and timed against the shipped kernels by chip_smoke.py
// (`cluster_vs_old`) and tools/measure_cluster_test.py, through
// tools/cluster_test_variants.py, which holds them together with
// torch.equal.  Every form computes exactly what the shipped kernels
// compute; they differ in how.
//
// Variant 0, the kernels before the redesign.  cluster_pairs_old_kernel:
// one block per chunk stages the whole (16, 5*t_c) page and contracts it
// against the lane's 16 feature rows term by term (5 blocks x 16 rows per
// triangle, zeros included), over all t_c columns.  box_hits_old_kernel:
// one block per chunk stages page rows 0-2 and forms each slab plane from
// three products, over all 128 columns, with compare-and-select
// NaN-propagating min/max.  Neither reads the count inputs.
//
// Variants 1-7, the shipped kernels' walk at other settings:
// pairs_walk_kernel<kTile, kBlocks> and boxes_walk_kernel<kTile, kBlocks>
// stage and test chunks as the shipped kernels do (the same device
// functions), but block b walks tiles b, b + gridDim.x, ... of kTile
// consecutive chunks, with at most kBlocks blocks per SM (which also caps
// the registers at 65536 / (128 kBlocks)).  <1, 8> is the shipped walk.

#include "../ray_tracer_tpu_torch/csrc/cluster_test.cu"

namespace {

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(kLanes)
    cluster_pairs_old_kernel(const float* __restrict__ clus_mt,
                             const float* __restrict__ feats,
                             const int* __restrict__ chunk_cid,
                             float* __restrict__ t_out,
                             int* __restrict__ p_out, int t_c) {
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
    box_hits_old_kernel(const float* __restrict__ pages,
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
  for (int k = lane; k < 3 * kBoxCols / 4; k += kLanes)
    dst[k] = __ldg(src + k);
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

// The next chunk of block b's walk after chunk g (n_chunks when none).
template <int kTile>
__device__ __forceinline__ int next_chunk(int g, int n_chunks) {
  const int g1 = g + 1;
  if (g1 % kTile != 0) return g1 < n_chunks ? g1 : n_chunks;
  const int g2 = g1 + (gridDim.x - 1) * kTile;
  return g2 < n_chunks ? g2 : n_chunks;
}

template <int kTile, int kBlocks>
__global__ void __launch_bounds__(kLanes, kBlocks)
    pairs_walk_kernel(const float* __restrict__ clus_mt,
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
  for (int g = blockIdx.x * kTile; g < n_chunks;) {
    const int cid = chunk_cid[g];
    const int gn = next_chunk<kTile>(g, n_chunks);
    __syncthreads();
    if (cid >= 0) pages.use(cid, stage);
    pages.prefetch(gn < n_chunks ? chunk_cid[gn] : -1, stage);
    pairs_chunk(smem + pages.cur * buf_floats, feats, clus_count, cid, g,
                t_c, t_out, p_out);
    g = gn;
  }
}

template <int kTile, int kBlocks>
__global__ void __launch_bounds__(kLanes, kBlocks)
    boxes_walk_kernel(const float* __restrict__ pages,
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
  for (int g = blockIdx.x * kTile; g < n_chunks;) {
    const int pid = chunk_pid[g];
    const int gn = next_chunk<kTile>(g, n_chunks);
    __syncthreads();
    if (pid >= 0) staged.use(pid, stage);
    staged.prefetch(gn < n_chunks ? chunk_pid[gn] : -1, stage);
    boxes_chunk(boxes4[staged.cur], feats, page_count, pid, g, words_out);
    g = gn;
  }
}

template <int kTile, int kBlocks>
int pairs_walk(const void* clus_mt, const void* feats, const void* chunk_cid,
               const void* clus_count, void* t, void* p, int n_chunks,
               int t_c, cudaStream_t stream) {
  const size_t smem = pairs_smem(t_c);
  int rc = allow_smem(pairs_walk_kernel<kTile, kBlocks>, smem);
  int blocks = 0;
  if (rc == 0)
    rc = walk_blocks(pairs_walk_kernel<kTile, kBlocks>, smem,
                     (n_chunks + kTile - 1) / kTile, kBlocks, &blocks);
  if (rc != 0) return rc;
  pairs_walk_kernel<kTile, kBlocks><<<blocks, kLanes, smem, stream>>>(
      static_cast<const float*>(clus_mt), static_cast<const float*>(feats),
      static_cast<const int*>(chunk_cid), static_cast<const int*>(clus_count),
      static_cast<float*>(t), static_cast<int*>(p), n_chunks, t_c);
  return static_cast<int>(cudaGetLastError());
}

template <int kTile, int kBlocks>
int boxes_walk(const void* pages, const void* feats, const void* chunk_pid,
               const void* page_count, void* words, int n_chunks,
               cudaStream_t stream) {
  int blocks = 0;
  const int rc = walk_blocks(boxes_walk_kernel<kTile, kBlocks>, 0,
                             (n_chunks + kTile - 1) / kTile, kBlocks, &blocks);
  if (rc != 0) return rc;
  boxes_walk_kernel<kTile, kBlocks><<<blocks, kLanes, 0, stream>>>(
      static_cast<const float*>(pages), static_cast<const float*>(feats),
      static_cast<const int*>(chunk_pid),
      static_cast<const int*>(page_count), static_cast<int*>(words),
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shipped entry points' arguments after the variant id: 0 the old
// kernels, then (tile, blocks per SM) (1, 8) (2, 8) (4, 8) (8, 8) (16, 8)
// (1, 4) (1, 6).
extern "C" int rt_cluster_pairs_variant(int variant, const void* clus_mt,
                                        const void* feats,
                                        const void* chunk_cid,
                                        const void* clus_count, void* t,
                                        void* p, int n_chunks, int t_c,
                                        void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto args = [&](auto walk) {
    return walk(clus_mt, feats, chunk_cid, clus_count, t, p, n_chunks, t_c,
                stream);
  };
  switch (variant) {
    case 0: {
      const size_t smem = sizeof(float) * 16 * 5 * static_cast<size_t>(t_c);
      const int rc = allow_smem(cluster_pairs_old_kernel, smem);
      if (rc != 0) return rc;
      cluster_pairs_old_kernel<<<n_chunks, kLanes, smem, stream>>>(
          static_cast<const float*>(clus_mt),
          static_cast<const float*>(feats),
          static_cast<const int*>(chunk_cid), static_cast<float*>(t),
          static_cast<int*>(p), t_c);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return args(pairs_walk<1, 8>);
    case 2: return args(pairs_walk<2, 8>);
    case 3: return args(pairs_walk<4, 8>);
    case 4: return args(pairs_walk<8, 8>);
    case 5: return args(pairs_walk<16, 8>);
    case 6: return args(pairs_walk<1, 4>);
    case 7: return args(pairs_walk<1, 6>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rt_box_hits_variant(int variant, const void* pages,
                                   const void* feats, const void* chunk_pid,
                                   const void* page_count, void* words,
                                   int n_chunks, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto args = [&](auto walk) {
    return walk(pages, feats, chunk_pid, page_count, words, n_chunks,
                stream);
  };
  switch (variant) {
    case 0:
      box_hits_old_kernel<<<n_chunks, kLanes, 0, stream>>>(
          static_cast<const float*>(pages), static_cast<const float*>(feats),
          static_cast<const int*>(chunk_pid), static_cast<int*>(words));
      return static_cast<int>(cudaGetLastError());
    case 1: return args(boxes_walk<1, 8>);
    case 2: return args(boxes_walk<2, 8>);
    case 3: return args(boxes_walk<4, 8>);
    case 4: return args(boxes_walk<8, 8>);
    case 5: return args(boxes_walk<16, 8>);
    case 6: return args(boxes_walk<1, 4>);
    case 7: return args(boxes_walk<1, 6>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
