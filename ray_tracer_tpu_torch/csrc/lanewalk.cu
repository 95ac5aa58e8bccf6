// Rope-walk traversal over per-octant BOX-row streams, one thread per ray
// (sm_90a): closest hit and occlusion.
//
// Replaces ray_tracer_tpu/kernels/lanewalk.py::_lanewalk_kernel.  The TPU
// kernel walks 8 gangs of 128 lanes per block, each gang with a shared page
// cursor over the stream's 128-row pages, fetching each lane's row with a
// lane gather and computing both row interpretations (box and triangle) as
// dense vector work.  None of that is carried over: each thread walks its
// own ray, and the stream holds only the tree's boxes; a leaf's triangles
// are read from the scene's triangle table.  The arithmetic is
// lanewalk.py:219-271, expression for expression.
//
// Stream (kernels/lanewalk.py builds it and holds the plain torch twin,
// lanewalk_traverse_reference; scene/types.py::rope_box_rows converts the
// JAX package's streams): streams (8, R, 8) f32, one 32 B BOX row per
// binary node in each direction octant's preorder, where an interior
// node's first child (its octant hit link) is the next row:
//   0:3 bmin | 3:6 bmax | 6 miss row (an f32 VALUE: a BOX-row id, or
//   kDead = 2^24, which ends the walk) | 7 leaf word (i32 bits: 0 on an
//   interior node; count << 24 | first on a leaf, whose triangles are
//   tri_packed rows first .. first + count - 1; count 1..126 and first
//   below 2^24, so the bits are those of a finite float)
// tri_packed (T, 16) f32: v0 | e1 | e2 | n | front_only | ...
// Contract: origin, direction (N,3) f32, tmax0 (N,) f32 (<= -kBig/2 =
// inactive lane), octant (N,) i32 (the stream each ray walks) -> dst (N,)
// f32 (closest accepted t from tmax0, or under ANYHIT -kBig at the first
// accepted hit), prim (N,) i32 global triangle id, -1 on a miss and under
// ANYHIT.  A box the ray enters within the current best leads on to the
// next row (interior) or to its triangles, tested in order with strict <
// against the current best, and then to the miss row (leaf); a box it
// misses to the miss row.  That is the old stream's walk, whose TRI rows
// followed their leaf's BOX row and whose last TRI row linked to the
// leaf's miss row: the same tests in the same order, so dst and prim equal
// it bit for bit.  Every link moves forward in the preorder, so a walk
// takes at most R BOX steps; a ray still walking after max_steps, pointed
// outside its stream, or at triangles past T, sets *err and stops (a
// malformed stream cannot hang the card).
//
// Exactness: built with --fmad=false and without fast math, every
// expression rounds like the torch twin's separate ops; min/max propagate
// NaN as torch.minimum/maximum do (walk_common.cuh).
//
// What bounds it on this card: dependent loads in divergent warps.  A
// step's row address is the previous step's result; the arithmetic is 22
// FP32 operations a box and 40 a triangle.  On the main-path frame's
// bounce rays a ray takes about 60 BOX steps and 17 triangle tests.  What
// the design does (each element timed against its own removal by
// tools/measure_rope_walk.py, whose variants of this kernel are
// tools/rope_walk_variants.cu, on bounce (closest hit) and shadow
// (occlusion) rays of that frame at 2^18 and 2^22 lanes; NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md):
//   * BOX rows only, 32 B, triangles from tri_packed: the streams of the
//     main-path scene are 8 x 97,393 x 32 B = 25 MB beside the 18 MB
//     triangle table, against 196 MB of 64 B BOX and TRI rows before, and
//     build 9x faster.  The walk gained 1.04-1.13x from them on closest
//     hit and nothing on occlusion (0.98-0.99x).
//   * A leaf's triangles one per step, as the old TRI rows were: all of a
//     leaf in the step that enters it ran 1.18-1.32x slower.
//   * Closest hit: every lane loads its step's 64 B before the step
//     branches on its kind (1.19-1.22x); a BOX step's second 32 B are row
//     cur + 1, which the step tests too where the ray enters interior node
//     cur (1.02-1.06x).  Occlusion, whose lanes leave at their first hit:
//     each branch loads its own row (1.03-1.05x), and no pair (which costs
//     1.03-1.06x there).
//   * min/max with NaN propagation in one instruction: 1.13-1.15x.
//   * Registers pinned at 56 (kMinBlocks blocks of 128 threads per SM):
//     within 2% of free, 64, 48 and 40 on closest hit.
// Measured and left out: the while-while order (1.02-1.09x slower on
// closest hit, where lanes enter leaves at scattered steps), an L1
// prefetch of row cur + 1 (1.04-1.19x slower).  Against the kernel it
// replaced 1.06-1.22x on closest hit, 1.02-1.09x on occlusion.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMinBlocks = 9;  // blocks per SM: at most 56 registers
constexpr float kBig = 99999999.0f;
constexpr int kDead = 1 << 24;

struct RopeArgs {
  const float4* streams;  // (8, n_rows, 8) f32
  const float4* tris;     // (n_tris, 16) f32
  const float* origin;
  const float* direction;
  const float* tmax0;
  const int* octant;
  float* dst;
  int* prim;
  int* err;
  int n, n_rows, n_tris, max_steps;
};

struct RopeRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab test of BOX row (a, b) against best (lanewalk.py:219-237).
__device__ __forceinline__ bool box_enter(const float4& a, const float4& b,
                                          const RopeRay& y, float best) {
  const float t1x = (a.x - y.ox) * y.ix, t2x = (a.w - y.ox) * y.ix;
  const float t1y = (a.y - y.oy) * y.iy, t2y = (b.x - y.oy) * y.iy;
  const float t1z = (a.z - y.oz) * y.iz, t2z = (b.y - y.oz) * y.iz;
  const float t_near = max_ptx(
      max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)), min_ptx(t1z, t2z));
  const float t_far = min_ptx(
      min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)), max_ptx(t1z, t2z));
  return t_far >= t_near && t_far > 0.0f && max_ptx(t_near, 0.0f) < best;
}

// Moller-Trumbore of a tri_packed row loaded as (a, b, c, front_only):
// v0 a.xyz, e1 (a.w, b.x, b.y), e2 (b.z, b.w, c.x), n (c.y, c.z, c.w).
// True, with its t, where the ray accepts it.
__device__ __forceinline__ bool tri_accept(const float4& a, const float4& b,
                                           const float4& c, float front_only,
                                           const RopeRay& y, float& t) {
  const float rx = y.ox - a.x, ry = y.oy - a.y, rz = y.oz - a.z;
  const float qx = ry * y.dz - rz * y.dy;
  const float qy = rz * y.dx - rx * y.dz;
  const float qz = rx * y.dy - ry * y.dx;
  const float d0 = -(y.dx * c.y + y.dy * c.z + y.dz * c.w);
  const float dinv = 1.0f / d0;
  t = (rx * c.y + ry * c.z + rz * c.w) * dinv;
  const float u = (b.z * qx + b.w * qy + c.x * qz) * dinv;
  const float v = -(a.w * qx + b.x * qy + b.y * qz) * dinv;
  const float w = 1.0f - u - v;
  const bool front = d0 >= 1e-8f;
  return t >= 0.0f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
         !(!front && front_only > 0.5f);
}

// The walk of ray i.  One loop, each step a triangle of the leaf the ray
// entered last, or a BOX row.  Closest hit: every lane loads 64 B before
// the step branches on what it loaded (a triangle's tri_packed row, or
// BOX rows cur and cur + 1), so the lanes of a warp wait on one round of
// loads a step whatever mix of kinds they hold, and where the ray enters
// interior node cur the step tests its first child cur + 1 too.
// Occlusion: each branch loads its own row, 64 B or 32 B.
template <bool kAnyhit>
__device__ __forceinline__ void rope_walk(const RopeArgs& a, const int i) {
  RopeRay y;
  y.ox = a.origin[3 * i];
  y.oy = a.origin[3 * i + 1];
  y.oz = a.origin[3 * i + 2];
  // zero-direction guard (lanewalk.py:185-187)
  const float dx = a.direction[3 * i], dy = a.direction[3 * i + 1],
              dz = a.direction[3 * i + 2];
  y.dx = dx == 0.0f ? 1e-20f : dx;
  y.dy = dy == 0.0f ? 1e-20f : dy;
  y.dz = dz == 0.0f ? 1e-20f : dz;
  y.ix = 1.0f / y.dx;
  y.iy = 1.0f / y.dy;
  y.iz = 1.0f / y.dz;

  constexpr bool kPaired = !kAnyhit;
  float best = a.tmax0[i];
  int prim = -1;
  int cur = best > -kBig * 0.5f ? 0 : kDead;
  const float4* base =
      a.streams + static_cast<int64_t>(a.octant[i]) * a.n_rows * 2;
  uint32_t tri = 0u, tri_end = 0u;  // the entered leaf's triangles left
  int steps = 0;
  for (;;) {
    const bool in_leaf = tri < tri_end;
    if (!in_leaf) {
      if (cur >= kDead) break;
      if (++steps > a.max_steps || cur < 0 || cur >= a.n_rows) {
        atomicOr(a.err, 1);
        break;
      }
    }
    const float4* r =
        in_leaf ? a.tris + static_cast<int64_t>(tri) * 4 : base + 2 * cur;
    float4 q0, q1, q2, q3;
    if (kPaired) {
      // the last BOX row's second pair of loads reads it again
      const float4* r2 = in_leaf || cur + 1 < a.n_rows ? r + 2 : r;
      q0 = __ldg(r);
      q1 = __ldg(r + 1);
      q2 = __ldg(r2);
      q3 = __ldg(r2 + 1);
    }
    if (in_leaf) {
      if (!kPaired) {
        q0 = __ldg(r);
        q1 = __ldg(r + 1);
        q2 = __ldg(r + 2);
        q3 = __ldg(r + 3);
      }
      float t;  // q3.x: front_only
      if (tri_accept(q0, q1, q2, q3.x, y, t) && t < best) {
        // strict: the first triangle of a tie is kept
        if (kAnyhit) {
          best = -kBig;
          break;
        }
        best = t;
        prim = static_cast<int>(tri);
      }
      ++tri;
      continue;
    }
    if (!kPaired) {
      q0 = __ldg(r);
      q1 = __ldg(r + 1);
    }
    // a BOX row: bmin, bmax.x | bmax.yz, miss row, leaf word
    const bool enter = box_enter(q0, q1, y, best);
    const uint32_t leaf = __float_as_uint(q1.w);
    const int miss = static_cast<int>(q1.z);
    if (enter && leaf == 0u) {
      // an interior node: on to its first child, the next row, which the
      // closest-hit walk loaded with it and tests now
      ++cur;
      if (kPaired && cur < a.n_rows) {
        if (++steps > a.max_steps) {
          atomicOr(a.err, 1);
          break;
        }
        const bool enter2 = box_enter(q2, q3, y, best);
        const uint32_t leaf2 = __float_as_uint(q3.w);
        if (enter2 && leaf2 == 0u) {
          ++cur;
          continue;
        }
        cur = static_cast<int>(q3.z);
        if (!enter2) continue;
        tri = leaf2 & 0xFFFFFFu;
        tri_end = tri + (leaf2 >> 24);
        if (tri_end > static_cast<uint32_t>(a.n_tris)) {
          atomicOr(a.err, 1);
          break;
        }
      }
      continue;
    }
    cur = miss;
    if (!enter) continue;
    // a leaf: its triangles, then the miss row
    tri = leaf & 0xFFFFFFu;
    tri_end = tri + (leaf >> 24);
    if (tri_end > static_cast<uint32_t>(a.n_tris)) {
      atomicOr(a.err, 1);
      break;
    }
  }
  a.dst[i] = best;
  a.prim[i] = prim;
}

template <bool kAnyhit>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    rope_walk_kernel(const RopeArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n) rope_walk<kAnyhit>(a, i);
}

}  // namespace

// One launch of the rope walk: closest hit (anyhit 0) or occlusion
// (anyhit 1) of n rays, each over the BOX rows of its octant's stream
// (streams (8, n_rows, 8)) and the triangles of tri_packed (n_tris, 16).
// A malformed stream ORs 1 into *err.  Returns the launch's CUDA error.
extern "C" int rt_rope_walk(int anyhit, const void* streams, int n_rows,
                            const void* tri_packed, int n_tris,
                            const void* origin, const void* direction,
                            const void* tmax0, const void* octant, void* dst,
                            void* prim, int n, int max_steps, void* err,
                            void* stream) {
  const RopeArgs a{static_cast<const float4*>(streams),
                   static_cast<const float4*>(tri_packed),
                   static_cast<const float*>(origin),
                   static_cast<const float*>(direction),
                   static_cast<const float*>(tmax0),
                   static_cast<const int*>(octant),
                   static_cast<float*>(dst),
                   static_cast<int*>(prim),
                   static_cast<int*>(err),
                   n,
                   n_rows,
                   n_tris,
                   max_steps};
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    rope_walk_kernel<true><<<grid, block, 0, s>>>(a);
  } else {
    rope_walk_kernel<false><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
