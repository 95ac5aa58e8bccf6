// Binary-BVH closest-hit traversal, one thread per ray (sm_90a): the
// narrow route.
//
// Replaces ray_tracer_tpu/kernels/packet.py::_packet_kernel.  The TPU
// kernel walks a packet of rays in lockstep with one scalar stack in SMEM,
// descending a node when ANY lane of the packet wants it, near child first
// by the packet's majority direction sign.  Here each thread walks its own
// ray with a private stack, near child first by the ray's own sign on the
// node's split axis.  Only the visit order differs, so `dst`, the hit set
// and (where `prim` agrees) u, v and front are the TPU kernel's; `prim` can
// differ on exact-t ties, where the first triangle visited is kept.  The
// arithmetic is packet.py:75-203, expression for expression.
//
// Tables (kernels/packet.py holds the plain torch twin,
// packet_traverse_reference):
//   nodes  (B,8) f32  min3 | max3 | first (int32 bitcast) | count (int32
//                     bitcast): a leaf (count > 0) holds triangles
//                     first..first+count-1; an interior node (count 0) has
//                     children first and first+1.
//   axis   (B,) i32   the node's split axis (the left child holds the
//                     centroids below the split plane).
//   tris   (T,16) f32 v0 | e1 | e2 | n | front_only | obj | pad.
// Contract: origin, direction (N,3) f32, tmax0 (N,) f32 (-BIG = inactive
// lane), root and its word (below) -> dst (N,) f32 (closest accepted t,
// tmax0 on a miss), prim (N,) i32 global triangle id (-1 on a miss), u, v
// (N,) f32 (0 on a miss), front (N,) bool.
//
// The root box is tested once; every interior node slab-tests both
// children against the current best and enters those whose entry
// max(tmin, 0) lies below it, the near one first; a leaf tests its
// triangles in order with strict `<`.  The host caps tree depth at 64.
//
// Exactness: built with --fmad=false and without fast math, every
// expression rounds like the torch twin's separate ops; min/max propagate
// NaN as torch.minimum/maximum do (walk_common.cuh).
//
// What bounds it on this card: dependent-load latency in divergent warps,
// with the tables in L2.  The main-path node and triangle tables (97,393
// nodes, 3.1 MB; 284,996 triangles, 18.2 MB) fit the 50 MB L2, and a box
// test is 22 FP32 operations.  A binary BVH has about three times the
// levels of the BVH8, so a ray makes many short visits, each waiting on
// the loads that the one before decided, and a warp waits for its slowest
// lane and runs every branch that any of its lanes takes.  The design (each
// element timed against its own removal by tools/measure_narrow_walk.py,
// whose variants of this kernel, and the design it replaced, are
// tools/narrow_walk_variants.cu; factors are the variant's time over that
// of this kernel's copy in the same library, on the bounce and shadow sets
// at 2^18 and 2^22 rays, NVIDIA H100 80GB HBM3 at 700 W; PERF.md):
//   * While-while order (Aila and Laine): each lane makes interior visits
//     until it holds a leaf, then tests leaves until it pops an interior
//     node.  The lanes of a warp wait at each inner loop's end for the
//     others, so they test their leaves together instead of running a
//     leaf turn and an interior turn on every step where they disagree.
//     Each ray makes the same visits in the same order: 1.11-1.19x.
//   * One round of independent loads per interior visit.  A node travels
//     as a 32-bit word that carries what its visit needs: its `first` and,
//     for a leaf, its count, for an interior node, its split axis (the
//     layout below).  Its parent builds the word from the row it loaded
//     to test the child's box and from the child's axis, loaded with that
//     row.  So a visit issues at once the two children's rows (64
//     contiguous bytes) and their two axes, and a leaf goes straight to its
//     triangles; the old kernel waited on a reload of the node's row, then
//     the children's rows, then the node's axis: 1.01-1.11x against a pop
//     that reloads the row and axis (one round), then loads the children.
//     Two 32-bit words per entry instead of one packed word: 1.02-1.05x
//     slower.
//   * The near child stays in a register: only the far child is pushed when
//     both are entered, and the walk descends into the one entered child
//     without a stack round trip: 1.05x.
//   * PTX min.NaN / max.NaN (walk_common.cuh), one instruction each, for
//     the slab test and max(tmin, 0): 1.15-1.20x.
//   * The root's word comes from the host (CompiledScene.meta,
//     "bvh_root_word", checked against the word's limits at compile).
//   * Registers pinned at 56 (9 blocks of 128 threads per SM, no spills):
//     64 (where ptxas puts it when free) runs 0.98-1.03x of its time, 48
//     1.00-1.04x; 40 spills and runs 1.20-1.34x.
// All together 1.26-1.34x faster than the old kernel (and all elements
// off, 1.26-1.38x slower than this kernel's copy).
// Left out: re-testing a popped node's box against the shrunken best.  The
// triangles are SBVH references, whose hit can lie outside their leaf's
// clipped box, so such a cull can change dst.
//
// The forest walk (forest_walk_kernel, entry rt_forest_walk): a scene
// compiled with flatten_instances=False keeps one tree per instance, each
// in its object space.  The JAX package scans the instances
// (ray_tracer_tpu/ops/traverse.py:603-627, a lax.scan over its gather walk
// that XLA fuses); this kernel runs that scan in one launch per traversal,
// closest hit and occlusion, with the narrow walk above (walk(), shared
// with bvh2_walk_kernel) for each instance.  Its plain version is
// kernels/packet.py::forest_traverse_reference.
//   * One thread per ray loops over the K instances in their order (no
//     top-level tree: the order decides which instance wins an exact-t
//     tie, and a later instance replaces an earlier one only at a strictly
//     smaller t).  Each instance's ray is ((m00*x + m01*y) + m02*z) + m03
//     per row for the origin and (m00*dx + m01*dy) + m02*dz for the
//     direction, the JAX package's _transform_point and _transform_dir in
//     a fixed order (a matrix product's order is cuBLAS's, which no
//     --fmad=false kernel can match).
//   * A block stages the instance table in shared memory, 128 instances
//     (10 KiB) at a time: three rows of the inverse transform, the root's
//     box and its word, 80 B each.  Any K runs, in ceil(K / 128) chunks;
//     every thread of the block, those past n included, takes part in each
//     chunk's two barriers.
//   * The root's box is tested against the best t so far before the walk,
//     as the narrow walk's own first test does, so a ray skips an instance
//     whose box it enters at or beyond its best t.  Under kAnyhit the ray's
//     bound falls to -BIG at its first instance hit, which ends its scan.
//   * The per-ray cost of the scan, for each instance: 33 FP32 operations
//     for the transform (18 for the point, 15 for the direction), three
//     IEEE reciprocals and 22 for the root's slab test, about 58 in all,
//     and five 16 B shared-memory loads that a warp shares.  For
//     sponza_proxy (K = 293) that is about 17,000 operations a ray a
//     traversal before any tree is walked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMinBlocks = 9;  // blocks per SM: at most 56 registers
constexpr int kStack = 96;     // MAX_TREE_DEPTH + 32: one far child a level
constexpr float kBig = 99999999.0f;

// A node word: first << 5 | tag, tag = the leaf's triangle count (1..28) or
// kInterior + the interior node's split axis (29..31).  kernels/packet.py::
// narrow_root_word packs the root's and checks every node against these
// limits (first < 2^27).
constexpr uint32_t kTagBits = 5;
constexpr uint32_t kTagMask = (1u << kTagBits) - 1u;
constexpr uint32_t kInterior = 29;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// The ray from o along d, its zero components replaced by 1e-20
// (packet.py:75-77), and their reciprocals.
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray y;
  y.ox = ox;
  y.oy = oy;
  y.oz = oz;
  y.dx = dx == 0.0f ? 1e-20f : dx;
  y.dy = dy == 0.0f ? 1e-20f : dy;
  y.dz = dz == 0.0f ? 1e-20f : dz;
  y.ix = 1.0f / y.dx;
  y.iy = 1.0f / y.dy;
  y.iz = 1.0f / y.dz;
  return y;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        int i) {
  return make_ray(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
                  direction[3 * i], direction[3 * i + 1],
                  direction[3 * i + 2]);
}

// Entry distance of the box of a node row (a = min.xyz, max.x; b = max.yz,
// first, count), kBig where the ray misses it (packet.py:88-106).
__device__ __forceinline__ float entry(const float4 a, const float4 b,
                                       const Ray& y) {
  const float t1x = (a.x - y.ox) * y.ix, t2x = (a.w - y.ox) * y.ix;
  const float t1y = (a.y - y.oy) * y.iy, t2y = (b.x - y.oy) * y.iy;
  const float t1z = (a.z - y.oz) * y.iz, t2z = (b.y - y.oz) * y.iz;
  const float tmin = max_ptx(max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)),
                             min_ptx(t1z, t2z));
  const float tmax = min_ptx(min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)),
                             max_ptx(t1z, t2z));
  const bool hit = tmax >= tmin && tmax > 0.0f;
  return hit ? max_ptx(tmin, 0.0f) : kBig;
}

// The word of the node whose row ends in b (first, count) and whose split
// axis is `axis`.
__device__ __forceinline__ uint32_t node_word(const float4 b, int axis) {
  const int count = __float_as_int(b.w);
  const uint32_t tag =
      count > 0 ? static_cast<uint32_t>(count) : kInterior + axis;
  return (static_cast<uint32_t>(__float_as_int(b.z)) << kTagBits) | tag;
}

// The closest of triangles first..first+count-1 within best, folded into
// best, prim, u, v and front (strict <: the first triangle of a tie).
__device__ __forceinline__ void test_leaf(const float4* __restrict__ tris,
                                          int first, int count, const Ray& y,
                                          float& best, int& prim, float& bu,
                                          float& bv, bool& bfront) {
  for (int k = 0; k < count; ++k) {
    const int ti = first + k;
    const float4* rec = tris + 4 * static_cast<int64_t>(ti);
    const float4 p = __ldg(rec);      // v0.xyz, e1.x
    const float4 q = __ldg(rec + 1);  // e1.yz, e2.xy
    const float4 s = __ldg(rec + 2);  // e2.z, n.xyz
    const float4 f = __ldg(rec + 3);  // front_only, obj, pad
    const float rx = y.ox - p.x, ry = y.oy - p.y, rz = y.oz - p.z;
    const float qx = ry * y.dz - rz * y.dy;
    const float qy = rz * y.dx - rx * y.dz;
    const float qz = rx * y.dy - ry * y.dx;
    const float d0 = -(y.dx * s.y + y.dy * s.z + y.dz * s.w);
    const float dinv = 1.0f / d0;
    const float t = (rx * s.y + ry * s.z + rz * s.w) * dinv;
    const float u = (q.z * qx + q.w * qy + s.x * qz) * dinv;
    const float v = -(p.w * qx + q.x * qy + q.y * qz) * dinv;
    const float w = 1.0f - u - v;
    const bool front = d0 >= 1e-8f;
    const bool ok = t >= 0.0f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
                    !(!front && f.x > 0.5f);
    if (ok && t < best) {
      best = t;
      prim = ti;
      bu = u;
      bv = v;
      bfront = front;
    }
  }
}

// The walk of one tree from the node word `cur`, whose box the ray enters
// within best (`live`; the caller tests the root's box): the closest hit
// within best, folded into best, prim, u, v and front.
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     const int* __restrict__ axis,
                                     const float4* __restrict__ tris,
                                     const Ray& y, uint32_t cur, bool live,
                                     float& best, int& prim, float& bu,
                                     float& bv, bool& bfront) {
  uint32_t stack[kStack];  // far children, entered when popped
  int sp = 0;
  auto pop = [&]() {
    live = sp > 0;
    if (live) cur = stack[--sp];
  };
  while (live) {
    // interior visits until this lane holds a leaf (or is done)
    while (live && (cur & kTagMask) >= kInterior) {
      // the children's rows and axes: one round of independent loads
      const int first = static_cast<int>(cur >> kTagBits);
      const float4* r = nodes + 2 * first;
      const float4 a0 = __ldg(r), b0 = __ldg(r + 1);
      const float4 a1 = __ldg(r + 2), b1 = __ldg(r + 3);
      const int ax0 = __ldg(axis + first), ax1 = __ldg(axis + first + 1);
      const float e0 = entry(a0, b0, y), e1 = entry(a1, b1, y);
      const int ax = static_cast<int>((cur & kTagMask) - kInterior);
      const float dax = ax == 0 ? y.dx : (ax == 1 ? y.dy : y.dz);
      const bool neg = dax < 0.0f;  // near child: first + 1 down the axis
      const uint32_t w0 = node_word(b0, ax0), w1 = node_word(b1, ax1);
      const bool in_near = (neg ? e1 : e0) < best;
      const bool in_far = (neg ? e0 : e1) < best;
      if (in_near) {
        if (in_far) {
          if (sp >= kStack) __trap();  // unreachable: the host caps depth
          stack[sp++] = neg ? w0 : w1;
        }
        cur = neg ? w1 : w0;
      } else if (in_far) {
        cur = neg ? w0 : w1;
      } else {
        pop();
      }
    }
    // leaves until this lane pops an interior node (or is done)
    while (live && (cur & kTagMask) < kInterior) {
      test_leaf(tris, static_cast<int>(cur >> kTagBits),
                static_cast<int>(cur & kTagMask), y, best, prim, bu, bv,
                bfront);
      pop();
    }
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
    bvh2_walk_kernel(const float4* __restrict__ nodes,
                     const int* __restrict__ axis,
                     const float4* __restrict__ tris,
                     const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ tmax0, int root,
                     uint32_t root_word, float* __restrict__ dst_out,
                     int* __restrict__ prim_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, bool* __restrict__ front_out,
                     int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray y = load_ray(origin, direction, i);
  float best = tmax0[i];
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  const bool live =
      entry(__ldg(nodes + 2 * root), __ldg(nodes + 2 * root + 1), y) < best;
  walk(nodes, axis, tris, y, root_word, live, best, prim, bu, bv, bfront);
  dst_out[i] = best;
  prim_out[i] = prim;
  u_out[i] = bu;
  v_out[i] = bv;
  front_out[i] = bfront;
}

// ---- the forest walk ------------------------------------------------------

// One instance of a forest as a block stages it: the first three rows of
// its inverse transform (m0..m2) and its root's box and word (a = min.xyz,
// max.x; b = max.yz, the root's word as bits, unused).
struct Instance {
  float4 m0, m1, m2, a, b;
};

constexpr int kForestMinBlocks = 8;  // blocks per SM: at most 64 registers
constexpr int kForestChunk = 128;    // instances staged at a time (10 KiB)

// Every instance of a forest in turn, one thread per ray: the ray taken to
// the instance's object space (the plain version's expressions, in its
// order), the root's box tested against the best t so far, the tree walked
// from the root's word, bounded by that t.  A later instance replaces an
// earlier one at a strictly smaller t only.  Closest hit: dst, prim, obj
// (-1 on a miss), u, v, front.  kAnyhit: the ray's bound falls to -BIG at
// its first instance hit, which ends its scan; `occluded` says whether it
// fell.
template <bool kAnyhit>
__global__ void __launch_bounds__(kBlock, kForestMinBlocks)
    forest_walk_kernel(const float4* __restrict__ nodes,
                       const int* __restrict__ axis,
                       const float4* __restrict__ tris,
                       const float4* __restrict__ inv,
                       const int* __restrict__ roots,
                       const uint32_t* __restrict__ words, int n_obj,
                       const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ tmax0,
                       float* __restrict__ dst_out,
                       int* __restrict__ prim_out, int* __restrict__ obj_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       bool* __restrict__ front_out,
                       bool* __restrict__ occluded_out, int n) {
  __shared__ Instance table[kForestChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float best = -kBig;
  if (in) {
    ox = origin[3 * i];
    oy = origin[3 * i + 1];
    oz = origin[3 * i + 2];
    dx = direction[3 * i];
    dy = direction[3 * i + 1];
    dz = direction[3 * i + 2];
    best = tmax0[i];
  }
  int prim = -1, obj = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  // every thread of the block stages each chunk, those past n included
  for (int base = 0; base < n_obj; base += kForestChunk) {
    const int m = min(kForestChunk, n_obj - base);
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += kBlock) {
      const int k = base + e;
      const int root = __ldg(roots + k);
      Instance s;
      s.m0 = __ldg(inv + 4 * k);
      s.m1 = __ldg(inv + 4 * k + 1);
      s.m2 = __ldg(inv + 4 * k + 2);
      s.a = __ldg(nodes + 2 * root);
      s.b = __ldg(nodes + 2 * root + 1);
      s.b.z = __uint_as_float(__ldg(words + k));
      table[e] = s;
    }
    __syncthreads();
    // a lane whose bound is not above 0 enters no box: the entry is >= 0
#pragma unroll 1
    for (int e = 0; e < m && best > 0.0f; ++e) {
      const Instance& s = table[e];
      // ray_tracer_tpu/ops/traverse.py::_transform_point, _transform_dir
      const float px = ((s.m0.x * ox + s.m0.y * oy) + s.m0.z * oz) + s.m0.w;
      const float py = ((s.m1.x * ox + s.m1.y * oy) + s.m1.z * oz) + s.m1.w;
      const float pz = ((s.m2.x * ox + s.m2.y * oy) + s.m2.z * oz) + s.m2.w;
      const float qx = (s.m0.x * dx + s.m0.y * dy) + s.m0.z * dz;
      const float qy = (s.m1.x * dx + s.m1.y * dy) + s.m1.z * dz;
      const float qz = (s.m2.x * dx + s.m2.y * dy) + s.m2.z * dz;
      const Ray y = make_ray(px, py, pz, qx, qy, qz);
      if (!(entry(s.a, s.b, y) < best)) continue;
      int p = -1;
      walk(nodes, axis, tris, y, __float_as_uint(s.b.z), true, best, p, bu,
           bv, bfront);
      if (p >= 0) {
        prim = p;
        obj = base + e;
        if (kAnyhit) best = -kBig;
      }
    }
  }
  if (!in) return;
  if (kAnyhit) {
    occluded_out[i] = prim >= 0;
    return;
  }
  dst_out[i] = best;
  prim_out[i] = prim;
  obj_out[i] = obj;
  u_out[i] = bu;
  v_out[i] = bv;
  front_out[i] = bfront;
}

}  // namespace

// One launch of the narrow walk from node `root`, whose word (first << 5 |
// tag, as kernels/packet.py::narrow_root_word packs it) is root_word.
// Returns the launch's CUDA error.
extern "C" int rt_bvh2_walk(const void* nodes, const void* axis,
                            const void* tris, const void* origin,
                            const void* direction, const void* tmax0,
                            int root, unsigned root_word, void* dst,
                            void* prim, void* u, void* v, void* front, int n,
                            void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  bvh2_walk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const int*>(axis),
      static_cast<const float4*>(tris), static_cast<const float*>(origin),
      static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), root, root_word,
      static_cast<float*>(dst), static_cast<int*>(prim),
      static_cast<float*>(u), static_cast<float*>(v),
      static_cast<bool*>(front), n);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the forest walk over the n_obj instances whose inverse
// transforms (n_obj,4,4), roots and root words (kernels/packet.py::
// narrow_root_words) are given; anyhit writes `occluded` only, else dst,
// prim, obj, u, v and front.  Returns the launch's CUDA error.
extern "C" int rt_forest_walk(const void* nodes, const void* axis,
                              const void* tris, const void* inv,
                              const void* roots, const void* words,
                              int n_obj, const void* origin,
                              const void* direction, const void* tmax0,
                              int anyhit, void* dst, void* prim, void* obj,
                              void* u, void* v, void* front, void* occluded,
                              int n, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  auto kernel = anyhit ? forest_walk_kernel<true> : forest_walk_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const int*>(axis),
      static_cast<const float4*>(tris), static_cast<const float4*>(inv),
      static_cast<const int*>(roots), static_cast<const uint32_t*>(words),
      n_obj, static_cast<const float*>(origin),
      static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), static_cast<int*>(obj),
      static_cast<float*>(u), static_cast<float*>(v),
      static_cast<bool*>(front), static_cast<bool*>(occluded), n);
  return static_cast<int>(cudaGetLastError());
}
