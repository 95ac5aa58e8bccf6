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
//   * One thread per ray takes the K instances in their order (the order
//     decides which instance wins an exact-t tie: a later instance
//     replaces an earlier one only at a strictly smaller t, so no walk
//     order of a top-level tree may replace it).  Each instance's ray is
//     ((m00*x + m01*y) + m02*z) + m03 per row for the origin and
//     (m00*dx + m01*dy) + m02*dz for the direction, the JAX package's
//     _transform_point and _transform_dir in a fixed order (a matrix
//     product's order is cuBLAS's, which no --fmad=false kernel can
//     match).  The root's box is then tested
//     against the best t so far, as the narrow walk's own first test does,
//     and the tree walked where the ray enters it within that t.  Under
//     kAnyhit the ray's bound falls to -BIG at its first instance hit,
//     which ends its scan.
//   * What bounds it: the scan, and walks that a warp runs one after the
//     other.  Taking a ray to an instance's object space costs 33 FP32
//     operations, three IEEE reciprocals and the root's 22-operation slab
//     test, and on sponza_proxy's forest (K = 293) a bounce ray of the
//     kernel before the cull scanned 229 instances to enter about 8
//     (PERF.md); and where the lanes of a warp enter different instances,
//     the warp runs each of those walks in turn while the other lanes
//     wait.
//   * So each instance first meets a conservative cull in world space: the
//     world ray's guarded reciprocals are taken once per ray, and boxes in
//     world space (kernels/packet.py::forest_cull_table, built on the host
//     once per scene) are slab-tested, about 29 FP32 operations and no
//     reciprocal (culled()).  The instances go in chunks of 128, each
//     under a binary tree of their world boxes (forest_cull_trees: a node
//     holds its children's boxes and their largest eta, so a node's test
//     passes wherever a leaf's below it would).  A ray walks each chunk's
//     tree into a mask of candidates, 128 bits in four registers, then
//     takes the set bits in ascending order: the lanes of a warp walk
//     their own candidates at once, and the order rule (the instance
//     order decides ties) needs no tie-break.  Only a candidate takes the
//     path above, unchanged, so the outputs are those of the scan without
//     the cull, bit for bit.
//   * The cull skips an instance only where the root's test must fail.
//     An instance's box is the world image of its root's box under the
//     float64 inverse of the f32 inverse transform (the matrix the kernel
//     applies), rounded outward to f32 and widened by delta_k; the kernel
//     widens it by eta_k * max|o| more.  delta_k and eta_k bound, over the
//     3x3 part's condition number, the box's coordinates and the origin's
//     size, what the f32 rounding of the object-space ray, of its
//     reciprocals and of both slab tests can move the point where the ray
//     meets the box (the argument: forest_cull_table).  The predicate is a
//     geometric miss of that box, or an entry beyond the best t at the
//     chunk's start with a relative slack of 2^-16, written so that a NaN
//     keeps the box; a lane whose best t exceeds kBig takes every instance
//     (there the root's test passes on a miss, kBig < best).
//   * Nothing is staged in shared memory: the trees (8 KiB a chunk) and a
//     candidate's instance (its inverse transform, root, word and root
//     row) are read through L1, so no barrier holds a block's warps to the
//     slowest one's chunk.
//   * The audit instance, forest_walk_kernel<., true> (kernels/packet.py::
//     forest_audit; off the path), takes every (ray, instance) pair the
//     scan reaches through the object-space path, its candidate bit the
//     cull's verdict, and counts scans, candidates, root passes, box and
//     triangle tests, the trees' box tests and violations (no candidate
//     although the root's test passes), one per-block sum and one atomic
//     per counter.
//   * Its design (tools/forest_walk_variants.cu, timed in turns by
//     tools/measure_forest_walk.py at 2^18 rays; factors against the
//     kernel before the cull, "old", on the camera, bounce and shadow
//     sets, NVIDIA H100 80GB HBM3 at 700 W; PERF.md): the flat cull in
//     the instance loop 1.21, 1.15, 1.23x; the flat cull into a mask,
//     then the candidates 1.35, 1.58, 1.50x; the chunk trees staged in
//     shared memory with the instances 1.46, 1.76, 1.58x; the same read
//     through L1 (this kernel) 1.62, 1.84, 1.72x.  The cull on the best t
//     moves the flat kernel by 1% or less, six blocks an SM against eight
//     by 5% or less (this kernel at six: 1.05x slower on camera rays,
//     1.02x faster on shadow rays; at eight it spills 36 B, at six
//     nothing).

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

// Box and triangle tests of a walk, counted by the forest walk's audit.
struct WalkCount {
  uint32_t boxes = 0, tris = 0;
};

// The walk of one tree from the node word `cur`, whose box the ray enters
// within best (`live`; the caller tests the root's box): the closest hit
// within best, folded into best, prim, u, v and front.  kCount adds the
// child boxes and triangles it tests to *count (the forest walk's audit);
// the narrow walk and the forest walk run the instance without it.
template <bool kCount = false>
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     const int* __restrict__ axis,
                                     const float4* __restrict__ tris,
                                     const Ray& y, uint32_t cur, bool live,
                                     float& best, int& prim, float& bu,
                                     float& bv, bool& bfront,
                                     WalkCount* count = nullptr) {
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
      if constexpr (kCount) count->boxes += 2;
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
      if constexpr (kCount) count->tris += cur & kTagMask;
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

constexpr int kForestMinBlocks = 8;  // blocks per SM: at most 64 registers
constexpr int kForestChunk = 128;    // instances under one tree, one mask
constexpr int kTreeRows = 2 * kForestChunk - 1;  // nodes of a chunk's tree
constexpr int kTreeStack = 8;  // far children: the host's trees are balanced
// A tree node's word (the bits of its hi.w): kTreeLeaf | e for the chunk's
// instance e, else its first child's row (the second follows it).
constexpr uint32_t kTreeLeaf = 0x80000000u;
// the cull on the best t keeps the entries up to best * (1 + 2^-16)
constexpr float kCullSlack = 1.0000152587890625f;

// The audit's counters, in the order of ForestArgs::counts.
enum {
  kScans,
  kWorldPass,
  kRootPass,
  kRoots,
  kBoxes,
  kTris,
  kViolations,
  kTreeTests,
  kCounters
};

// One forest walk's arguments (rt_forest_walk's).
struct ForestArgs {
  const float4* nodes;    // (B,8) f32 bvh_packed
  const int* axis;        // (B,) i32
  const float4* tris;     // (T,16) f32 tri_packed
  const float4* inv;      // (K,4,4) f32 inverse transforms
  const int* roots;       // (K,) i32
  const uint32_t* words;  // (K,) the roots' words
  const float4* cull;     // (ceil(K/128) * kTreeRows, 8) f32 chunk trees
  int n_obj;
  const float* origin;
  const float* direction;
  const float* tmax0;
  float* dst;
  int* prim;
  int* obj;
  float* u;
  float* v;
  bool* front;
  bool* occluded;
  unsigned long long* counts;  // the audit's kCounters sums (audit only)
  int n;
};

// Whether the world ray w, whose origin's largest |component| is m_o, may
// skip everything inside the world box lo..hi: it misses that box grown by
// eta * m_o (eta = lo.w) on every side or, under kBestCull, enters it
// beyond best * kCullSlack.  Every comparison is false on a NaN, which
// keeps the box.
template <bool kBestCull = true>
__device__ __forceinline__ bool culled(const float4 lo, const float4 hi,
                                       const Ray& w, float m_o, float best) {
  const float s = lo.w * m_o;
  const float t1x = ((lo.x - s) - w.ox) * w.ix;
  const float t2x = ((hi.x + s) - w.ox) * w.ix;
  const float t1y = ((lo.y - s) - w.oy) * w.iy;
  const float t2y = ((hi.y + s) - w.oy) * w.iy;
  const float t1z = ((lo.z - s) - w.oz) * w.iz;
  const float t2z = ((hi.z + s) - w.oz) * w.iz;
  const float tmin = max_ptx(max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)),
                             min_ptx(t1z, t2z));
  const float tmax = min_ptx(min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)),
                             max_ptx(t1z, t2z));
  return tmax < tmin || tmax < 0.0f ||
         (kBestCull && tmin > best * kCullSlack);
}

// Instance e of a chunk as a candidate: bit e of k0..k3.
__device__ __forceinline__ void set_candidate(int e, uint32_t& k0,
                                              uint32_t& k1, uint32_t& k2,
                                              uint32_t& k3) {
  const uint32_t bit = 1u << (e & 31);
  k0 |= (e >> 5) == 0 ? bit : 0u;
  k1 |= (e >> 5) == 1 ? bit : 0u;
  k2 |= (e >> 5) == 2 ? bit : 0u;
  k3 |= (e >> 5) == 3 ? bit : 0u;
}

// The lowest candidate of k0..k3, cleared, or -1 where there is none.
__device__ __forceinline__ int pop_candidate(uint32_t& k0, uint32_t& k1,
                                             uint32_t& k2, uint32_t& k3) {
  if (k0) {
    const int e = __ffs(k0) - 1;
    k0 &= k0 - 1u;
    return e;
  }
  if (k1) {
    const int e = 31 + __ffs(k1);
    k1 &= k1 - 1u;
    return e;
  }
  if (k2) {
    const int e = 63 + __ffs(k2);
    k2 &= k2 - 1u;
    return e;
  }
  if (k3) {
    const int e = 95 + __ffs(k3);
    k3 &= k3 - 1u;
    return e;
  }
  return -1;
}

// A chunk's candidates, or'ed into k0..k3: the leaves of its tree (`tree`,
// kTreeRows nodes of two float4: lo.xyz, eta | hi.xyz, word) that the ray
// reaches through nodes whose boxes the cull keeps, both children of a
// node tested together.  The visit order does not matter: the mask keeps
// the instances' own order.  kCount adds the box tests to *tests.
template <bool kCount>
__device__ __forceinline__ void chunk_candidates(
    const float4* __restrict__ tree, const Ray& w, float m_o, float best,
    uint32_t& k0, uint32_t& k1, uint32_t& k2, uint32_t& k3,
    uint32_t* tests) {
  uint32_t stack[kTreeStack];  // far children's words
  int sp = 0;
  const float4 lo = __ldg(tree), hi = __ldg(tree + 1);
  uint32_t cur = __float_as_uint(hi.w);
  bool live = !culled(lo, hi, w, m_o, best);
  if constexpr (kCount) ++*tests;
  while (live) {
    if (cur & kTreeLeaf) {
      set_candidate(static_cast<int>(cur & ~kTreeLeaf), k0, k1, k2, k3);
      live = sp > 0;
      if (live) cur = stack[--sp];
      continue;
    }
    const float4* c = tree + 2 * cur;
    const float4 lo0 = __ldg(c), hi0 = __ldg(c + 1);
    const float4 lo1 = __ldg(c + 2), hi1 = __ldg(c + 3);
    const bool in0 = !culled(lo0, hi0, w, m_o, best);
    const bool in1 = !culled(lo1, hi1, w, m_o, best);
    if constexpr (kCount) *tests += 2;
    if (in0) {
      if (in1) stack[sp++] = __float_as_uint(hi1.w);
      cur = __float_as_uint(hi0.w);
    } else if (in1) {
      cur = __float_as_uint(hi1.w);
    } else {
      live = sp > 0;
      if (live) cur = stack[--sp];
    }
  }
}

// Instance k against the ray o + t d, as the plain version takes it: the
// ray taken to the instance's object space (the plain version's
// expressions, in its order), the root's box tested against best, the
// tree walked from the root's word where the ray enters it.  A hit is
// folded into best, p, bu, bv and bfront; kCount adds the walk's tests to
// *count.  Returns whether the root's test passed.
template <bool kCount>
__device__ __forceinline__ bool instance_walk(
    const ForestArgs& a, int k, float ox, float oy, float oz, float dx,
    float dy, float dz, float& best, int& p, float& bu, float& bv,
    bool& bfront, WalkCount* count) {
  const int root = __ldg(a.roots + k);
  const float4 m0 = __ldg(a.inv + 4 * k), m1 = __ldg(a.inv + 4 * k + 1);
  const float4 m2 = __ldg(a.inv + 4 * k + 2);
  // ray_tracer_tpu/ops/traverse.py::_transform_point, _transform_dir
  const float px = ((m0.x * ox + m0.y * oy) + m0.z * oz) + m0.w;
  const float py = ((m1.x * ox + m1.y * oy) + m1.z * oz) + m1.w;
  const float pz = ((m2.x * ox + m2.y * oy) + m2.z * oz) + m2.w;
  const float qx = (m0.x * dx + m0.y * dy) + m0.z * dz;
  const float qy = (m1.x * dx + m1.y * dy) + m1.z * dz;
  const float qz = (m2.x * dx + m2.y * dy) + m2.z * dz;
  const Ray y = make_ray(px, py, pz, qx, qy, qz);
  const bool enter = entry(__ldg(a.nodes + 2 * root),
                           __ldg(a.nodes + 2 * root + 1), y) < best;
  if (enter)
    walk<kCount>(a.nodes, a.axis, a.tris, y, __ldg(a.words + k), true, best,
                 p, bu, bv, bfront, count);
  return enter;
}

// Every instance of a forest in turn, one thread per ray.  For each chunk
// of 128 instances the ray walks the chunk's tree into a mask of
// candidates (chunk_candidates; every instance where its best t exceeds
// kBig, where the root's test passes on a miss), then takes the set bits
// in ascending order through instance_walk, bounded by its best t so far.
// A later instance replaces an earlier one at a strictly smaller t only.
// Closest hit: dst, prim, obj (-1 on a miss), u, v, front.  kAnyhit: the
// ray's bound falls to -BIG at its first instance hit, which ends its
// scan; `occluded` says whether it fell.  kAudit: every instance the scan
// reaches through instance_walk, its bit the cull's verdict, and the
// counters summed into a.counts: scans (pairs whose lane's bound is above
// 0), world-box passes (candidates) and root passes, root tests (on every
// lane above -BIG, as the plain version's stats count them), box tests
// (those and the children the walks test), triangle tests, violations
// (no candidate, the root's test passing) and the trees' box tests.
template <bool kAnyhit, bool kAudit, int kMinBlk = kForestMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlk)
    forest_walk_kernel(const ForestArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < a.n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float best = -kBig;
  if (in) {
    ox = a.origin[3 * i];
    oy = a.origin[3 * i + 1];
    oz = a.origin[3 * i + 2];
    dx = a.direction[3 * i];
    dy = a.direction[3 * i + 1];
    dz = a.direction[3 * i + 2];
    best = a.tmax0[i];
  }
  // the world ray and its guarded reciprocals, once a ray
  const Ray w = make_ray(ox, oy, oz, dx, dy, dz);
  const float m_o = max_ptx(max_ptx(fabsf(ox), fabsf(oy)), fabsf(oz));
  int prim = -1, obj = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  uint32_t count[kCounters] = {};  // kAudit
  WalkCount walked;                // kAudit
  int next = 0;                    // kAudit: the first instance not reached
  // a lane whose bound is not above 0 enters no box: the entry is >= 0
  for (int base = 0; base < a.n_obj && best > 0.0f; base += kForestChunk) {
    const int m = min(kForestChunk, a.n_obj - base);
    uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0;
    if (best <= kBig) {
      chunk_candidates<kAudit>(a.cull + 2 * kTreeRows * (base / kForestChunk),
                               w, m_o, best, k0, k1, k2, k3,
                               &count[kTreeTests]);
    } else {
      for (int e = 0; e < m; ++e) set_candidate(e, k0, k1, k2, k3);
    }
    if constexpr (kAudit) {
      int e = 0;
      for (; e < m && best > 0.0f; ++e) {
        const uint32_t bits = e < 32 ? k0 : (e < 64 ? k1 : (e < 96 ? k2 : k3));
        const bool cull = !((bits >> (e & 31)) & 1u);
        int p = -1;
        const bool enter = instance_walk<true>(
            a, base + e, ox, oy, oz, dx, dy, dz, best, p, bu, bv, bfront,
            &walked);
        ++count[kScans];
        ++count[kRoots];
        ++count[kBoxes];
        count[kWorldPass] += !cull;
        count[kRootPass] += enter;
        count[kViolations] += enter && cull;
        if (p >= 0) {
          prim = p;
          obj = base + e;
          if (kAnyhit) best = -kBig;
        }
      }
      next = base + e;
    } else {
#pragma unroll 1
      while (best > 0.0f) {
        const int e = pop_candidate(k0, k1, k2, k3);
        if (e < 0) break;
        int p = -1;
        instance_walk<false>(a, base + e, ox, oy, oz, dx, dy, dz, best, p,
                             bu, bv, bfront, nullptr);
        if (p >= 0) {
          prim = p;
          obj = base + e;
          if (kAnyhit) best = -kBig;
        }
      }
    }
  }
  if constexpr (kAudit) {
    // the plain version tests the root's box of every lane above -BIG
    if (best > -kBig && !(best > 0.0f)) {
      count[kRoots] += a.n_obj - next;
      count[kBoxes] += a.n_obj - next;
    }
    count[kBoxes] += walked.boxes;
    count[kTris] = walked.tris;
    __shared__ unsigned long long part[kBlock / 32][kCounters];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < kCounters; ++c) {
      unsigned long long x = count[c];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
      if (lane == 0) part[warp][c] = x;
    }
    __syncthreads();
    if (threadIdx.x < kCounters) {
      unsigned long long sum = 0;
      for (int k = 0; k < kBlock / 32; ++k) sum += part[k][threadIdx.x];
      atomicAdd(a.counts + threadIdx.x, sum);
    }
  }
  if (!in) return;
  if (kAnyhit) {
    a.occluded[i] = prim >= 0;
    return;
  }
  a.dst[i] = best;
  a.prim[i] = prim;
  a.obj[i] = obj;
  a.u[i] = bu;
  a.v[i] = bv;
  a.front[i] = bfront;
}

// The arguments of rt_forest_walk as the kernels take them.
inline ForestArgs forest_args(const void* nodes, const void* axis,
                              const void* tris, const void* inv,
                              const void* roots, const void* words,
                              const void* cull, int n_obj,
                              const void* origin, const void* direction,
                              const void* tmax0, void* dst, void* prim,
                              void* obj, void* u, void* v, void* front,
                              void* occluded, void* counts, int n) {
  return ForestArgs{
      static_cast<const float4*>(nodes), static_cast<const int*>(axis),
      static_cast<const float4*>(tris), static_cast<const float4*>(inv),
      static_cast<const int*>(roots), static_cast<const uint32_t*>(words),
      static_cast<const float4*>(cull), n_obj,
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), static_cast<int*>(obj), static_cast<float*>(u),
      static_cast<float*>(v), static_cast<bool*>(front),
      static_cast<bool*>(occluded),
      static_cast<unsigned long long*>(counts), n};
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
// transforms (n_obj,4,4), roots, root words (kernels/packet.py::
// narrow_root_words) and chunk trees of world boxes (kernels/packet.py::
// forest_cull_trees) are given; anyhit writes `occluded` only, else dst,
// prim, obj, u, v and front.  `counts` non-null: the audit instance, which
// adds its kCounters sums to counts[0..7] (zeroed by the caller).
// Returns the launch's CUDA error.
extern "C" int rt_forest_walk(const void* nodes, const void* axis,
                              const void* tris, const void* inv,
                              const void* roots, const void* words,
                              const void* cull, int n_obj,
                              const void* origin, const void* direction,
                              const void* tmax0, int anyhit, void* dst,
                              void* prim, void* obj, void* u, void* v,
                              void* front, void* occluded, void* counts,
                              int n, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  const ForestArgs a =
      forest_args(nodes, axis, tris, inv, roots, words, cull, n_obj, origin,
                  direction, tmax0, dst, prim, obj, u, v, front, occluded,
                  counts, n);
  auto kernel = counts ? (anyhit ? forest_walk_kernel<true, true>
                                 : forest_walk_kernel<false, true>)
                       : (anyhit ? forest_walk_kernel<true, false>
                                 : forest_walk_kernel<false, false>);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
