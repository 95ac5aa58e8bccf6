// Variants of forest_walk_kernel (ray_tracer_tpu_torch/csrc/bvh2_walk.cu),
// the forest walk, and the design it replaced: built and launched by
// tools/forest_walk_variants.py (for chip_smoke.py, tools/
// measure_forest_walk.py and the GPU tests); not part of the package's
// library.  Every variant computes exactly what forest_walk_kernel
// computes: the same instances walked in the same order with the same
// bound, so the same outputs (the callers hold them together with
// torch.equal).  Times: tools/measure_forest_walk.py, at 2^18 bin-ordered
// rays of the forest frame's camera, bounce and shadow sets, in turns
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md), in ms.
//
//   old           old_forest_kernel, the forest walk before the cull (PR
//                 17), verbatim but for its names: every instance taken to
//                 object space and its root's box tested.
//                 0.574, 0.877, 0.279
//   flat_best     flat_forest_kernel<., true, 8>: the world-box cull in
//                 the instance loop, each instance's box staged in shared
//                 memory with its transform and root, the cull's test on
//                 the best t included.  0.471, 0.760, 0.228
//   flat          the same without the test on the best t.
//                 0.478, 0.765, 0.227
//   blocks6_flat  flat_best at 6 blocks an SM (80 registers) instead of 8
//                 (64).  0.492, 0.773, 0.227
//   flat_mask     tree_forest_kernel<., false, true>: the flat cull of each
//                 staged chunk into a candidate mask first, then the set
//                 bits in ascending order.  0.425, 0.557, 0.186
//   tree_shared   tree_forest_kernel<., true, true>: the chunk's tree
//                 walked into the mask, the tree and the instances staged
//                 in shared memory between two barriers a chunk.
//                 0.394, 0.497, 0.177
//   shipped_copy  forest_walk_kernel<., false> as it ships: the tree
//                 walked into the mask, nothing staged.
//                 0.355, 0.478, 0.163
//   blocks6       the shipped kernel at 6 blocks an SM instead of 8.
// The flat variants take the scene's per-instance world boxes (the rows
// of kernels/packet.py::forest_cull_table) in ForestArgs::cull, the others
// the chunk trees (forest_cull_trees).

#include "../ray_tracer_tpu_torch/csrc/bvh2_walk.cu"

namespace {

// One instance of a forest as a block stages it: the first three rows of
// its inverse transform (m0..m2) and its root's box and word (a = min.xyz,
// max.x; b = max.yz, the root's word as bits, unused).
struct OldInstance {
  float4 m0, m1, m2, a, b;
};

constexpr int kOldMinBlocks = 8;  // blocks per SM: at most 64 registers
constexpr int kOldChunk = 128;    // instances staged at a time (10 KiB)

// Every instance of a forest in turn, one thread per ray: the ray taken to
// the instance's object space (the plain version's expressions, in its
// order), the root's box tested against the best t so far, the tree walked
// from the root's word, bounded by that t.  A later instance replaces an
// earlier one at a strictly smaller t only.  Closest hit: dst, prim, obj
// (-1 on a miss), u, v, front.  kAnyhit: the ray's bound falls to -BIG at
// its first instance hit, which ends its scan; `occluded` says whether it
// fell.
template <bool kAnyhit>
__global__ void __launch_bounds__(kBlock, kOldMinBlocks)
    old_forest_kernel(const float4* __restrict__ nodes,
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
  __shared__ OldInstance table[kOldChunk];
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
  for (int base = 0; base < n_obj; base += kOldChunk) {
    const int m = min(kOldChunk, n_obj - base);
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += kBlock) {
      const int k = base + e;
      const int root = __ldg(roots + k);
      OldInstance s;
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
      const OldInstance& s = table[e];
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


// ---- the flat cull (variants flat_best, flat, blocks6_flat) ---------------

// One instance of a forest as the flat variants stage it: its world box
// (lo = min.xyz, eta; hi = max.xyz, delta: its row of forest_cull_table),
// the first three rows of its inverse transform (m0..m2) and its root's box
// and word (a = min.xyz, max.x; b = max.yz, the root's word as bits).
struct FlatInstance {
  float4 lo, hi, m0, m1, m2, a, b;
};

// The forest walk with the cull in the instance loop: each chunk of 128
// instances staged (14 KiB) between two barriers, each instance's world
// box tested (with the test on the best t under kBestCull) before the
// object-space path.
template <bool kAnyhit, bool kBestCull, int kMinBlk>
__global__ void __launch_bounds__(kBlock, kMinBlk)
    flat_forest_kernel(const ForestArgs a) {
  __shared__ FlatInstance table[kForestChunk];
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
  const Ray w = make_ray(ox, oy, oz, dx, dy, dz);
  const float m_o = max_ptx(max_ptx(fabsf(ox), fabsf(oy)), fabsf(oz));
  int prim = -1, obj = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  for (int base = 0; base < a.n_obj; base += kForestChunk) {
    const int m = min(kForestChunk, a.n_obj - base);
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += kBlock) {
      const int k = base + e;
      const int root = __ldg(a.roots + k);
      FlatInstance s;
      s.lo = __ldg(a.cull + 2 * k);
      s.hi = __ldg(a.cull + 2 * k + 1);
      s.m0 = __ldg(a.inv + 4 * k);
      s.m1 = __ldg(a.inv + 4 * k + 1);
      s.m2 = __ldg(a.inv + 4 * k + 2);
      s.a = __ldg(a.nodes + 2 * root);
      s.b = __ldg(a.nodes + 2 * root + 1);
      s.b.z = __uint_as_float(__ldg(a.words + k));
      table[e] = s;
    }
    __syncthreads();
#pragma unroll 1
    for (int e = 0; e < m && best > 0.0f; ++e) {
      const FlatInstance& s = table[e];
      if (culled<kBestCull>(s.lo, s.hi, w, m_o, best) && best <= kBig)
        continue;
      const float px = ((s.m0.x * ox + s.m0.y * oy) + s.m0.z * oz) + s.m0.w;
      const float py = ((s.m1.x * ox + s.m1.y * oy) + s.m1.z * oz) + s.m1.w;
      const float pz = ((s.m2.x * ox + s.m2.y * oy) + s.m2.z * oz) + s.m2.w;
      const float qx = (s.m0.x * dx + s.m0.y * dy) + s.m0.z * dz;
      const float qy = (s.m1.x * dx + s.m1.y * dy) + s.m1.z * dz;
      const float qz = (s.m2.x * dx + s.m2.y * dy) + s.m2.z * dz;
      const Ray y = make_ray(px, py, pz, qx, qy, qz);
      if (!(entry(s.a, s.b, y) < best)) continue;
      int p = -1;
      walk(a.nodes, a.axis, a.tris, y, __float_as_uint(s.b.z), true, best, p,
           bu, bv, bfront);
      if (p >= 0) {
        prim = p;
        obj = base + e;
        if (kAnyhit) best = -kBig;
      }
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

// ---- the candidate mask, staged (variants flat_mask, tree_shared) ----------

// Instance k as the staged mask variants read it from device memory.
__device__ __forceinline__ OldInstance load_instance(const ForestArgs& a,
                                                    int k) {
  const int root = __ldg(a.roots + k);
  OldInstance s;
  s.m0 = __ldg(a.inv + 4 * k);
  s.m1 = __ldg(a.inv + 4 * k + 1);
  s.m2 = __ldg(a.inv + 4 * k + 2);
  s.a = __ldg(a.nodes + 2 * root);
  s.b = __ldg(a.nodes + 2 * root + 1);
  s.b.z = __uint_as_float(__ldg(a.words + k));
  return s;
}

// The forest walk with each chunk's candidates gathered into a mask
// first: kTree, by walking the chunk's tree (a.cull holds kTreeRows nodes
// a chunk, two float4 each: lo.xyz, eta | hi.xyz, word); else by the flat
// cull of each of the chunk's world boxes (a.cull: the per-instance rows)
// in turn.  The block stages each chunk's instances and tree (or boxes)
// in shared memory between two barriers.
template <bool kAnyhit, bool kTree>
__global__ void __launch_bounds__(kBlock, kForestMinBlocks)
    tree_forest_kernel(const ForestArgs a) {
  __shared__ OldInstance table[kForestChunk];
  __shared__ float4 node[2 * kTreeRows];
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
  const Ray w = make_ray(ox, oy, oz, dx, dy, dz);
  const float m_o = max_ptx(max_ptx(fabsf(ox), fabsf(oy)), fabsf(oz));
  int prim = -1, obj = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  for (int base = 0; base < a.n_obj; base += kForestChunk) {
    const int m = min(kForestChunk, a.n_obj - base);
    const float4* rows =
        a.cull + 2 * (kTree ? kTreeRows * (base / kForestChunk) : base);
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += kBlock)
      table[e] = load_instance(a, base + e);
    for (int r = threadIdx.x; r < 2 * (kTree ? 2 * m - 1 : m); r += kBlock)
      node[r] = __ldg(rows + r);
    __syncthreads();
    const float4* nd = node;
    if (!(best > 0.0f)) continue;
    uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0;
    if (!(best <= kBig)) {  // the root's test passes on a miss: keep all
      auto first = [m](int q) {
        const int b = min(max(m - 32 * q, 0), 32);
        return b == 32 ? ~0u : (1u << b) - 1u;
      };
      k0 = first(0);
      k1 = first(1);
      k2 = first(2);
      k3 = first(3);
    } else if (!kTree) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t bits = 0;
        const int top = min(32, m - 32 * q);
#pragma unroll 1
        for (int b = 0; b < top; ++b) {
          const int e = 32 * q + b;
          if (!culled<true>(nd[2 * e], nd[2 * e + 1], w, m_o, best))
            bits |= 1u << b;
        }
        if (q == 0) k0 = bits;
        if (q == 1) k1 = bits;
        if (q == 2) k2 = bits;
        if (q == 3) k3 = bits;
      }
    } else {
      int stack[kTreeStack];
      int sp = 0, cur = 0;
      bool live = !culled<true>(nd[0], nd[1], w, m_o, best);
      while (live) {
        const uint32_t word = __float_as_uint(nd[2 * cur + 1].w);
        if (word & kTreeLeaf) {
          const int e = static_cast<int>(word & (kTreeLeaf - 1u));
          const uint32_t bit = 1u << (e & 31);
          k0 |= (e >> 5) == 0 ? bit : 0u;
          k1 |= (e >> 5) == 1 ? bit : 0u;
          k2 |= (e >> 5) == 2 ? bit : 0u;
          k3 |= (e >> 5) == 3 ? bit : 0u;
          live = sp > 0;
          if (live) cur = stack[--sp];
          continue;
        }
        const int c = static_cast<int>(word);
        const bool in0 =
            !culled<true>(nd[2 * c], nd[2 * c + 1], w, m_o, best);
        const bool in1 =
            !culled<true>(nd[2 * c + 2], nd[2 * c + 3], w, m_o, best);
        if (in0) {
          if (in1) stack[sp++] = c + 1;
          cur = c;
        } else if (in1) {
          cur = c + 1;
        } else {
          live = sp > 0;
          if (live) cur = stack[--sp];
        }
      }
    }
    // the candidates in ascending order, through the object-space path
#pragma unroll 1
    while (best > 0.0f) {
      int e;
      if (k0) {
        e = __ffs(k0) - 1;
        k0 &= k0 - 1u;
      } else if (k1) {
        e = 31 + __ffs(k1);
        k1 &= k1 - 1u;
      } else if (k2) {
        e = 63 + __ffs(k2);
        k2 &= k2 - 1u;
      } else if (k3) {
        e = 95 + __ffs(k3);
        k3 &= k3 - 1u;
      } else {
        break;
      }
      const OldInstance& s = table[e];
      const float px = ((s.m0.x * ox + s.m0.y * oy) + s.m0.z * oz) + s.m0.w;
      const float py = ((s.m1.x * ox + s.m1.y * oy) + s.m1.z * oz) + s.m1.w;
      const float pz = ((s.m2.x * ox + s.m2.y * oy) + s.m2.z * oz) + s.m2.w;
      const float qx = (s.m0.x * dx + s.m0.y * dy) + s.m0.z * dz;
      const float qy = (s.m1.x * dx + s.m1.y * dy) + s.m1.z * dz;
      const float qz = (s.m2.x * dx + s.m2.y * dy) + s.m2.z * dz;
      const Ray y = make_ray(px, py, pz, qx, qy, qz);
      if (!(entry(s.a, s.b, y) < best)) continue;
      int p = -1;
      walk(a.nodes, a.axis, a.tris, y, __float_as_uint(s.b.z), true, best, p,
           bu, bv, bfront);
      if (p >= 0) {
        prim = p;
        obj = base + e;
        if (kAnyhit) best = -kBig;
      }
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

template <bool kAnyhit>
void launch_variant(int variant, const ForestArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n + kBlock - 1) / kBlock), block(kBlock);
  switch (variant) {
    case 0:  // old
      old_forest_kernel<kAnyhit><<<grid, block, 0, stream>>>(
          a.nodes, a.axis, a.tris, a.inv, a.roots, a.words, a.n_obj,
          a.origin, a.direction, a.tmax0, a.dst, a.prim, a.obj, a.u, a.v,
          a.front, a.occluded, a.n);
      break;
    case 1:  // flat_best
      flat_forest_kernel<kAnyhit, true, 8><<<grid, block, 0, stream>>>(a);
      break;
    case 2:  // flat
      flat_forest_kernel<kAnyhit, false, 8><<<grid, block, 0, stream>>>(a);
      break;
    case 3:  // blocks6_flat
      flat_forest_kernel<kAnyhit, true, 6><<<grid, block, 0, stream>>>(a);
      break;
    case 4:  // flat_mask
      tree_forest_kernel<kAnyhit, false><<<grid, block, 0, stream>>>(a);
      break;
    case 5:  // tree_shared
      tree_forest_kernel<kAnyhit, true><<<grid, block, 0, stream>>>(a);
      break;
    case 6:  // shipped_copy
      forest_walk_kernel<kAnyhit, false><<<grid, block, 0, stream>>>(a);
      break;
    case 7:  // blocks6
      forest_walk_kernel<kAnyhit, false, 6><<<grid, block, 0, stream>>>(a);
      break;
  }
}

}  // namespace

// One launch of variant `variant` (forest_walk_variants.py's VARIANTS) on
// rt_forest_walk's arguments (no audit); `cull` is the per-instance rows
// for the flat variants, the chunk trees for the others.  Returns the
// launch's CUDA error.
extern "C" int rt_forest_variant(int variant, const void* nodes,
                                 const void* axis, const void* tris,
                                 const void* inv, const void* roots,
                                 const void* words, const void* cull,
                                 int n_obj, const void* origin,
                                 const void* direction, const void* tmax0,
                                 int anyhit, void* dst, void* prim, void* obj,
                                 void* u, void* v, void* front,
                                 void* occluded, int n, void* stream) {
  const ForestArgs a =
      forest_args(nodes, axis, tris, inv, roots, words, cull, n_obj, origin,
                  direction, tmax0, dst, prim, obj, u, v, front, occluded,
                  nullptr, n);
  const auto s = static_cast<cudaStream_t>(stream);
  if (anyhit)
    launch_variant<true>(variant, a, s);
  else
    launch_variant<false>(variant, a, s);
  return static_cast<int>(cudaGetLastError());
}
