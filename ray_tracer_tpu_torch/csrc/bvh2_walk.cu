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
// lane), root -> dst (N,) f32 (closest accepted t, tmax0 on a miss), prim
// (N,) i32 global triangle id (-1 on a miss), u, v (N,) f32 (0 on a miss),
// front (N,) bool.
//
// The root box is tested once; every interior node slab-tests both
// children against the current best and pushes those it enters (entry
// max(tmin, 0) < best), the far one first; a leaf tests its triangles in
// order with strict `<`.  A node is pushed at most once, so the stack holds
// at most one entry per level plus one: the host caps tree depth at 64.
//
// Exactness: built with --fmad=false and without fast math, every
// expression rounds like the torch twin's separate ops; min/max propagate
// NaN as torch.minimum/maximum do.
//
// What bounds it: dependent global loads, one 32 B node row per child box
// and one 64 B triangle record per triangle tested, each address depending
// on the previous pop.  The main-path node and triangle tables (97,393
// nodes, 3.1 MB; 284,996 triangles, 18.2 MB) fit the 50 MB L2; rays arrive
// sorted by the integrator's coherence bins, so the threads of a warp
// mostly read the same rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 96;  // MAX_TREE_DEPTH + 32
constexpr float kBig = 99999999.0f;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Entry distance of node `c`'s box, kBig where the ray misses it
// (packet.py:88-106).
__device__ __forceinline__ float entry(const float4* __restrict__ nodes,
                                       int c, const Ray& y) {
  const float4 a = __ldg(nodes + 2 * c);      // min.xyz, max.x
  const float4 b = __ldg(nodes + 2 * c + 1);  // max.yz, first, count
  const float t1x = (a.x - y.ox) * y.ix, t2x = (a.w - y.ox) * y.ix;
  const float t1y = (a.y - y.oy) * y.iy, t2y = (b.x - y.oy) * y.iy;
  const float t1z = (a.z - y.oz) * y.iz, t2z = (b.y - y.oz) * y.iz;
  const float tmin = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                             min_nan(t1z, t2z));
  const float tmax = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                             max_nan(t1z, t2z));
  const bool hit = tmax >= tmin && tmax > 0.0f;
  return hit ? max_nan(tmin, 0.0f) : kBig;
}

__global__ void __launch_bounds__(kBlock)
    bvh2_walk_kernel(const float4* __restrict__ nodes,
                     const int* __restrict__ axis,
                     const float4* __restrict__ tris,
                     const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ tmax0, int root,
                     float* __restrict__ dst_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     bool* __restrict__ front_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray y;
  y.ox = origin[3 * i];
  y.oy = origin[3 * i + 1];
  y.oz = origin[3 * i + 2];
  // zero-direction guard (packet.py:75-77)
  const float dx = direction[3 * i], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  y.dx = dx == 0.0f ? 1e-20f : dx;
  y.dy = dy == 0.0f ? 1e-20f : dy;
  y.dz = dz == 0.0f ? 1e-20f : dz;
  y.ix = 1.0f / y.dx;
  y.iy = 1.0f / y.dy;
  y.iz = 1.0f / y.dz;

  float best = tmax0[i];
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  int stack[kStack];
  int sp = 0;
  if (entry(nodes, root, y) < best) stack[sp++] = root;
  while (sp > 0) {
    const int node = stack[--sp];
    const float4 b = __ldg(nodes + 2 * node + 1);
    const int first = __float_as_int(b.z);
    const int count = __float_as_int(b.w);
    if (count > 0) {
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
        if (ok && t < best) {  // strict: the first triangle of a tie
          best = t;
          prim = ti;
          bu = u;
          bv = v;
          bfront = front;
        }
      }
      continue;
    }
    const float e0 = entry(nodes, first, y);
    const float e1 = entry(nodes, first + 1, y);
    const int ax = __ldg(axis + node);
    const float dax = ax == 0 ? y.dx : (ax == 1 ? y.dy : y.dz);
    const bool neg = dax < 0.0f;  // near child: first + 1 down the axis
    const float e_near = neg ? e1 : e0;
    const float e_far = neg ? e0 : e1;
    if (sp + 2 > kStack) __trap();  // unreachable: the host caps depth
    if (e_far < best) stack[sp++] = neg ? first : first + 1;
    if (e_near < best) stack[sp++] = neg ? first + 1 : first;
  }
  dst_out[i] = best;
  prim_out[i] = prim;
  u_out[i] = bu;
  v_out[i] = bv;
  front_out[i] = bfront;
}

}  // namespace

extern "C" int rt_bvh2_walk(const void* nodes, const void* axis,
                            const void* tris, const void* origin,
                            const void* direction, const void* tmax0,
                            int root, void* dst, void* prim, void* u, void* v,
                            void* front, int n, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  bvh2_walk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const int*>(axis),
      static_cast<const float4*>(tris), static_cast<const float*>(origin),
      static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), root, static_cast<float*>(dst),
      static_cast<int*>(prim), static_cast<float*>(u), static_cast<float*>(v),
      static_cast<bool*>(front), n);
  return static_cast<int>(cudaGetLastError());
}
