// The rope walk before its redesign, and rope_walk_kernel
// (ray_tracer_tpu_torch/csrc/lanewalk.cu) with each design element
// switched: built and launched by tools/rope_walk_variants.py (for
// chip_smoke.py, tools/measure_rope_walk.py and the GPU tests); not part of
// the package's library.  Every variant computes exactly what
// rope_walk_kernel computes: the same boxes and triangles tested in the
// same order (the callers hold them together with torch.equal).
//
//   old_lanewalk_kernel  the kernel until rope_walk_kernel took it over, on
//       the old streams: 64 B rows (8, R, 16), a BOX row (0:3 bmin | 3:6
//       bmax | 6 hit row | 7 miss row | 15 type 0) per node, then one TRI
//       row (0:12 v0|e1|e2|n | 12 next row | 13 front_only | 14 triangle
//       id | 15 type 1) per triangle of a leaf, chained; one row per step,
//       four float4 loads, compare-select min/max, registers left to
//       ptxas.
//   copy_rope_kernel  rope_walk_kernel's walk (rope_walk) at its pin.
//   variant_rope_kernel<kAnyhit, kRows64, kTriStep, kPtx, kWhile, kNext,
//                       kLoadsFirst, kPair, kMinBlocks>
//       kRows64     the old 64 B rows, the BOX rows carrying their leaf's
//                   triangle count in float 8 (0: interior), the TRI rows
//                   after them read as a leaf's triangles; else the 32 B
//                   BOX rows with the triangles from tri_packed.
//       kTriStep    one triangle per step (a step is a BOX row or one
//                   triangle); else an entered leaf's triangles, all of
//                   them, in the step that enters it.
//       kPtx        min.NaN/max.NaN, else compare-select.
//       kWhile      while-while order: BOX steps until the ray enters a
//                   leaf, then its triangles (32 B rows, loads after the
//                   branch); else one loop.
//       kNext       row cur + 1 prefetched into L1 with each BOX row.
//       kLoadsFirst every lane loads its step's row before the step
//                   branches on the row's kind; else each branch loads its
//                   own.
//       kPair       a BOX step loads row cur + 1 with row cur and, where
//                   the ray enters cur and cur is interior, tests it in the
//                   same step.
//       kMinBlocks  blocks of 128 threads per SM that __launch_bounds__
//                   asks for (0: none, registers left to ptxas).
//   The template at rope_walk's settings: closest hit
//   variant_rope_kernel<false, false, true, true, false, false, true, true,
//   kMinBlocks> ("baseline"), occlusion variant_rope_kernel<true, false,
//   true, true, false, false, false, false, kMinBlocks> ("branch_first").

#include "../ray_tracer_tpu_torch/csrc/lanewalk.cu"

namespace {

template <bool kAnyhit>
__global__ void __launch_bounds__(kBlock)
    old_lanewalk_kernel(const float4* __restrict__ streams, int r_pad,
                        const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ tmax0,
                        const int* __restrict__ octant,
                        float* __restrict__ dst_out,
                        int* __restrict__ prim_out, int n, int max_steps,
                        int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origin[3 * i], oy = origin[3 * i + 1],
              oz = origin[3 * i + 2];
  float dx = direction[3 * i], dy = direction[3 * i + 1],
        dz = direction[3 * i + 2];
  dx = dx == 0.0f ? 1e-20f : dx;
  dy = dy == 0.0f ? 1e-20f : dy;
  dz = dz == 0.0f ? 1e-20f : dz;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best = tmax0[i];
  int prim = -1;
  int cur = best > -kBig * 0.5f ? 0 : kDead;
  const float4* base =
      streams + static_cast<int64_t>(octant[i]) * r_pad * 4;
  for (int step = 0; cur < kDead; ++step) {
    if (step >= max_steps || cur < 0 || cur >= r_pad) {
      atomicOr(err, 1);
      break;
    }
    const float4* r = base + static_cast<int64_t>(cur) * 4;
    const float4 a = __ldg(r);
    const float4 b = __ldg(r + 1);
    const float4 c = __ldg(r + 2);
    const float4 e = __ldg(r + 3);
    if (e.w > 0.5f) {
      const float rx = ox - a.x, ry = oy - a.y, rz = oz - a.z;
      const float qx = ry * dz - rz * dy;
      const float qy = rz * dx - rx * dz;
      const float qz = rx * dy - ry * dx;
      const float d0 = -(dx * c.y + dy * c.z + dz * c.w);
      const float dinv = 1.0f / d0;
      const float t = (rx * c.y + ry * c.z + rz * c.w) * dinv;
      const float u = (b.z * qx + b.w * qy + c.x * qz) * dinv;
      const float v = -(a.w * qx + b.x * qy + b.y * qz) * dinv;
      const float w = 1.0f - u - v;
      const bool front = d0 >= 1e-8f;
      const bool ok = t >= 0.0f && u >= 0.0f && v >= 0.0f && w >= 0.0f &&
                      !(!front && e.y > 0.5f);
      if (ok && t < best) {
        if (kAnyhit) {
          best = -kBig;
          break;
        }
        best = t;
        prim = static_cast<int>(e.z);
      }
      cur = static_cast<int>(e.x);
    } else {
      const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
      const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
      const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
      const float t_near =
          max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                  min_nan(t1z, t2z));
      const float t_far =
          min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                  max_nan(t1z, t2z));
      const bool hit = t_far >= t_near && t_far > 0.0f &&
                       max_nan(t_near, 0.0f) < best;
      cur = static_cast<int>(hit ? b.z : b.w);
    }
  }
  dst_out[i] = best;
  prim_out[i] = prim;
}

template <bool kPtx>
__device__ __forceinline__ float vmin(float a, float b) {
  return kPtx ? min_ptx(a, b) : min_nan(a, b);
}

template <bool kPtx>
__device__ __forceinline__ float vmax(float a, float b) {
  return kPtx ? max_ptx(a, b) : max_nan(a, b);
}

template <bool kPtx>
__device__ __forceinline__ bool vbox_enter(const float4& a, const float4& b,
                                           const RopeRay& y, float best) {
  const float t1x = (a.x - y.ox) * y.ix, t2x = (a.w - y.ox) * y.ix;
  const float t1y = (a.y - y.oy) * y.iy, t2y = (b.x - y.oy) * y.iy;
  const float t1z = (a.z - y.oz) * y.iz, t2z = (b.y - y.oz) * y.iz;
  const float t_near = vmax<kPtx>(
      vmax<kPtx>(vmin<kPtx>(t1x, t2x), vmin<kPtx>(t1y, t2y)),
      vmin<kPtx>(t1z, t2z));
  const float t_far = vmin<kPtx>(
      vmin<kPtx>(vmax<kPtx>(t1x, t2x), vmax<kPtx>(t1y, t2y)),
      vmax<kPtx>(t1z, t2z));
  return t_far >= t_near && t_far > 0.0f &&
         vmax<kPtx>(t_near, 0.0f) < best;
}

// The row of a triangle: a tri_packed row, or (kRows64) a TRI row of the
// stream; its front_only flag and global id.
template <bool kRows64>
__device__ __forceinline__ const float4* tri_row(const RopeArgs& a,
                                                 const float4* base,
                                                 uint32_t tri) {
  return kRows64 ? base + static_cast<int64_t>(tri) * 4
                 : a.tris + static_cast<int64_t>(tri) * 4;
}

// Tests the triangle whose row r holds (q0, q1, q2, q3): true where the
// ray accepts it within best, and its t and id.
template <bool kRows64>
__device__ __forceinline__ bool tri_step(const float4& q0, const float4& q1,
                                         const float4& q2, const float4& q3,
                                         uint32_t tri, const RopeRay& y,
                                         float best, float& t, int& id) {
  id = kRows64 ? static_cast<int>(q3.z) : static_cast<int>(tri);
  return tri_accept(q0, q1, q2, kRows64 ? q3.y : q3.x, y, t) && t < best;
}

template <bool kAnyhit, bool kRows64, bool kTriStep, bool kPtx, bool kWhile,
          bool kNext, bool kLoadsFirst, bool kPair>
__device__ __forceinline__ void variant_rope(const RopeArgs& a, const int i) {
  RopeRay y;
  y.ox = a.origin[3 * i];
  y.oy = a.origin[3 * i + 1];
  y.oz = a.origin[3 * i + 2];
  const float dx = a.direction[3 * i], dy = a.direction[3 * i + 1],
              dz = a.direction[3 * i + 2];
  y.dx = dx == 0.0f ? 1e-20f : dx;
  y.dy = dy == 0.0f ? 1e-20f : dy;
  y.dz = dz == 0.0f ? 1e-20f : dz;
  y.ix = 1.0f / y.dx;
  y.iy = 1.0f / y.dy;
  y.iz = 1.0f / y.dz;

  constexpr int kRow = kRows64 ? 4 : 2;  // float4s per BOX row
  float best = a.tmax0[i];
  int prim = -1;
  int cur = best > -kBig * 0.5f ? 0 : kDead;
  const float4* base =
      a.streams + static_cast<int64_t>(a.octant[i]) * a.n_rows * kRow;
  uint32_t tri = 0u, tri_end = 0u;  // the entered leaf's triangles left
  int steps = 0;
  if (kWhile) {
    for (;;) {
      // BOX steps until the ray enters a leaf, or its walk ends
      bool fault = false;
      while (cur < kDead) {
        if (++steps > a.max_steps || cur < 0 || cur >= a.n_rows) {
          atomicOr(a.err, 1);
          fault = true;
          break;
        }
        const float4 q0 = __ldg(base + 2 * cur);
        const float4 q1 = __ldg(base + 2 * cur + 1);
        const bool enter = vbox_enter<kPtx>(q0, q1, y, best);
        const uint32_t leaf = __float_as_uint(q1.w);
        if (enter && leaf == 0u) {
          ++cur;
          continue;
        }
        cur = static_cast<int>(q1.z);
        if (enter) {
          tri = leaf & 0xFFFFFFu;
          tri_end = tri + (leaf >> 24);
          fault = tri_end > static_cast<uint32_t>(a.n_tris);
          if (fault) atomicOr(a.err, 1);
          break;
        }
      }
      if (fault || tri >= tri_end) break;
      bool occluded = false;
      for (; tri < tri_end; ++tri) {
        const float4* r = a.tris + static_cast<int64_t>(tri) * 4;
        float t;
        int id;
        if (tri_step<false>(__ldg(r), __ldg(r + 1), __ldg(r + 2),
                            __ldg(r + 3), tri, y, best, t, id)) {
          if (kAnyhit) {
            occluded = true;
            break;
          }
          best = t;
          prim = id;
        }
      }
      if (occluded) {
        best = -kBig;
        break;
      }
    }
    a.dst[i] = best;
    a.prim[i] = prim;
    return;
  }
  for (;;) {
    const bool in_leaf = tri < tri_end;
    if (!in_leaf) {
      if (cur >= kDead) break;
      if (++steps > a.max_steps || cur < 0 || cur >= a.n_rows) {
        atomicOr(a.err, 1);
        break;
      }
      if (kNext && cur + 1 < a.n_rows) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(base + kRow * (cur + 1)));
      }
    }
    const float4* r =
        in_leaf ? tri_row<kRows64>(a, base, tri) : base + kRow * cur;
    float4 q0, q1, q2, q3;
    if (kLoadsFirst) {
      // the step's row, loaded alike whatever its kind (a 32 B BOX row's
      // second pair of loads reads it again, or with kPair the next row)
      const float4* r2 =
          (in_leaf || kRows64 || (kPair && cur + 1 < a.n_rows)) ? r + 2 : r;
      q0 = __ldg(r);
      q1 = __ldg(r + 1);
      q2 = __ldg(r2);
      q3 = __ldg(r2 + 1);
    }
    if (in_leaf) {
      if (!kLoadsFirst) {
        q0 = __ldg(r);
        q1 = __ldg(r + 1);
        q2 = __ldg(r + 2);
        q3 = __ldg(r + 3);
      }
      float t;
      int id;
      if (tri_step<kRows64>(q0, q1, q2, q3, tri, y, best, t, id)) {
        if (kAnyhit) {
          best = -kBig;
          break;
        }
        best = t;
        prim = id;
      }
      ++tri;
      continue;
    }
    if (!kLoadsFirst) {
      q0 = __ldg(r);
      q1 = __ldg(r + 1);
      if (kRows64) {
        q2 = __ldg(r + 2);
      } else if (kPair && cur + 1 < a.n_rows) {
        q2 = __ldg(r + 2);
        q3 = __ldg(r + 3);
      }
    }
    const bool enter = vbox_enter<kPtx>(q0, q1, y, best);
    uint32_t first, count;
    int miss;
    if (kRows64) {
      miss = static_cast<int>(q1.w);
      count = static_cast<uint32_t>(q2.x);
      first = cur + 1;  // its TRI rows follow it
    } else {
      miss = static_cast<int>(q1.z);
      const uint32_t leaf = __float_as_uint(q1.w);
      count = leaf >> 24;
      first = leaf & 0xFFFFFFu;
    }
    if (enter && count == 0u) {
      ++cur;
      if (kPair && !kRows64 && cur < a.n_rows) {
        // the first child's row, loaded with its parent's: its step now
        if (++steps > a.max_steps) {
          atomicOr(a.err, 1);
          break;
        }
        const bool enter2 = vbox_enter<kPtx>(q2, q3, y, best);
        const uint32_t leaf2 = __float_as_uint(q3.w);
        if (enter2 && leaf2 == 0u) {
          ++cur;
          continue;
        }
        cur = static_cast<int>(q3.z);
        if (!enter2) continue;
        first = leaf2 & 0xFFFFFFu;
        count = leaf2 >> 24;
        if (first + count > static_cast<uint32_t>(a.n_tris)) {
          atomicOr(a.err, 1);
          break;
        }
        tri = first;
        tri_end = first + count;
      }
      continue;
    }
    cur = miss;
    if (!enter) continue;
    if (!kRows64 && first + count > static_cast<uint32_t>(a.n_tris)) {
      atomicOr(a.err, 1);
      break;
    }
    tri = first;
    tri_end = first + count;
    if (!kTriStep) {
      // the whole leaf in this step
      bool occluded = false;
      for (; tri < tri_end; ++tri) {
        const float4* rt = tri_row<kRows64>(a, base, tri);
        float t;
        int id;
        if (tri_step<kRows64>(__ldg(rt), __ldg(rt + 1), __ldg(rt + 2),
                              __ldg(rt + 3), tri, y, best, t, id)) {
          if (kAnyhit) {
            occluded = true;
            break;
          }
          best = t;
          prim = id;
        }
      }
      if (occluded) {
        best = -kBig;
        break;
      }
    }
  }
  a.dst[i] = best;
  a.prim[i] = prim;
}

template <bool kA, bool kR, bool kT, bool kP, bool kW, bool kN, bool kL,
          bool k2, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    variant_rope_kernel(const RopeArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n) variant_rope<kA, kR, kT, kP, kW, kN, kL, k2>(a, i);
}

template <bool kA, bool kR, bool kT, bool kP, bool kW, bool kN, bool kL,
          bool k2>
__global__ void __launch_bounds__(kBlock) free_rope_kernel(const RopeArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n) variant_rope<kA, kR, kT, kP, kW, kN, kL, k2>(a, i);
}

template <bool kA>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    copy_rope_kernel(const RopeArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n) rope_walk<kA>(a, i);
}

using RopeFn = void (*)(RopeArgs);

template <bool kA, bool kR, bool kT, bool kP, bool kW, bool kN, bool kL,
          bool k2, int kB>
RopeFn pick() {
  if constexpr (kB == 0) {
    return free_rope_kernel<kA, kR, kT, kP, kW, kN, kL, k2>;
  } else {
    return variant_rope_kernel<kA, kR, kT, kP, kW, kN, kL, k2, kB>;
  }
}

// tools/rope_walk_variants.py VARIANTS[1:], in this order: the baseline
// <rows64 F, tri step T, ptx T, while F, next F, loads first T, pair T,
// kMinBlocks>; one_row, fminf_select, the pins and branch_pair switch one
// element of it; rows64, leaf_in_one_step, while_while, prefetch_next and
// branch_first one element of one_row
template <bool kA>
RopeFn variant(int v) {
  constexpr int kS = kMinBlocks;
  constexpr bool F = false, T = true;
  switch (v) {
    case 1: return copy_rope_kernel<kA>;
    case 2: return pick<kA, F, T, T, F, F, T, T, kS>();   // baseline
    case 3: return pick<kA, F, T, T, F, F, T, F, kS>();   // one_row
    case 4: return pick<kA, T, T, T, F, F, T, F, kS>();   // rows64
    case 5: return pick<kA, F, F, T, F, F, T, F, kS>();   // leaf_in_one_step
    case 6: return pick<kA, F, T, F, F, F, T, T, kS>();   // fminf_select
    case 7: return pick<kA, F, T, T, T, F, T, F, kS>();   // while_while
    case 8: return pick<kA, F, T, T, F, T, T, F, kS>();   // prefetch_next
    case 9: return pick<kA, F, T, T, F, F, F, F, kS>();   // branch_first
    case 10: return pick<kA, F, T, T, F, F, T, T, 0>();   // regs_free
    case 11: return pick<kA, F, T, T, F, F, T, T, 8>();   // regs64
    case 12: return pick<kA, F, T, T, F, F, T, T, 10>();  // regs48
    case 13: return pick<kA, F, T, T, F, F, T, T, 12>();  // regs40
    case 14: return pick<kA, F, F, F, T, F, F, F, 0>();   // none
    case 15: return pick<kA, F, T, T, F, F, F, T, kS>();  // branch_pair
    default: return nullptr;
  }
}

}  // namespace

// One launch of variant v (0 old, 1.. VARIANTS[1:]) with rt_rope_walk's
// arguments; "old" and "rows64" walk the old streams (8, n_rows, 16), the
// others the BOX-row streams.  Returns the launch's CUDA error.
extern "C" int rt_rope_variant(int v, int anyhit, const void* streams,
                               int n_rows, const void* tri_packed, int n_tris,
                               const void* origin, const void* direction,
                               const void* tmax0, const void* octant,
                               void* dst, void* prim, int n, int max_steps,
                               void* err, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == 0) {
    const auto kernel =
        anyhit ? old_lanewalk_kernel<true> : old_lanewalk_kernel<false>;
    kernel<<<grid, block, 0, s>>>(
        static_cast<const float4*>(streams), n_rows,
        static_cast<const float*>(origin),
        static_cast<const float*>(direction),
        static_cast<const float*>(tmax0), static_cast<const int*>(octant),
        static_cast<float*>(dst), static_cast<int*>(prim), n, max_steps,
        static_cast<int*>(err));
    return static_cast<int>(cudaGetLastError());
  }
  const RopeFn kernel = anyhit ? variant<true>(v) : variant<false>(v);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  kernel<<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
