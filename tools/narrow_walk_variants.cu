// Variants of bvh2_walk_kernel (ray_tracer_tpu_torch/csrc/bvh2_walk.cu),
// the narrow walk, and the design it replaced: built and launched by
// tools/narrow_walk_variants.py (for chip_smoke.py, tools/
// measure_narrow_walk.py and the GPU tests); not part of the package's
// library.  Every variant computes exactly what bvh2_walk_kernel computes:
// the same visits in the same order, so the same five outputs (the callers
// hold them together with torch.equal).
//
// old_bvh2_kernel is the narrow walk until its redesign: the stack holds
// node ids, so a pop reloads the node's row to learn first and count, an
// interior visit then loads the children's rows and then the node's axis
// (three dependent rounds), both entered children are pushed and the near
// one popped at once, and min/max are compare-selects.
//
// variant_bvh2_kernel<kPtx, kWord, kNearReg, kWhile, kMinBlocks> is
// bvh2_walk_kernel with each design element switchable:
//   kPtx        false: min_nan/max_nan (compare, compare, or, fminf,
//               select) in place of PTX min.NaN/max.NaN
//   kWord       0: the stack holds node ids and a pop reloads the node's
//               first, count and axis (one round, then the children's);
//               1: the packed 32-bit node word (shipped); 2: the same
//               fields as two 32-bit words (first, tag)
//   kNearReg    false: push both entered children (far, then near) and pop
//               the near one, instead of keeping it in a register
//   kWhile      false: one loop whose every turn is a leaf or an interior
//               visit, in place of the while-while order (shipped: each
//               lane descends until it holds a leaf, then tests leaves
//               until it pops an interior node; a warp's lanes wait at each
//               inner loop's end for the others).  Each ray makes the same
//               visits in the same order either way.
//   kMinBlocks  __launch_bounds__ blocks per SM, which caps the registers
//               at 65536 / (128 kMinBlocks), rounded down to a multiple of 8
// variant_bvh2_kernel<true, 1, true, true, kMinBlocks> is bvh2_walk_kernel
// as it ships.

#include <type_traits>

#include "../ray_tracer_tpu_torch/csrc/bvh2_walk.cu"

namespace {

struct NarrowArgs {
  const float4* nodes;
  const int* axis;
  const float4* tris;
  const float* origin;
  const float* direction;
  const float* tmax0;
  int root;
  uint32_t root_word;
  float* dst;
  int* prim;
  float* u;
  float* v;
  bool* front;
  int n;
};

// entry() with compare-select min/max
__device__ __forceinline__ float entry_select(const float4 a, const float4 b,
                                              const Ray& y) {
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

template <bool kPtx>
__device__ __forceinline__ float entry_of(const float4 a, const float4 b,
                                          const Ray& y) {
  return kPtx ? entry(a, b, y) : entry_select(a, b, y);
}

__global__ void __launch_bounds__(kBlock) old_bvh2_kernel(const NarrowArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  int stack[kStack];
  int sp = 0;
  const float4* nodes = a.nodes;
  auto node_entry = [&](int c) {
    return entry_select(__ldg(nodes + 2 * c), __ldg(nodes + 2 * c + 1), y);
  };
  if (node_entry(a.root) < best) stack[sp++] = a.root;
  while (sp > 0) {
    const int node = stack[--sp];
    const float4 b = __ldg(nodes + 2 * node + 1);
    const int first = __float_as_int(b.z);
    const int count = __float_as_int(b.w);
    if (count > 0) {
      test_leaf(a.tris, first, count, y, best, prim, bu, bv, bfront);
      continue;
    }
    const float e0 = node_entry(first);
    const float e1 = node_entry(first + 1);
    const int ax = __ldg(a.axis + node);
    const float dax = ax == 0 ? y.dx : (ax == 1 ? y.dy : y.dz);
    const bool neg = dax < 0.0f;
    const float e_near = neg ? e1 : e0;
    const float e_far = neg ? e0 : e1;
    if (sp + 2 > kStack) __trap();
    if (e_far < best) stack[sp++] = neg ? first : first + 1;
    if (e_near < best) stack[sp++] = neg ? first + 1 : first;
  }
  a.dst[i] = best;
  a.prim[i] = prim;
  a.u[i] = bu;
  a.v[i] = bv;
  a.front[i] = bfront;
}

template <bool kPtx, int kWord, bool kNearReg, bool kWhile, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    variant_bvh2_kernel(const NarrowArgs a) {
  // a stack entry: a node id (kWord 0), a packed word (1), (first, tag) (2)
  using Slot = typename std::conditional<kWord == 2, uint2, uint32_t>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  bool bfront = false;
  Slot stack[kStack];
  int sp = 0;
  Slot cur;
  if constexpr (kWord == 0) {
    cur = a.root;
  } else if constexpr (kWord == 1) {
    cur = a.root_word;
  } else {
    cur = make_uint2(a.root_word >> kTagBits,
                     a.root_word & ((1u << kTagBits) - 1u));
  }
  bool live = entry_of<kPtx>(__ldg(a.nodes + 2 * a.root),
                             __ldg(a.nodes + 2 * a.root + 1), y) < best;
  int first = 0;
  uint32_t tag = 0;
  auto decode = [&]() {  // what a visit of cur needs
    if constexpr (kWord == 0) {
      const float4 b = __ldg(a.nodes + 2 * cur + 1);
      const int ax = __ldg(a.axis + cur);
      const int count = __float_as_int(b.w);
      first = __float_as_int(b.z);
      tag = count > 0 ? static_cast<uint32_t>(count) : kInterior + ax;
    } else if constexpr (kWord == 1) {
      first = static_cast<int>(cur >> kTagBits);
      tag = cur & ((1u << kTagBits) - 1u);
    } else {
      first = static_cast<int>(cur.x);
      tag = cur.y;
    }
  };
  auto pop = [&]() {
    live = sp > 0;
    if (live) cur = stack[--sp];
  };
  auto push = [&](Slot s) {
    if (sp >= kStack) __trap();
    stack[sp++] = s;
  };
  // one interior visit of cur (decoded): enter the children
  auto interior = [&]() {
    const float4* r = a.nodes + 2 * first;
    const float4 a0 = __ldg(r), b0 = __ldg(r + 1);
    const float4 a1 = __ldg(r + 2), b1 = __ldg(r + 3);
    Slot w0, w1;
    if constexpr (kWord == 0) {
      w0 = first;
      w1 = first + 1;
    } else {
      const int ax0 = __ldg(a.axis + first), ax1 = __ldg(a.axis + first + 1);
      const uint32_t p0 = node_word(b0, ax0), p1 = node_word(b1, ax1);
      if constexpr (kWord == 1) {
        w0 = p0;
        w1 = p1;
      } else {
        const uint32_t m = (1u << kTagBits) - 1u;
        w0 = make_uint2(p0 >> kTagBits, p0 & m);
        w1 = make_uint2(p1 >> kTagBits, p1 & m);
      }
    }
    const float e0 = entry_of<kPtx>(a0, b0, y);
    const float e1 = entry_of<kPtx>(a1, b1, y);
    const int ax = static_cast<int>(tag - kInterior);
    const float dax = ax == 0 ? y.dx : (ax == 1 ? y.dy : y.dz);
    const bool neg = dax < 0.0f;
    const bool in_near = (neg ? e1 : e0) < best;
    const bool in_far = (neg ? e0 : e1) < best;
    if (kNearReg) {
      if (in_near) {
        if (in_far) push(neg ? w0 : w1);
        cur = neg ? w1 : w0;
      } else if (in_far) {
        cur = neg ? w0 : w1;
      } else {
        pop();
      }
    } else {
      if (in_far) push(neg ? w0 : w1);
      if (in_near) push(neg ? w1 : w0);
      pop();
    }
  };
  if (kWhile) {
    if (live) decode();
    while (live) {
      while (live && tag >= kInterior) {  // until this lane holds a leaf
        interior();
        if (live) decode();
      }
      while (live && tag < kInterior) {  // until it pops an interior node
        test_leaf(a.tris, first, static_cast<int>(tag), y, best, prim, bu,
                  bv, bfront);
        pop();
        if (live) decode();
      }
    }
  } else {
    while (live) {
      decode();
      if (tag < kInterior) {
        test_leaf(a.tris, first, static_cast<int>(tag), y, best, prim, bu,
                  bv, bfront);
        pop();
      } else {
        interior();
      }
    }
  }
  a.dst[i] = best;
  a.prim[i] = prim;
  a.u[i] = bu;
  a.v[i] = bv;
  a.front[i] = bfront;
}

using NarrowFn = void (*)(NarrowArgs);

// tools/narrow_walk_variants.py VARIANTS, in this order
NarrowFn variant(int v) {
  constexpr int kB = kMinBlocks;  // the shipped pin
  switch (v) {
    case 0: return variant_bvh2_kernel<true, 1, true, true, kB>;
    case 1: return variant_bvh2_kernel<true, 1, true, false, kB>;
    case 2: return variant_bvh2_kernel<true, 0, true, true, kB>;
    case 3: return variant_bvh2_kernel<true, 2, true, true, kB>;
    case 4: return variant_bvh2_kernel<true, 1, false, true, kB>;
    case 5: return variant_bvh2_kernel<false, 1, true, true, kB>;
    case 6: return variant_bvh2_kernel<false, 0, false, false, kB>;
    case 7: return variant_bvh2_kernel<true, 1, true, true, 1>;
    case 8: return variant_bvh2_kernel<true, 1, true, true, 6>;
    case 9: return variant_bvh2_kernel<true, 1, true, true, 8>;
    case 10: return variant_bvh2_kernel<true, 1, true, true, 9>;
    case 11: return variant_bvh2_kernel<true, 1, true, true, 10>;
    case 12: return variant_bvh2_kernel<true, 1, true, true, 12>;
    case 13: return old_bvh2_kernel;
    default: return nullptr;
  }
}

}  // namespace

// One launch of variant v with rt_bvh2_walk's arguments.  Returns the
// launch's CUDA error.
extern "C" int rt_narrow_variant(int v, const void* nodes, const void* axis,
                                 const void* tris, const void* origin,
                                 const void* direction, const void* tmax0,
                                 int root, unsigned root_word, void* dst,
                                 void* prim, void* u, void* v_out,
                                 void* front, int n, void* stream) {
  const NarrowFn kernel = variant(v);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const NarrowArgs a{
      static_cast<const float4*>(nodes), static_cast<const int*>(axis),
      static_cast<const float4*>(tris), static_cast<const float*>(origin),
      static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), root, root_word,
      static_cast<float*>(dst), static_cast<int*>(prim),
      static_cast<float*>(u), static_cast<float*>(v_out),
      static_cast<bool*>(front), n};
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
