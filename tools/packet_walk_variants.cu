// The packet walk from the root before its redesign, and the walk that
// replaced it at other register pins: built and launched by
// tools/packet_walk_variants.py (for chip_smoke.py, tools/
// measure_packet_walk.py and the GPU tests); not part of the package's
// library.  Every variant computes exactly what group_walk_kernel
// (ray_tracer_tpu_torch/csrc/bvh8_walk.cu) computes for the same rows:
// the same visits in the same order (the callers hold them together with
// torch.equal).
//
//   old        walk_kernel<kClosest | kAnyhit, kRows, kRoot>
//              (tools/old_bvh8_walk.cuh), the loop of
//              the packet walk from the root until group_walk_kernel took
//              it over: compare-select min/max, every record of a leaf
//              slot tested, the whole stack in a local array, registers
//              left to ptxas.
//   regs<R>    group_walk_kernel with __launch_bounds__(128, B), B blocks
//              per SM, which caps the registers at R = 65536 / (128 B)
//              rounded down to a multiple of 8; regs_free leaves them to
//              ptxas.
//   while_while  group_walk_kernel's walk in the while-while order that
//              the narrow walk ships (csrc/bvh2_walk.cu).

#include "old_bvh8_walk.cuh"  // and csrc/bvh8_walk.cu

namespace {

template <bool kAnyhit, int kRows, int kMinBlocks>
__global__ void __launch_bounds__(kGroupBlock, kMinBlocks)
    pinned_walk_kernel(const GroupArgs a) {
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t below[kStack - 1];
  walk_from<kAnyhit, kRows, true>(0.0f, a.nodes, a.leaf_rows, y, best, prim,
                                  below, [](float&) { return false; });
  a.dst[i] = best;
  a.prim[i] = prim;
}

template <bool kAnyhit, int kRows>
__global__ void __launch_bounds__(kGroupBlock)
    free_walk_kernel(const GroupArgs a) {
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t below[kStack - 1];
  walk_from<kAnyhit, kRows, true>(0.0f, a.nodes, a.leaf_rows, y, best, prim,
                                  below, [](float&) { return false; });
  a.dst[i] = best;
  a.prim[i] = prim;
}

// group_walk_kernel's walk (walk_from with the top word in a register) in
// the while-while order: each lane runs interior visits until it pops a
// leaf, then leaf tests until it pops an interior child, so a warp's lanes
// wait at each inner loop's end for the others.  Each ray makes the same
// visits in the same order.
template <bool kAnyhit, int kRows>
__global__ void __launch_bounds__(kGroupBlock, kGroupMinBlocks)
    while_walk_kernel(const GroupArgs a) {
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  const Ray y = load_ray(a.origin, a.direction, i);
  const float* nodes_f = reinterpret_cast<const float*>(a.nodes);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t below[kStack - 1];
  uint32_t top = 0u;
  int held = 0;
  float code = 0.0f;
  bool live = true;
  auto pop = [&]() {  // the next child of the top word, or the walk's end
    live = held > 0;
    if (!live) return;
    const uint32_t w = top;
    const uint32_t mask = w & 0xFFu;
    const int c = __ffs(mask) - 1;
    const int slot = (w & 0x100u) ? 7 - c : c;
    const int node = static_cast<int>(w >> 9);
    const uint32_t rem = mask & (mask - 1u);
    if (rem != 0u) {
      top = w - mask + rem;
    } else if (--held > 0) {
      top = below[held - 1];
    }
    code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
  };
  while (live) {
    while (live && code >= 0.0f) {
      const int node = static_cast<int>(code);
      const float4* r = a.nodes + node * 32;
      uint32_t m8 = 0u;
      float axis_f = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 p = __ldg(r + 2 * c);
        const float4 q = __ldg(r + 2 * c + 1);
        const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
        const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
        const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
        const float tmin = max_ptx(
            max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)), min_ptx(t1z, t2z));
        const float tmx = min_ptx(
            min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)), max_ptx(t1z, t2z));
        if (tmx >= tmin && tmx > 0.0f && tmin < best) m8 |= 1u << c;
        if (c == 0) axis_f = q.w;
      }
      if (m8 != 0u) {
        uint32_t word = m8;
        if (!kAnyhit) {
          const int axis = static_cast<int>(axis_f);
          const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
          if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
        }
        word |= static_cast<uint32_t>(node) << 9;
        if (held > 0) {
          if (held >= kStack) __trap();
          below[held - 1] = top;
        }
        top = word;
        ++held;
      }
      pop();
    }
    while (live && code < 0.0f) {
      const int payload = static_cast<int>(-code) - 1;
      const int leaf_slot = payload >> 4;
      const int cnt = payload & 15;
      const int lim = kRows == 2 && cnt == 15 ? 16 : cnt;
      const float4* r = a.leaf_rows + leaf_slot * 32;
      bool occluded = false;
#pragma unroll
      for (int k = 0; k < 8 * kRows; ++k) {
        if (k >= lim) break;
        const float tk = record_t(r + 4 * k, y);
        if (kAnyhit) {
          if (tk < best) {
            occluded = true;
            break;
          }
        } else if (tk < best) {
          best = tk;
          prim = leaf_slot * 8 + k;
        }
      }
      if (kAnyhit && occluded) {
        best = -kBig;
        live = false;
      } else {
        pop();
      }
    }
  }
  a.dst[i] = best;
  a.prim[i] = prim;
}

using GroupFn = void (*)(GroupArgs);

// tools/packet_walk_variants.py VARIANTS[1:], in this order
template <bool kA, int kR>
GroupFn pinned(int v) {
  switch (v) {
    case 1: return free_walk_kernel<kA, kR>;
    case 2: return pinned_walk_kernel<kA, kR, 7>;   // 72 registers
    case 3: return pinned_walk_kernel<kA, kR, 8>;   // 64
    case 4: return pinned_walk_kernel<kA, kR, 9>;   // 56
    case 5: return pinned_walk_kernel<kA, kR, 10>;  // 48
    case 6: return while_walk_kernel<kA, kR>;
    default: return nullptr;
  }
}

}  // namespace

// One launch of variant v (0 old, 1.. the pins of VARIANTS) with
// rt_bvh8_group's arguments: closest hit (anyhit 0) or occlusion (1) over
// rows-row leaf slots (1 or 2).  Returns the launch's CUDA error.
extern "C" int rt_packet_variant(int v, int anyhit, int rows,
                                 const void* nodes, const void* leaf_rows,
                                 const void* origin, const void* direction,
                                 const void* tmax0, void* dst, void* prim,
                                 int n, void* stream) {
  if (rows != 1 && rows != 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == 0) {
    const WalkArgs a{
        static_cast<const float4*>(nodes),
        static_cast<const float4*>(leaf_rows), nullptr,
        static_cast<const float*>(origin),
        static_cast<const float*>(direction),
        static_cast<const float*>(tmax0), static_cast<float*>(dst),
        static_cast<int*>(prim), nullptr, nullptr, n, 0};
    if (anyhit) {
      by_rows<kAnyhit, kRoot>(rows, a, s);
    } else {
      by_rows<kClosest, kRoot>(rows, a, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const GroupFn kernel =
      anyhit ? (rows == 1 ? pinned<true, 1>(v) : pinned<true, 2>(v))
             : (rows == 1 ? pinned<false, 1>(v) : pinned<false, 2>(v));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const GroupArgs a{
      static_cast<const float4*>(nodes), static_cast<const float4*>(leaf_rows),
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), n};
  const dim3 grid((n + kGroupBlock - 1) / kGroupBlock), block(kGroupBlock);
  kernel<<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
