// The DEEP walk of two-phase treelet traversal before its redesign, and
// variants of deep_walk_kernel (ray_tracer_tpu_torch/csrc/bvh8_walk.cu)
// with each design element switched; built and launched by
// tools/deep_walk_variants.py for tools/measure_deep_walk.py, chip_smoke.py
// and tests/test_torch_gpu.py, not part of the package's library.  Every
// kernel computes what deep_walk_kernel computes: dst and prim bit for bit,
// except that the nearest-first order may change them on a few lanes
// (tools/deep_walk_variants.py::compare_near).
//
// old_deep_kernel<kAnyhit, kRows> is walk_kernel's former DEEP start, the
// design deep_walk_kernel replaced: one untested mask-0 word per entry of
// the lane's packet, pushed in list order (so the last is walked first),
// then the walk, with the whole stack in a local array, compare-select NaN
// min/max, every record of a leaf slot tested and __launch_bounds__(128)
// alone.
//
// variant_deep_kernel<kAnyhit, kFlat, kNear, kCull, kPtx, kCount, kEarly,
// kTopReg, kMinBlocks> is deep_walk_kernel (one-row slots) with each
// element switchable, and two more: each entry's box tested against best
// before it is walked (kCull), and the entries nearest first (kNear).
// Both read the entry-box table (W,8) f32, row w = wide node w's own box,
// its child box in its parent's row: min3|max3, then 1.0 (the root, which
// has no parent: NaN and 0.0; deep_walk_variants.py::entry_boxes).
//   kFlat       false: a walk loop per entry inside a loop over the
//               entries, in place of one loop that takes the next entry
//               when a subtree is done
//   kNear       true: the entries nearest first, by the entry distance
//               into their box (computed for all of them up front; ties,
//               and the root at +inf, by list index), in place of the list
//               order, last first
//   kCull       1: an entry is walked only if the ray enters its box within
//               best (the root always), the box loaded and tested at its
//               turn; 2: the same, with every entry's box loaded and its
//               entry distance found up front (the loads in flight
//               together) and compared with best at its turn.  Exact: a
//               child box lies inside its parent's, and on an axis where
//               o/d is finite t(b) = b * (1/d) - o/d rounds monotonically
//               in b (overflow to inf included, never NaN), so where the
//               entry's box test fails so does each child's; on an axis
//               where o/d is inf or NaN (a subnormal direction past the
//               1e-20 zero guard, or |o| large against a tiny d) every t
//               is NaN or one infinity and no box test passes at all
//               (tests/test_torch_two_phase.py, at 1e-40)
//   kPtx        false: min_nan/max_nan (compare, compare, or, fminf,
//               select) in place of PTX min.NaN/max.NaN
//   kCount      false: all 8 records of a leaf slot tested, not its count
//   kEarly      false: lanes with tmax0 <= 0 walk like the others
//   kTopReg     true: the top stack word in a register, as
//               group_walk_kernel keeps it
//   kMinBlocks  __launch_bounds__ blocks per SM, which caps the registers
//               at 65536 / (128 kMinBlocks), rounded down to a multiple of 8
//               (1: no cap below the 255 of a thread)
// variant_deep_kernel<kAnyhit, true, false, 0, true, true, true, false, 8>
// is deep_walk_kernel<kAnyhit, 1> as it ships.

#include "old_bvh8_walk.cuh"  // and csrc/bvh8_walk.cu

namespace {

template <bool kAnyhit, int kRows>
__global__ void __launch_bounds__(kBlock)
    old_deep_kernel(const DeepArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int* entries = a.entries + (i / a.packet_size) * a.deep_e;
  const Ray y = load_ray(a.origin, a.direction, i);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t stack[kStack];  // deep_e + the tree's depth (host-checked)
  int sp = 0;
  for (int e = 0; e < a.deep_e; ++e) {
    const int entry = __ldg(entries + e);
    if (entry >= 0) stack[sp++] = static_cast<uint32_t>(entry) << 9;
  }
  const float* nodes_f = reinterpret_cast<const float*>(a.nodes);
  while (sp > 0) {
    const uint32_t w = stack[sp - 1];
    const uint32_t mask = w & 0xFFu;
    const int node = static_cast<int>(w >> 9);
    int target = node;
    int leaf_slot = -1;
    if (mask == 0u) {
      --sp;
    } else {
      const int c = __ffs(mask) - 1;
      const int slot = (w & 0x100u) ? 7 - c : c;
      const uint32_t rem = mask & (mask - 1u);
      if (rem == 0u) {
        --sp;
      } else {
        stack[sp - 1] = w - mask + rem;
      }
      const float code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
      if (code >= 0.0f) {
        target = static_cast<int>(code);
      } else {
        leaf_slot = (static_cast<int>(-code) - 1) >> 4;
      }
    }
    if (leaf_slot >= 0) {
      const float4* r = a.leaf_rows + leaf_slot * 32;
      bool occluded = false;
#pragma unroll
      for (int k = 0; k < 8 * kRows; ++k) {
        const float tk = record_t(r + 4 * k, y);
        if (kAnyhit) {
          occluded = occluded || tk < best;
        } else if (tk < best) {
          best = tk;
          prim = leaf_slot * 8 + k;
        }
      }
      if (kAnyhit && occluded) {
        best = -kBig;
        break;
      }
      continue;
    }
    const float4* r = a.nodes + target * 32;
    uint32_t m8 = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 p = __ldg(r + 2 * c);
      const float4 q = __ldg(r + 2 * c + 1);
      const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
      const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
      const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
      const float tmin = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                                 min_nan(t1z, t2z));
      const float tmx = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                                max_nan(t1z, t2z));
      if (tmx >= tmin && tmx > 0.0f && tmin < best) m8 |= 1u << c;
    }
    if (m8 == 0u) continue;
    uint32_t word = m8;
    if (!kAnyhit) {
      const int axis = static_cast<int>(__ldg(nodes_f + target * 128 + 7));
      const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
      if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
    }
    if (sp >= kStack) __trap();
    stack[sp++] = (static_cast<uint32_t>(target) << 9) | word;
  }
  a.dst[i] = best;
  a.prim[i] = prim;
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
__device__ __forceinline__ float vbox_entry(const float4 p, const float4 q,
                                            const Ray& y) {
  const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
  const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
  const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
  const float tmin = vmax<kPtx>(
      vmax<kPtx>(vmin<kPtx>(t1x, t2x), vmin<kPtx>(t1y, t2y)),
      vmin<kPtx>(t1z, t2z));
  const float tmx = vmin<kPtx>(
      vmin<kPtx>(vmax<kPtx>(t1x, t2x), vmax<kPtx>(t1y, t2y)),
      vmax<kPtx>(t1z, t2z));
  return tmx >= tmin && tmx > 0.0f ? tmin : __int_as_float(0x7f800000);
}

// walk_from (one-row slots) with kPtx, kCount and kTopReg switchable;
// stack: kStack words
template <bool kAnyhit, bool kPtx, bool kCount, bool kTopReg, class Next>
__device__ __forceinline__ void vwalk_from(float code, const DeepArgs& a,
                                           const Ray& y, float& best,
                                           int& prim, uint32_t* stack,
                                           Next next) {
  const float* nodes_f = reinterpret_cast<const float*>(a.nodes);
  uint32_t top = 0u;
  int held = 0;
  for (;;) {
    if (code >= 0.0f) {
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
        const float tmin = vmax<kPtx>(
            vmax<kPtx>(vmin<kPtx>(t1x, t2x), vmin<kPtx>(t1y, t2y)),
            vmin<kPtx>(t1z, t2z));
        const float tmx = vmin<kPtx>(
            vmin<kPtx>(vmax<kPtx>(t1x, t2x), vmax<kPtx>(t1y, t2y)),
            vmax<kPtx>(t1z, t2z));
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
        if (held >= kStack) __trap();
        if (kTopReg) {
          if (held > 0) stack[held - 1] = top;
          top = word;
        } else {
          stack[held] = word;
        }
        ++held;
      }
    } else {
      const int payload = static_cast<int>(-code) - 1;
      const int leaf_slot = payload >> 4;
      const int cnt = kCount ? payload & 15 : 8;
      const float4* r = a.leaf_rows + leaf_slot * 32;
      bool occluded = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= cnt) break;
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
        return;
      }
    }
    if (held == 0) {
      if (!next(code)) return;
      continue;
    }
    const uint32_t w = kTopReg ? top : stack[held - 1];
    const uint32_t mask = w & 0xFFu;
    const int c = __ffs(mask) - 1;
    const int slot = (w & 0x100u) ? 7 - c : c;
    const int node = static_cast<int>(w >> 9);
    const uint32_t rem = mask & (mask - 1u);
    if (rem != 0u) {
      if (kTopReg) {
        top = w - mask + rem;
      } else {
        stack[held - 1] = w - mask + rem;
      }
    } else if (--held > 0 && kTopReg) {
      top = stack[held - 1];
    }
    code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
  }
}

template <bool kAnyhit, bool kFlat, bool kNear, int kCull, bool kPtx,
          bool kCount, bool kEarly, bool kTopReg, int kMinBlocks>
__global__ void __launch_bounds__(kGroupBlock, kMinBlocks)
    variant_deep_kernel(const DeepArgs a,
                        const float4* __restrict__ entry_box) {
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  float best = a.tmax0[i];
  int prim = -1;
  if (!kEarly || best > 0.0f) {
    const Ray y = load_ray(a.origin, a.direction, i);
    const int* entries = a.entries + (i / a.packet_size) * a.deep_e;
    uint32_t stack[kStack];
    // kNear, kCull 2: the entries to visit (bit e: list index e), their
    // entry distances, and those walked whatever their box
    uint32_t left = 0u, always = 0u;
    float key[kNear || kCull == 2 ? kMaxDeepE : 1];
    if (kNear || kCull == 2) {
      for (int e = 0; e < a.deep_e; ++e) {
        const int entry = __ldg(entries + e);
        if (entry < 0) continue;
        const float4 p = __ldg(entry_box + 2 * entry);
        const float4 q = __ldg(entry_box + 2 * entry + 1);
        key[e] = q.z == 0.0f ? __int_as_float(0x7f800000)
                             : vbox_entry<kPtx>(p, q, y);
        if (q.z == 0.0f || !kCull) always |= 1u << e;
        if (q.z == 0.0f || !kCull || key[e] < best) left |= 1u << e;
      }
    }
    int e = a.deep_e;
    auto next = [&](float& code) {
      if (kNear) {
        while (left != 0u) {
          int pick = __ffs(left) - 1;
          float near = key[pick];
          for (uint32_t m = left & (left - 1u); m != 0u; m &= m - 1u) {
            const int j = __ffs(m) - 1;
            if (key[j] < near) {
              pick = j;
              near = key[j];
            }
          }
          left &= ~(1u << pick);
          if (((always >> pick) & 1u) || near < best) {
            code = static_cast<float>(__ldg(entries + pick));
            return true;
          }
        }
        return false;
      }
      while (e > 0) {
        --e;
        if (kCull == 2) {
          if (!((left >> e) & 1u)) continue;
          if (!((always >> e) & 1u) && !(key[e] < best)) continue;
        }
        const int entry = __ldg(entries + e);
        if (entry < 0) continue;
        if (kCull == 1) {
          const float4 p = __ldg(entry_box + 2 * entry);
          const float4 q = __ldg(entry_box + 2 * entry + 1);
          if (q.z != 0.0f && !(vbox_entry<kPtx>(p, q, y) < best)) continue;
        }
        code = static_cast<float>(entry);
        return true;
      }
      return false;
    };
    float code;
    if (kFlat) {
      if (next(code)) {
        vwalk_from<kAnyhit, kPtx, kCount, kTopReg>(code, a, y, best, prim,
                                                    stack, next);
      }
    } else {  // a loop per entry: the warp waits for its slowest lane
      while (best != -kBig && next(code)) {
        vwalk_from<kAnyhit, kPtx, kCount, kTopReg>(
            code, a, y, best, prim, stack, [](float&) { return false; });
      }
    }
  }
  a.dst[i] = best;
  a.prim[i] = prim;
}

template <bool kAnyhit>
int launch_variant(int v, const DeepArgs& a, const float4* box, dim3 grid,
                   cudaStream_t s) {
  constexpr int kB = kDeepMinBlocks;
  constexpr bool k0 = false, k1 = true;
  switch (v) {  // tools/deep_walk_variants.py VARIANTS, in order
    case 0:  // shipped_copy
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k1, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 1:  // loop_per_entry
      variant_deep_kernel<kAnyhit, k0, k0, 0, k1, k1, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 2:  // top_word_in_register
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k1, k1, k1, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 3:  // cull_at_turn
      variant_deep_kernel<kAnyhit, k1, k0, 1, k1, k1, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 4:  // cull_up_front
      variant_deep_kernel<kAnyhit, k1, k0, 2, k1, k1, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 5:  // near_order
      variant_deep_kernel<kAnyhit, k1, k1, 0, k1, k1, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 6:  // fminf_select_minmax
      variant_deep_kernel<kAnyhit, k1, k0, 0, k0, k1, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 7:  // all_records
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k0, k1, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 8:  // no_early_exit
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k1, k0, k0, kB>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 9:  // regs_free
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k1, k1, k0, 1>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 10:  // regs56
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k1, k1, k0, 9>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 11:  // regs72
      variant_deep_kernel<kAnyhit, k1, k0, 0, k1, k1, k1, k0, 7>
          <<<grid, kGroupBlock, 0, s>>>(a, box);
      return 0;
    case 12:  // old: the design deep_walk_kernel replaced
      old_deep_kernel<kAnyhit, 1><<<grid, kBlock, 0, s>>>(a);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch of variant v (tools/deep_walk_variants.py VARIANTS) with
// rt_bvh8_deep's arguments and the entry-box table (read by the cull and
// nearest-first variants; may be null for the others); only "old" takes
// two-row slots (rows 2).
extern "C" int rt_deep_variant(int v, int anyhit, int rows, const void* nodes,
                               const void* leaf_rows, const void* entry_box,
                               const void* entries, const void* origin,
                               const void* direction, const void* tmax0,
                               void* dst, void* prim, int n, int deep_e,
                               int packet_size, void* stream) {
  const DeepArgs a{
      static_cast<const float4*>(nodes), static_cast<const float4*>(leaf_rows),
      static_cast<const int*>(entries), static_cast<const float*>(origin),
      static_cast<const float*>(direction), static_cast<const float*>(tmax0),
      static_cast<float*>(dst), static_cast<int*>(prim), n, deep_e,
      packet_size};
  const float4* box = static_cast<const float4*>(entry_box);
  if (deep_e < 1 || deep_e > kMaxDeepE || packet_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kGroupBlock - 1) / kGroupBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (rows == 2) {
    if (v != 12) return static_cast<int>(cudaErrorInvalidValue);
    if (anyhit) {
      old_deep_kernel<true, 2><<<grid, kBlock, 0, s>>>(a);
    } else {
      old_deep_kernel<false, 2><<<grid, kBlock, 0, s>>>(a);
    }
    err = 0;
  } else if (rows == 1) {
    err = anyhit ? launch_variant<true>(v, a, box, grid, s)
                 : launch_variant<false>(v, a, box, grid, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
