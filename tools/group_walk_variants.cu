// Variants of group_walk_kernel (ray_tracer_tpu_torch/csrc/bvh8_walk.cu),
// built and timed against it by tools/measure_group_walk.py; not part of
// the package's library.  Every variant computes exactly what
// group_walk_kernel computes (the tool holds them together with
// torch.equal); they differ in how.
//
// variant_walk_kernel<kAnyhit, kPtx, kCount, kDirect, kShared, kMinBlocks>
// is group_walk_kernel with each design element switchable:
//   kPtx        false: walk_kernel's min_nan/max_nan (compare, compare, or,
//               fminf, select) in place of PTX min.NaN/max.NaN
//   kCount      false: test all 8 records of a leaf slot, not its count
//   kDirect     true: descend into the nearest entered child with its code
//               from registers and push only the remaining bits, instead of
//               pushing the word and popping it with a reload of the code
//   kShared     true: the words below the top in shared memory, laid out
//               [level][thread] (no bank conflicts), stack_words - 1 of
//               them per thread, stack_words the tree's depth
//   kMinBlocks  __launch_bounds__ blocks per SM, which caps the registers
//               at 65536 / (128 kMinBlocks), rounded down to a multiple of 8
// variant_walk_kernel<kAnyhit, true, true, false, false, 9> is
// group_walk_kernel as it ships.
//
// lanes8_walk_kernel<kAnyhit> is the other design, eight lanes per ray:
// lane c of a ray's 8-lane segment loads child c's 32 B (a node row is one
// coalesced 256 B request) and slab-tests it, __ballot_sync gives the hit
// mask; in a leaf lane k tests record k and a __shfl_xor reduction keeps
// (t, lowest k), which equals the strict-< sequential fold.  Every lane of
// a segment holds the ray's state, so control flow is uniform within the
// segment; its stack is in shared memory as with kShared.

#include "../ray_tracer_tpu_torch/csrc/bvh8_walk.cu"

namespace {

template <bool kPtx>
__device__ __forceinline__ float vmin(float a, float b) {
  return kPtx ? min_ptx(a, b) : min_nan(a, b);
}

template <bool kPtx>
__device__ __forceinline__ float vmax(float a, float b) {
  return kPtx ? max_ptx(a, b) : max_nan(a, b);
}

template <bool kAnyhit, bool kPtx, bool kCount, bool kDirect, bool kShared,
          int kMinBlocks>
__global__ void __launch_bounds__(kGroupBlock, kMinBlocks)
    variant_walk_kernel(const GroupArgs a, int stack_words) {
  extern __shared__ uint32_t shared_stack[];
  const int i = blockIdx.x * kGroupBlock + threadIdx.x;
  if (i >= a.n) return;
  uint32_t local[kShared ? 1 : kStack - 1];
  uint32_t* const below = kShared ? shared_stack + threadIdx.x : local;
  constexpr int kStride = kShared ? kGroupBlock : 1;
  const int cap = kShared ? stack_words : kStack;
  const Ray y = load_ray(a.origin, a.direction, i);
  const float* nodes_f = reinterpret_cast<const float*>(a.nodes);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t top = 0u;
  int held = 0;
  float code = 0.0f;
  auto push = [&](uint32_t word) {
    if (held > 0) {
      if (held >= cap) __trap();
      below[(held - 1) * kStride] = top;
    }
    top = word;
    ++held;
  };

  for (;;) {
    if (code >= 0.0f) {
      const int node = static_cast<int>(code);
      const float4* r = a.nodes + node * 32;
      uint32_t m8 = 0u;
      float cc[8];
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
        cc[c] = q.z;
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
        if (!kDirect) {
          push(word);
        } else {
          const uint32_t mask = word & 0xFFu;
          const int c0 = __ffs(mask) - 1;
          const int slot = (word & 0x100u) ? 7 - c0 : c0;
          const uint32_t rem = mask & (mask - 1u);
          if (rem != 0u) push(word - mask + rem);
          code = cc[0];
#pragma unroll
          for (int c = 1; c < 8; ++c) {
            if (slot == c) code = cc[c];
          }
          continue;
        }
      }
    } else {
      const int payload = static_cast<int>(-code) - 1;
      const int leaf_slot = payload >> 4;
      const int cnt = kCount ? (payload & 15) : 8;
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
        break;
      }
    }
    if (held == 0) break;
    const uint32_t mask = top & 0xFFu;
    const int c = __ffs(mask) - 1;
    const int slot = (top & 0x100u) ? 7 - c : c;
    const int node = static_cast<int>(top >> 9);
    const uint32_t rem = mask & (mask - 1u);
    if (rem != 0u) {
      top = top - mask + rem;
    } else if (--held > 0) {
      top = below[(held - 1) * kStride];
    }
    code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
  }
  a.dst[i] = best;
  a.prim[i] = prim;
}

template <bool kAnyhit>
__global__ void __launch_bounds__(kGroupBlock)
    lanes8_walk_kernel(const GroupArgs a, int stack_words) {
  extern __shared__ uint32_t shared_stack[];
  constexpr int kRays = kGroupBlock / 8;  // rays per block
  const int c = threadIdx.x & 7;          // this lane's child / record
  const int g = threadIdx.x >> 3;         // the ray's segment in the block
  const int i = blockIdx.x * kRays + g;
  if (i >= a.n) return;  // whole segments leave together
  const unsigned seg = 0xFFu << (threadIdx.x & 24);
  uint32_t* const below = shared_stack + g;  // level l: l * kRays
  const Ray y = load_ray(a.origin, a.direction, i);
  const float* nodes_f = reinterpret_cast<const float*>(a.nodes);
  float best = a.tmax0[i];
  int prim = -1;
  uint32_t top = 0u;
  int held = 0;
  float code = 0.0f;
  auto push = [&](uint32_t word) {
    if (held > 0) {
      if (held >= stack_words) __trap();
      below[(held - 1) * kRays] = top;  // the segment's lanes store alike
    }
    top = word;
    ++held;
  };

  for (;;) {
    if (code >= 0.0f) {
      const int node = static_cast<int>(code);
      const float4* r = a.nodes + node * 32 + 2 * c;
      const float4 p = __ldg(r);
      const float4 q = __ldg(r + 1);
      const float t1x = p.x * y.ix - y.oix, t2x = p.w * y.ix - y.oix;
      const float t1y = p.y * y.iy - y.oiy, t2y = q.x * y.iy - y.oiy;
      const float t1z = p.z * y.iz - y.oiz, t2z = q.y * y.iz - y.oiz;
      const float tmin = max_ptx(
          max_ptx(min_ptx(t1x, t2x), min_ptx(t1y, t2y)), min_ptx(t1z, t2z));
      const float tmx = min_ptx(
          min_ptx(max_ptx(t1x, t2x), max_ptx(t1y, t2y)), max_ptx(t1z, t2z));
      const bool hit = tmx >= tmin && tmx > 0.0f && tmin < best;
      const uint32_t m8 =
          (__ballot_sync(seg, hit) >> (threadIdx.x & 24)) & 0xFFu;
      const float axis_f = __shfl_sync(seg, q.w, 0, 8);
      if (m8 != 0u) {
        uint32_t word = m8;
        if (!kAnyhit) {
          const int axis = static_cast<int>(axis_f);
          const float dax = axis == 0 ? y.dx : (axis == 1 ? y.dy : y.dz);
          if (dax < 0.0f) word = (__brev(m8) >> 24) | 0x100u;
        }
        word |= static_cast<uint32_t>(node) << 9;
        const uint32_t mask = word & 0xFFu;
        const int c0 = __ffs(mask) - 1;
        const int slot = (word & 0x100u) ? 7 - c0 : c0;
        const uint32_t rem = mask & (mask - 1u);
        if (rem != 0u) push(word - mask + rem);
        code = __shfl_sync(seg, q.z, slot, 8);
        continue;
      }
    } else {
      const int payload = static_cast<int>(-code) - 1;
      const int leaf_slot = payload >> 4;
      const int cnt = payload & 15;
      float tk = c < cnt ? record_t(a.leaf_rows + leaf_slot * 32 + 4 * c, y)
                         : kBig;
      if (kAnyhit) {
        if (__ballot_sync(seg, tk < best) != 0u) {
          best = -kBig;
          break;
        }
      } else {
        int k = c;
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          const float t2 = __shfl_xor_sync(seg, tk, off, 8);
          const int k2 = __shfl_xor_sync(seg, k, off, 8);
          if (t2 < tk || (t2 == tk && k2 < k)) {
            tk = t2;
            k = k2;
          }
        }
        if (tk < best) {
          best = tk;
          prim = leaf_slot * 8 + k;
        }
      }
    }
    if (held == 0) break;
    const uint32_t mask = top & 0xFFu;
    const int cp = __ffs(mask) - 1;
    const int slot = (top & 0x100u) ? 7 - cp : cp;
    const int node = static_cast<int>(top >> 9);
    const uint32_t rem = mask & (mask - 1u);
    if (rem != 0u) {
      top = top - mask + rem;
    } else if (--held > 0) {
      top = below[(held - 1) * kRays];
    }
    code = __ldg(nodes_f + node * 128 + 8 * slot + 6);
  }
  if (c == 0) {
    a.dst[i] = best;
    a.prim[i] = prim;
  }
}

using VariantFn = void (*)(GroupArgs, int);

// tools/measure_group_walk.py VARIANTS, in this order
template <bool kA>
VariantFn variant(int v) {
  switch (v) {
    case 0: return variant_walk_kernel<kA, true, true, false, false, 9>;
    case 1: return variant_walk_kernel<kA, false, true, false, false, 9>;
    case 2: return variant_walk_kernel<kA, true, false, false, false, 9>;
    case 3: return variant_walk_kernel<kA, true, true, true, false, 9>;
    case 4: return variant_walk_kernel<kA, true, true, false, true, 9>;
    case 5: return variant_walk_kernel<kA, false, false, false, false, 9>;
    case 6: return variant_walk_kernel<kA, true, true, false, false, 1>;
    case 7: return variant_walk_kernel<kA, true, true, false, false, 10>;
    case 8: return variant_walk_kernel<kA, true, true, false, false, 12>;
    case 9: return lanes8_walk_kernel<kA>;
    default: return nullptr;
  }
}

}  // namespace

// One launch of variant v (0..9) with rt_bvh8_group's arguments, and
// stack_words, the tree's depth (1..kStack), which sizes the shared-memory
// stacks.  Returns the launch's CUDA error.
extern "C" int rt_group_variant(int v, int anyhit, const void* nodes,
                                const void* leaf_rows, const void* origin,
                                const void* direction, const void* tmax0,
                                void* dst, void* prim, int n,
                                int stack_words, void* stream) {
  const VariantFn kernel = anyhit ? variant<true>(v) : variant<false>(v);
  if (kernel == nullptr || stack_words < 1 || stack_words > kStack) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GroupArgs a{
      static_cast<const float4*>(nodes), static_cast<const float4*>(leaf_rows),
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(tmax0), static_cast<float*>(dst),
      static_cast<int*>(prim), n};
  const bool lanes8 = v == 9;
  const int rays = lanes8 ? kGroupBlock / 8 : kGroupBlock;  // per block
  const size_t smem = lanes8 || v == 4
      ? static_cast<size_t>(stack_words - 1) * rays * sizeof(uint32_t)
      : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + rays - 1) / rays), block(kGroupBlock);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      a, stack_words);
  return static_cast<int>(cudaGetLastError());
}
