// The shade kernel of the wavefront round before its redesign, and the
// redesigned kernel with each design element switched: built and launched
// by tools/shade_round_variants.py (for chip_smoke.py,
// tools/measure_shade_round.py and the GPU tests); not part of the
// package's library.  Every variant computes exactly what shade_kernel
// (ray_tracer_tpu_torch/csrc/shade_round.cu) computes, bit for bit: the
// same expressions on the same operands, only where the bytes go and which
// lanes evaluate a select's unused side differ.
//
// old_shade_kernel is shade_kernel as it was first written, copied
// verbatim but for its name: one thread per lane, the whole lane computed
// on every lane, its 34-float row held in registers to the end and written
// in place as 17 float2 and 3 int2 stores 136 B and 24 B apart, the counts
// as three __syncthreads_count sums and three atomics per block of 256.
//
// variant_kernel<kStore, kLazy, kMinBlocks, kLoop> is shade_kernel with:
//   kStore      kInPlace: each lane writes its rows in place (float2/int2
//               stores 136 B and 24 B apart, as the old kernel); kVector:
//               staged in shared memory and copied out by the block's
//               threads with 16-byte stores; kBulk: staged and copied out
//               by thread 0's TMA bulk stores (cp.async.bulk), the last 8
//               bytes of a ragged tile by a plain store (shipped)
//   kLazy       false: the sky, the lobes and the camera ray on every lane
//               (the old kernel's order of work); true: only where selected
//               (shipped)
//   kMinBlocks  __launch_bounds__ blocks per SM, which caps the registers
//               at 65536 / (256 kMinBlocks), rounded down to a multiple of 8
//               (shipped: 4, 64 registers)
//   kLoop       true: block b takes tiles b, b + gridDim.x, ... ("persistent":
//               the shipped configuration on a grid of as many blocks as
//               fit on the card at once); false: one block a tile (shipped)

#include "../ray_tracer_tpu_torch/csrc/shade_round.cu"

namespace {

__global__ void __launch_bounds__(kBlock)
    old_shade_kernel(const ShadeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  int c_alive = 0, c_sem = 0, c_act = 0;
  if (i < a.n) {
    const V3 O = ld3(a.origin, i), D = ld3(a.direction, i);
    const float dst = a.dst[i];
    const int kind = a.kind[i], prim = a.prim[i];
    const V3 AT = ld3(a.atten, i), TO = ld3(a.total, i);
    const V3 DI = ld3(a.direct, i), AC = ld3(a.acc, i);
    bool bad = a.bad[i] != 0;
    const bool alive = a.alive[i] != 0;
    const int j = a.j[i], s = a.s[i], sb = a.sb[i], pix = a.pix[i];
    const bool did_hit = kind != 0;
    const bool did = alive && did_hit;

    // ---- shading.shade_fetch, the flattened and sphere branches
    const V3 hp = O + D * dst;
    const bool is_tri = kind == 2;
    const float4* row =
        reinterpret_cast<const float4*>(a.table) + 12ll * (is_tri ? prim : 0);
    const float4 r0 = row[0], r1 = row[1], r2 = row[2];
    const float4 r4 = row[4], r5 = row[5];
    const V3 vn0 = {r0.x, r0.y, r0.z}, vn1 = {r0.w, r1.x, r1.y};
    const V3 vn2 = {r1.z, r1.w, r2.x};
    V3 albedo = {r4.x, r4.y, r4.z}, emission = {r4.w, r5.x, r5.y};
    float refl = r5.z, ior = r5.w;
    float hu, hv;
    bool front;
    if (a.flat) {
      const float4 r8 = row[8], r9 = row[9], r10 = row[10];
      const V3 tv0 = {r8.x, r8.y, r8.z}, te1 = {r8.w, r9.x, r9.y};
      const V3 te2 = {r9.z, r9.w, r10.x}, tn = {r10.y, r10.z, r10.w};
      const V3 d_eps = {D.x == 0.0f ? 1e-20f : D.x, D.y == 0.0f ? 1e-20f : D.y,
                        D.z == 0.0f ? 1e-20f : D.z};
      const V3 q3 = cross(O - tv0, d_eps);
      const float d0 = -dot(d_eps, tn);
      const float dinv = 1.0f / (d0 == 0.0f ? 1e-20f : d0);
      hu = is_tri ? dot(te2, q3) * dinv : 0.0f;
      hv = is_tri ? -dot(te1, q3) * dinv : 0.0f;
      front = is_tri ? d0 >= 1e-8f : a.front[i] != 0;
    } else {
      hu = a.hit_u[i];
      hv = a.hit_v[i];
      front = a.front[i] != 0;
    }
    const float w = 1.0f - hu - hv;
    const float fs = front ? 1.0f : -1.0f;
    V3 n_world = (vn0 * w + vn1 * hu + vn2 * hv) * fs;
    if (!a.flat) {
      // instance frame and material (a scene with no meshes: instance 0)
      const int oi = is_tri ? a.obj[i] : 0;
      const float* m = a.obj_transform + 16ll * oi;
      const V3 n_obj = n_world;
      n_world = {m[0] * n_obj.x + m[1] * n_obj.y + m[2] * n_obj.z,
                 m[4] * n_obj.x + m[5] * n_obj.y + m[6] * n_obj.z,
                 m[8] * n_obj.x + m[9] * n_obj.y + m[10] * n_obj.z};
      const int mat = a.obj_mat[oi];
      albedo = ld3(a.mat_albedo, mat);
      emission = ld3(a.mat_emission, mat) * a.mat_emission_strength[mat];
      refl = a.mat_reflectance[mat];
      ior = a.mat_ior[mat];
    }
    V3 normal = n_world / clamp_min(norm(n_world), 1e-20f);
    if (a.n_spheres > 0) {
      const bool is_sph = kind == 1;
      const int si = is_sph ? prim : 0;
      V3 s_n = hp - ld3(a.sphere_pos, si);
      s_n = s_n / clamp_min(norm(s_n), 1e-20f);
      s_n = s_n * fs;
      if (is_sph) {
        const int sm = a.sphere_mat[si];
        normal = s_n;
        albedo = ld3(a.mat_albedo, sm);
        emission = ld3(a.mat_emission, sm) * a.mat_emission_strength[sm];
        refl = a.mat_reflectance[sm];
        ior = a.mat_ior[sm];
      }
    }

    // ---- pending light resolve
    const bool was_delta = DI.x == -1.0f;
    const V3 final_light = sel(was_delta, emission, DI);
    const V3 contrib = final_light + (j == 0 ? 1.0f : 0.0f) * emission;
    V3 total = sel(did, TO + contrib * AT, TO);
    const bool nan_or_neg = isnan(total.x) || isnan(total.y) ||
                            isnan(total.z) || total.x < 0.0f ||
                            total.y < 0.0f || total.z < 0.0f;
    bad = bad || (did && nan_or_neg);

    // ---- escape: environment light
    const bool esc = alive && !did_hit;
    const V3 env_l = environment_light(a.env_horizon, a.env_zenith,
                                       a.env_ground, a.env_light_dir, D);
    total = sel(esc, total + AT * env_l, total);
    const bool shaded = did && !bad;

    // ---- BSDF lobes and the light sample
    float u6[7];
    uniforms(a.seed, static_cast<unsigned>(pix), a.frame,
             static_cast<unsigned>(sb + s), static_cast<unsigned>(j), 7, u6);
    const bool is_spec = refl != 0.0f;
    const bool is_diel = !is_spec && ior != -1.0f;
    bool is_diff = !is_spec && !is_diel;

    const V3 nee_origin = hp + normal * 0.01f;
    int li = 0;
    if (a.n_lights > 1) {
      li = static_cast<int>(u6[0] * static_cast<float>(a.n_lights));
      li = li < a.n_lights - 1 ? li : a.n_lights - 1;
    }
    const V3 point = ld3(a.light_corner, li) + ld3(a.light_edge_u, li) * u6[1] +
                     ld3(a.light_edge_v, li) * u6[2];
    const V3 vec = point - nee_origin;
    const float l_dist = norm(vec);
    const V3 l_dir = vec / clamp_min(l_dist, 1e-20f);
    const float cos_pdf_at_l = clamp_min(dot(l_dir, normal) * kInvPi, 0.0f);

    const float phi = u6[3] * static_cast<float>(2.0 * 3.141592653589793);
    const float sqrt_r2 = sqrtf(u6[4]);
    const float cx = cosf(phi) * sqrt_r2, cy = sinf(phi) * sqrt_r2;
    const float cz = sqrtf(1.0f - u6[4]);
    const V3 non_parallel = fabsf(normal.x) < 1.0f ? V3{1.0f, 0.0f, 0.0f}
                                                   : V3{0.0f, 0.0f, 1.0f};
    V3 t = cross(normal, non_parallel);
    t = t / clamp_min(norm(t), 1e-20f);
    const V3 b = cross(normal, t);
    const V3 cos_dir = t * cx + b * cy + normal * cz;
    const float real_cos_pdf = clamp_min(dot(cos_dir, normal) * kInvPi, 0.0f);
    const V3 rad_diff =
        albedo * kInvPi *
        (dot(normal, cos_dir) / clamp_min(real_cos_pdf, 1e-20f));
    const V3 nee_k = albedo * (kInvPi * clamp_min(dot(normal, l_dir), 0.0f));

    const V3 dir_spec = D - (2.0f * dot(D, normal)) * normal;
    const float ior_eff = front ? 1.0f / ior : ior;
    const float cosine = dot(-D, normal);
    const float sine = sqrtf(clamp_min(1.0f - cosine * cosine, 0.0f));
    float r0s = (1.0f - ior_eff) / (1.0f + ior_eff);
    r0s = r0s * r0s;
    const float xs = 1.0f - cosine;
    const float x2 = xs * xs;
    const float schlick = r0s + (1.0f - r0s) * (xs * (x2 * x2));
    const bool solution = (ior_eff * sine > 1.0f) || (schlick > u6[5]);
    const float cos_i = dot(normal, D);
    const float k = 1.0f - ior_eff * ior_eff * (1.0f - cos_i * cos_i);
    const V3 refr = ior_eff * D -
                    (ior_eff * cos_i + sqrtf(clamp_min(k, 0.0f))) * normal;
    const V3 dir_diel =
        sel(solution, dir_spec, sel(k < 0.0f, splat(0.0f), refr));
    const float dn = dot(normal, D);
    const float sign_dn =
        static_cast<float>((0.0f < dn ? 1 : 0) - (dn < 0.0f ? 1 : 0));
    const float sign_diel = solution ? 1.0f : sign_dn;
    const V3 bounce_dir =
        sel(is_spec, dir_spec, sel(is_diel, dir_diel, cos_dir));
    const V3 radiance = sel(is_diff, rad_diff, a.tint ? albedo : splat(1.0f));
    const float origin_sign = is_diel ? sign_diel : 1.0f;
    V3 atten = AT * sel(shaded, radiance, splat(1.0f));

    // ---- russian roulette
    float rr = clamp_max(max3(atten), a.rr_clamp);
    rr = j <= a.rr_start ? 1.0f : rr;
    const bool killed = u6[6] > rr;
    atten = atten / clamp_min(rr, 1e-20f);

    const bool continuing = shaded && !killed && j < a.bounce_limit;
    const bool nee_sem = continuing && is_diff;
    const bool nee_active = nee_sem && dot(normal, l_dir) > 0.0f;

    // ---- sample completion and regeneration
    const bool path_ends = alive && !continuing;
    const V3 acc =
        AC + sel(path_ends, sel(bad, splat(0.0f), total), splat(0.0f));
    const int s_new = s + (path_ends ? 1 : 0);
    const bool regen = path_ends && s_new < a.n_spp;
    V3 po, pd;
    raygen(a.consts, a.width, a.height, a.aa_jitter != 0, a.seed, a.frame,
           pix, sb + s_new, &po, &pd);
    const V3 bounce_origin = hp + normal * (origin_sign * 1e-5f);
    const V3 new_origin = sel(continuing, bounce_origin, sel(regen, po, O));
    const V3 new_dir = sel(continuing, bounce_dir, sel(regen, pd, D));
    const bool alive_next = continuing || regen;
    const int j_new = continuing ? j + 1 : 0;
    total = sel(path_ends, splat(0.0f), total);
    atten = sel(path_ends, splat(1.0f), atten);
    bad = bad && !path_ends;
    const bool fresh_direct = shaded && !path_ends;
    const V3 direct_base = sel(path_ends, splat(0.0f), DI);

    // ---- the packed rows (shading.pack_lanes) and the bin key
    float f[kPackedF] = {
        new_origin.x, new_origin.y, new_origin.z, new_dir.x, new_dir.y,
        new_dir.z, atten.x, atten.y, atten.z, total.x, total.y, total.z,
        acc.x, acc.y, acc.z, direct_base.x, direct_base.y, direct_base.z,
        nee_origin.x, nee_origin.y, nee_origin.z, l_dir.x, l_dir.y, l_dir.z,
        nee_k.x, nee_k.y, nee_k.z, alive_next ? 1.0f : 0.0f,
        bad ? 1.0f : 0.0f, fresh_direct ? 1.0f : 0.0f, is_diff ? 1.0f : 0.0f,
        cos_pdf_at_l, l_dist, nee_active ? 1.0f : 0.0f};
    float2* out = reinterpret_cast<float2*>(a.packed + kPackedF * i);
#pragma unroll
    for (int c = 0; c < kPackedF / 2; ++c) out[c] = {f[2 * c], f[2 * c + 1]};
    int2* out_i = reinterpret_cast<int2*>(a.packed_i + kPackedI * i);
    out_i[0] = {j_new, s_new};
    out_i[1] = {pix, a.slot[i]};
    out_i[2] = {li, sb};
    a.key[i] = bin_key(a.consts, a.mb, a.db, a.morton != 0, new_origin,
                       new_dir, alive_next);

    c_alive = alive_next;
    c_sem = a.n_lights > 0 && nee_sem;
    c_act = a.n_lights > 0 && nee_active;
  }
  // ---- the round's counts (kernels/shade.py::shade_round_reference)
  const int b_alive = __syncthreads_count(c_alive);
  const int b_sem = __syncthreads_count(c_sem);
  const int b_act = __syncthreads_count(c_act);
  if (threadIdx.x == 0) {
    unsigned long long sem = b_alive + b_sem, traced = b_alive + b_act;
    if (blockIdx.x == 0) {
      sem += static_cast<unsigned long long>(a.prev_rays[0]);
      traced += static_cast<unsigned long long>(a.prev_rays[1]);
    }
    atomicAdd(a.tally, sem);
    atomicAdd(a.tally + 1, traced);
    atomicAdd(a.tally + 2, static_cast<unsigned long long>(b_alive));
  }
}


enum Store { kInPlace = 0, kVector = 1, kBulk = 2 };

// The tile's first ``words`` (even) words to ``dst`` by the block's
// threads, 16 bytes a thread, neighbours on neighbouring addresses; the
// last 2 words, where ``words`` is not a multiple of 4, as one 8-byte
// store
__device__ __forceinline__ void vector_tile(const void* tile, void* dst,
                                            int words) {
  const int n4 = words / 4;
  const uint4* src4 = static_cast<const uint4*>(tile);
  uint4* dst4 = static_cast<uint4*>(dst);
  for (int k = threadIdx.x; k < n4; k += kBlock) dst4[k] = src4[k];
  if (words % 4 != 0 && threadIdx.x == kBlock - 1) {
    static_cast<uint2*>(dst)[2 * n4] = static_cast<const uint2*>(tile)[2 * n4];
  }
}

// One 256-lane tile of variant_kernel: the lanes' rows written as kStore
// says; ``more``: the block takes another tile after this one, so the
// tiles are free again before it returns
template <int kStore, bool kLazy>
__device__ __forceinline__ void variant_tile(const ShadeArgs& a, int tile,
                                             bool more, float* tile_f,
                                             int* tile_i, Counts& cnt) {
  const long long base = static_cast<long long>(tile) * kBlock;
  const int rows = min(kBlock, a.n - static_cast<int>(base));
  if (static_cast<int>(threadIdx.x) < rows) {
    const long long i = base + threadIdx.x;
    if constexpr (kStore == kInPlace) {
      shade_lane<kLazy>(a, i, a.packed + kPackedF * i,
                        a.packed_i + kPackedI * i, cnt);
    } else {
      shade_lane<kLazy>(a, i, tile_f + kPackedF * threadIdx.x,
                        tile_i + kPackedI * threadIdx.x, cnt);
    }
  }
  if constexpr (kStore == kVector) {
    __syncthreads();
    vector_tile(tile_f, a.packed + kPackedF * base, kPackedF * rows);
    vector_tile(tile_i, a.packed_i + kPackedI * base, kPackedI * rows);
    if (more) __syncthreads();
  } else if constexpr (kStore == kBulk) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    store_tile(tile_f, a.packed + kPackedF * base, kPackedF * rows);
    store_tile(tile_i, a.packed_i + kPackedI * base, kPackedI * rows);
    commit_stores();
    if (more) {
      wait_store_reads();
      __syncthreads();
    }
  }
}

// kLoop false: one block a tile, as shade_kernel; true: block b takes
// tiles b, b + gridDim.x, ...
template <int kStore, bool kLazy, int kMinBlocks, bool kLoop>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    variant_kernel(const ShadeArgs a) {
  constexpr bool kStaged = kStore != kInPlace;
  __shared__ __align__(16) float tile_f[kStaged ? kBlock * kPackedF : 2];
  __shared__ __align__(16) int tile_i[kStaged ? kBlock * kPackedI : 2];
  Counts cnt;
  if constexpr (kLoop) {
    const int tiles = (a.n + kBlock - 1) / kBlock;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      variant_tile<kStore, kLazy>(a, tile, tile + gridDim.x < tiles, tile_f,
                                  tile_i, cnt);
    }
  } else {
    variant_tile<kStore, kLazy>(a, blockIdx.x, false, tile_f, tile_i, cnt);
  }
  add_counts(a, cnt);
  if constexpr (kStore == kBulk) wait_store_reads();
}

using Kernel = void (*)(const ShadeArgs);

// rt_shade_variant's variant ids, in tools/shade_round_variants.py's order
const Kernel kVariants[] = {
    old_shade_kernel,                             // old
    variant_kernel<kBulk, true, 4, false>,        // shipped_copy
    variant_kernel<kVector, true, 4, false>,      // vector
    variant_kernel<kInPlace, true, 4, false>,     // in_place
    variant_kernel<kBulk, false, 4, false>,       // eager
    variant_kernel<kBulk, true, 4, true>,         // persistent
    variant_kernel<kBulk, true, 3, false>,        // blocks3
    variant_kernel<kBulk, true, 5, false>,        // blocks5
    variant_kernel<kBulk, true, 1, false>,        // regs_free
    variant_kernel<kInPlace, true, 3, false>,     // in_place_blocks3
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kPersistent = 5;

}  // namespace

// Blocks of ``variant`` (-1: shade_kernel<false>, the untextured instance,
// as the package's library builds it from the same source and flags) that
// fit on one SM at once, its registers a thread, and its local-memory and
// static shared-memory bytes.
extern "C" int rt_shade_variant_info(int variant, int* blocks_per_sm,
                                     int* registers, int* local_bytes,
                                     int* shared_bytes) {
  if (variant < -1 || variant >= kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(
      variant < 0 ? shade_kernel<false> : kVariants[variant]);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kBlock,
                                                    0));
}

// One launch of ``variant`` on the shade kernel's arguments.
extern "C" int rt_shade_variant(int variant, const ShadeArgs* a,
                                void* stream) {
  if (variant < 0 || variant >= kNumVariants || a->n < 1 || a->mb < 0 ||
      a->db < 0 || 3 * (a->mb + a->db) + 3 > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = (a->n + kBlock - 1) / kBlock;
  if (variant == kPersistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kVariants[variant]), kBlock,
        0);
    grid = min(grid, max(1, sms * per_sm));
  }
  kVariants[variant]<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}
