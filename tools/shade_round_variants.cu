// The round kernels before their redesigns, and the redesigned kernels
// with each design element switched: built and launched by
// tools/shade_round_variants.py (for chip_smoke.py,
// tools/measure_shade_round.py, tools/measure_permute.py and the GPU
// tests); not part of the package's library.  Every variant computes
// exactly what its shipped kernel (ray_tracer_tpu_torch/csrc/
// shade_round.cu) computes, bit for bit: the same expressions on the same
// operands, only where the bytes go, which lanes evaluate a select's
// unused side and which loads run differ.
//
// The split layout.  Before the 40-word row, a lane's state was two rows:
// 34 f32 words and 6 i32 words, in two arrays.  The kernels of that layout
// write and read them here in one buffer: the f32 rows from word 0, the
// i32 rows from word split_offset(n) (16-byte aligned).
//
// old_shade_kernel is shade_kernel as it was first written, copied
// verbatim but for its name and the address of its i32 rows: one thread
// per lane, the whole lane computed on every lane, its 34-float row held
// in registers to the end and written in place as 17 float2 and 3 int2
// stores 136 B and 24 B apart (the split layout), the counts as three
// __syncthreads_count sums and three atomics per block of 256.
//
// variant_kernel<kStore, kLazy, kMinBlocks, kLoop> is shade_kernel with:
//   kStore      kInPlace: each lane writes its row in place (float2/int2
//               stores 160 B apart); kVector: staged in shared memory and
//               copied out by the block's threads with 16-byte stores;
//               kBulk: staged and copied out by thread 0's TMA bulk store
//               (cp.async.bulk) (shipped); kSplit: the split layout's two
//               tiles, each stored by TMA, the last 8 bytes of a ragged
//               f32 tile by a plain store (the kernel before the 40-word
//               row)
//   kLazy       false: the sky, the lobes and the camera ray on every lane
//               (the old kernel's order of work); true: only where selected
//               (shipped)
//   kMinBlocks  __launch_bounds__ blocks per SM, which caps the registers
//               at 65536 / (256 kMinBlocks), rounded down to a multiple of 8
//               (shipped: 4, 64 registers)
//   kLoop       true: block b takes tiles b, b + gridDim.x, ... ("persistent":
//               the shipped configuration on a grid of as many blocks as
//               fit on the card at once); false: one block a tile (shipped)
//
// old_permute_kernel is permute_kernel as it was first written, verbatim
// but for its name: one thread per lane reading its split rows in place
// (17 float2 and 3 int2 loads, 136 B and 24 B apart) and writing each
// column itself.  tma_floor_kernel only gathers the 40-word rows by the
// order into a contiguous copy, by the TMA engine in and out (the shipped
// kernel's loads): what a gather of these bytes can reach.
//
// old_nee_kernel is nee_resolve_kernel as it was first written, verbatim
// but for its name: every field loaded on every lane.

#include "../ray_tracer_tpu_torch/csrc/shade_round.cu"

namespace {

// The first word of the split layout's i32 rows in a buffer of n lanes
__host__ __device__ __forceinline__ long long split_offset(int n) {
  return (static_cast<long long>(kPackedF) * n + 3) & ~3ll;
}
__device__ __forceinline__ int* split_ints(const ShadeArgs& a) {
  return reinterpret_cast<int*>(a.packed + split_offset(a.n));
}

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
    int2* out_i = reinterpret_cast<int2*>(split_ints(a) + kPackedI * i);
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


enum Store { kInPlace = 0, kVector = 1, kBulk = 2, kSplit = 3 };

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

// store_tile of the first ``words`` (even) words of a split-layout tile:
// the 8 bytes past the last 16-byte boundary, if any, by a plain store of
// the block's last thread
__device__ __forceinline__ void store_split_tile(const void* tile, void* dst,
                                                 int words) {
  const int n4 = words / 4;
  if (n4 > 0) store_tile(tile, dst, 4 * n4);
  if (words % 4 != 0 && threadIdx.x == kBlock - 1) {
    static_cast<uint2*>(dst)[2 * n4] = static_cast<const uint2*>(tile)[2 * n4];
  }
}

// One 256-lane tile of variant_kernel: the lanes' rows written as kStore
// says (``tile``: the 40-word rows, or kSplit's f32 rows with its i32 rows
// at ``tile_i``); ``more``: the block takes another tile after this one,
// so the tiles are free again before it returns
template <int kStore, bool kLazy>
__device__ __forceinline__ void variant_tile(const ShadeArgs& a, int tile_id,
                                             bool more, float* tile,
                                             int* tile_i, Counts& cnt) {
  const long long base = static_cast<long long>(tile_id) * kBlock;
  const int rows = min(kBlock, a.n - static_cast<int>(base));
  if (static_cast<int>(threadIdx.x) < rows) {
    const long long i = base + threadIdx.x;
    if constexpr (kStore == kInPlace) {
      float* row = a.packed + kRow * i;
      shade_lane<kLazy>(a, i, row, reinterpret_cast<int*>(row + kPackedF),
                        cnt);
    } else if constexpr (kStore == kSplit) {
      shade_lane<kLazy>(a, i, tile + kPackedF * threadIdx.x,
                        tile_i + kPackedI * threadIdx.x, cnt);
    } else {
      float* row = tile + kRow * threadIdx.x;
      shade_lane<kLazy>(a, i, row, reinterpret_cast<int*>(row + kPackedF),
                        cnt);
    }
  }
  if constexpr (kStore == kVector) {
    __syncthreads();
    vector_tile(tile, a.packed + kRow * base, kRow * rows);
    if (more) __syncthreads();
  } else if constexpr (kStore == kBulk || kStore == kSplit) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if constexpr (kStore == kBulk) {
      store_tile(tile, a.packed + kRow * base, kRow * rows);
    } else {
      store_split_tile(tile, a.packed + kPackedF * base, kPackedF * rows);
      store_split_tile(tile_i, split_ints(a) + kPackedI * base,
                       kPackedI * rows);
    }
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
  constexpr bool kSplitTiles = kStore == kSplit;
  __shared__ __align__(16) float tile[
      kStore == kInPlace ? 4 : kBlock * (kSplitTiles ? kPackedF : kRow)];
  __shared__ __align__(16) int tile_i[kSplitTiles ? kBlock * kPackedI : 4];
  Counts cnt;
  if constexpr (kLoop) {
    const int tiles = (a.n + kBlock - 1) / kBlock;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      variant_tile<kStore, kLazy>(a, t, t + gridDim.x < tiles, tile, tile_i,
                                  cnt);
    }
  } else {
    variant_tile<kStore, kLazy>(a, blockIdx.x, false, tile, tile_i, cnt);
  }
  add_counts(a, cnt);
  if constexpr (kStore == kBulk || kStore == kSplit) wait_store_reads();
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
    variant_kernel<kSplit, true, 4, false>,       // split
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kPersistent = 5;

// ---- the state permute

__global__ void __launch_bounds__(kBlock)
    old_permute_kernel(const float* __restrict__ packed,
                       const int* __restrict__ packed_i,
                       const long long* __restrict__ order,
                       float* __restrict__ vec, float* __restrict__ cols,
                       unsigned char* __restrict__ flags,
                       int* __restrict__ ints, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const long long src = order[i];
  const float2* row = reinterpret_cast<const float2*>(packed + kPackedF * src);
  float f[kPackedF];
#pragma unroll
  for (int c = 0; c < kPackedF / 2; ++c) {
    const float2 v = row[c];
    f[2 * c] = v.x;
    f[2 * c + 1] = v.y;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float* dst = vec + (static_cast<long long>(k) * n + i) * 3;
    dst[0] = f[3 * k];
    dst[1] = f[3 * k + 1];
    dst[2] = f[3 * k + 2];
  }
  cols[i] = f[31];
  cols[n + i] = f[32];
  flags[i] = f[27] > 0.5f;
  flags[n + i] = f[28] > 0.5f;
  flags[2ll * n + i] = f[29] > 0.5f;
  flags[3ll * n + i] = f[30] > 0.5f;
  flags[4ll * n + i] = f[33] > 0.5f;
  const int2* irow = reinterpret_cast<const int2*>(packed_i + kPackedI * src);
#pragma unroll
  for (int c = 0; c < kPackedI / 2; ++c) {
    const int2 v = irow[c];
    ints[(2ll * c) * n + i] = v.x;
    ints[(2ll * c + 1) * n + i] = v.y;
  }
}

// The 40-word rows in ``order`` into ``out`` (N,40), nothing unpacked:
// the warp's rows copied in by 160-byte bulk copies of the TMA engine, as
// permute_kernel's, then out as one bulk copy of the warp's rows
__global__ void __launch_bounds__(kBlock)
    tma_floor_kernel(const float* __restrict__ packed,
                     const long long* __restrict__ order,
                     float* __restrict__ out, int n) {
  __shared__ __align__(16) float tile[kBlock * kRow];
  __shared__ __align__(8) unsigned long long bars[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const long long base =
      static_cast<long long>(blockIdx.x) * kBlock + (threadIdx.x & ~31);
  if (base >= n) return;  // the whole warp
  const int rows = static_cast<int>(min(32ll, n - base));
  float* wt = tile + kRow * (threadIdx.x & ~31);
  tma_rows(packed, lane < rows ? order[base + lane] : 0, rows, lane, wt,
           bars + threadIdx.x / 32);
  if (lane == 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            __cvta_generic_to_global(out + kRow * base)),
        "r"(static_cast<unsigned>(__cvta_generic_to_shared(wt))),
        "r"(rows * kRow * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

constexpr int kNumPermutes = 2;  // old_permute_kernel, tma_floor_kernel

// ---- the NEE resolve

__global__ void __launch_bounds__(kBlock) old_nee_kernel(const NeeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const V3 l_dir = ld3(a.l_dir, i);
  V3 l_emit = splat(0.0f);
  float real_l_pdf = 0.0f;
  if (a.n_lights > 0) {
    const int row = a.n_lights <= 1 ? 0 : a.li[i];
    const int mat = a.light_mat[row];
    l_emit = ld3(a.mat_emission, mat) * a.mat_emission_strength[mat];
    const float l_dist = a.l_dist[i];
    const float cos_theta = dot(ld3(a.light_normal, row), l_dir);
    const float pdf = l_dist * l_dist / (cos_theta * a.light_area[row]);
    const bool reached = a.nee_active[i] != 0 && a.occluded[i] == 0;
    real_l_pdf = reached ? pdf : 0.0f;
  }
  // real_l_pdf / n_lights, as torch's CUDA division by a Python number
  real_l_pdf = real_l_pdf * (1.0f / static_cast<float>(a.n_lights));
  const float c = a.cos_pdf_at_l[i];
  float w1 = real_l_pdf * real_l_pdf / (real_l_pdf * real_l_pdf + c * c);
  w1 = isnan(w1) ? 0.0f : w1;
  const float q = real_l_pdf == 0.0f ? 0.0f : w1 / real_l_pdf;
  const V3 direct_diff = l_emit * ld3(a.nee_k, i) * q;
  const V3 new_direct = a.is_diff[i] != 0 ? direct_diff : splat(-1.0f);
  const V3 out = a.fresh_direct[i] != 0 ? new_direct : ld3(a.direct_base, i);
  a.direct[3 * i] = out.x;
  a.direct[3 * i + 1] = out.y;
  a.direct[3 * i + 2] = out.z;
}

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

// One launch of permute variant ``variant`` over n lanes: 0
// old_permute_kernel (the split layout: ``packed`` its f32 rows,
// ``packed_i`` its i32 rows; the column outputs as permute_kernel's), 1
// tma_floor_kernel (``packed`` the 40-word rows, gathered into
// ``rows_out``, (N,40)).
extern "C" int rt_permute_variant(int variant, const void* packed,
                                  const void* packed_i, const void* order,
                                  void* vec, void* cols, void* flags,
                                  void* ints, void* rows_out, int n,
                                  void* stream) {
  if (variant < 0 || variant >= kNumPermutes || n < 1 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rows_out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(packed);
  const auto* o = static_cast<const long long*>(order);
  if (variant == 0) {
    old_permute_kernel<<<grid, block, 0, s>>>(
        f, static_cast<const int*>(packed_i), o, static_cast<float*>(vec),
        static_cast<float*>(cols), static_cast<unsigned char*>(flags),
        static_cast<int*>(ints), n);
  } else {
    tma_floor_kernel<<<grid, block, 0, s>>>(
        f, o, static_cast<float*>(rows_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local and static shared memory bytes and blocks per
// SM of permute variant ``variant`` (-1: permute_kernel as it ships).
extern "C" int rt_permute_variant_info(int variant, int* blocks_per_sm,
                                       int* registers, int* local_bytes,
                                       int* shared_bytes) {
  if (variant < -1 || variant >= kNumPermutes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn =
      variant < 0 ? reinterpret_cast<const void*>(permute_kernel)
      : variant == 0 ? reinterpret_cast<const void*>(old_permute_kernel)
                     : reinterpret_cast<const void*>(tma_floor_kernel);
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

// One launch of old_nee_kernel.
extern "C" int rt_old_nee(const NeeArgs* a, void* stream) {
  const dim3 grid((a->n + kBlock - 1) / kBlock), block(kBlock);
  old_nee_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
