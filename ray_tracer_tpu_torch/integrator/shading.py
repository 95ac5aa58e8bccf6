"""Per-lane shading of the wavefront integrator, in plain torch.

The shade fetch, texture and bump maps, primary-ray generation, the
occlusion-NEE resolve and the coherence-bin key, and the round's shading
block, :func:`shade_lanes`: everything a round computes for a lane from
its pending hit up to the state permute.  ``integrator/wavefront.py`` runs
these in its torch round, and ``kernels/shade.py`` holds them as the plain
versions of its CUDA kernels, so the two are one code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import env as env_ops
from ..ops import intersect, traverse
from ..ops.intersect import cross, dot, norm, sqrt
from ..sampling import bsdf, lights, rng
from ..scene.types import CompiledScene

INV_PI = bsdf.INV_PI
F32 = torch.float32
I32 = torch.int32


class CameraRays(NamedTuple):
    origin: torch.Tensor  # (N,3)
    direction: torch.Tensor  # (N,3)


def raygen(cam_rotation, cam_pos, fov, aspect, near, pixel_id, width,
           height, jitter=None):
    """Primary rays, replicating raytrace.comp:539-560.

    ``uv = pixel / dim`` with no half-pixel offset (reference quirk); the
    view-plane sits at z=0.1 while its *size* uses ``near``.  Camera
    parameters are f32 tensors; the rotation is applied as written-out
    products and sums (no matmul, so no TF32 setting can touch it and CPU
    and GPU round it alike).
    """
    x = (pixel_id % width).to(F32)
    y = torch.div(pixel_id, width, rounding_mode="floor").to(F32)
    if jitter is not None:
        x = x + jitter[:, 0]
        y = y + jitter[:, 1]
    u = x / width
    v = y / height
    plane_h = near * torch.tan(torch.deg2rad(fov * 0.5)) * 2.0
    plane_w = plane_h * aspect
    px = -plane_w / 2.0 + plane_w * u
    py = -plane_h / 2.0 + plane_h * v
    point = torch.stack([px, py, torch.full_like(px, 0.1)], dim=-1)
    d = point / norm(point, keepdim=True)
    r = cam_rotation
    d = torch.stack(
        [d[:, 0] * r[i, 0] + d[:, 1] * r[i, 1] + d[:, 2] * r[i, 2]
         for i in range(3)],
        dim=-1,
    )
    origin = cam_pos.expand(d.shape)
    return CameraRays(origin, d)


def shade_fetch(scene: CompiledScene, rays: CameraRays,
                 hit: traverse.Hit, space: str = "slot",
                 cfg: RenderConfig = None):
    """All deferred shading attributes from ONE fat-row gather, from
    ``shade_slot`` or, where triangle hits are global ids (``space`` is
    ``traverse.prim_space``'s ``'tri'``), ``shade_tri``.

    Returns ``(hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
    sampler, metal_tex, alpha_tex, front)``.  On a flattened scene triangle
    barycentrics and facing are RE-DERIVED from the row's geometry fields
    (32:44) with the kernel's Moller-Trumbore formulas, since the
    traversal returns only (dst, prim); a forest scene's rows are in
    object space, so there they are the walk's (``hit.u``, ``hit.v``,
    ``hit.front``), the normal goes through ``obj_transform[hit.obj]``
    (the reference's M, not its inverse transpose) and the material and
    sampler are the instance's (``obj_mat``, ``obj_sampler``).  Sphere
    lanes keep the sphere intersector's facing bit.  With
    ``cfg.enable_normal_maps`` (and textures) a flattened scene's bump
    maps perturb the normal (:func:`bump`).  No-hit lanes (and every lane
    of a mesh-free scene, whose ``shade_slot`` is a placeholder) read row
    0: junk that every consumer masks by ``did_hit`` or replaces with the
    sphere's material.
    """
    flat = scene.meta.get("flattened", False)
    hp = rays.origin + rays.direction * hit.dst[:, None]
    is_tri = hit.kind == traverse.KIND_TRI
    tri_i = torch.where(is_tri, hit.prim, 0).long()
    table = scene.shade_tri if space == "tri" else scene.shade_slot
    srow = table[tri_i]  # (N,48): the ONE hot gather

    if flat:
        d_eps = torch.where(rays.direction == 0.0, 1e-20, rays.direction)
        r3 = rays.origin - srow[:, 32:35]
        q3 = cross(r3, d_eps)
        d0 = -dot(d_eps, srow[:, 41:44])
        dinv = 1.0 / torch.where(d0 == 0.0, 1e-20, d0)
        hu = torch.where(is_tri, dot(srow[:, 38:41], q3) * dinv, 0.0)
        hv = torch.where(is_tri, -dot(srow[:, 35:38], q3) * dinv, 0.0)
        front = torch.where(is_tri, d0 >= 1e-8, hit.front)
    else:
        hu, hv, front = hit.u, hit.v, hit.front

    w = 1.0 - hu - hv
    vn0, vn1, vn2 = srow[:, 0:3], srow[:, 3:6], srow[:, 6:9]
    n_obj = vn0 * w[:, None] + vn1 * hu[:, None] + vn2 * hv[:, None]
    n_obj = n_obj * torch.where(front, 1.0, -1.0)[:, None]
    obj_i = torch.where(is_tri, hit.obj, 0).long()
    if flat:
        # geometry and vertex normals were baked to world space
        n_world = n_obj
    else:
        m = scene.obj_transform[obj_i]
        n_world = torch.stack(
            [m[:, i, 0] * n_obj[:, 0] + m[:, i, 1] * n_obj[:, 1]
             + m[:, i, 2] * n_obj[:, 2] for i in range(3)], dim=-1)
    normal = n_world / torch.clamp(norm(n_world, keepdim=True), min=1e-20)

    uv0, uv1, uv2 = srow[:, 9:11], srow[:, 11:13], srow[:, 13:15]
    uv = uv0 * w[:, None] + uv1 * hu[:, None] + uv2 * hv[:, None]
    uv = torch.where(srow[:, 15:16] > 0.5, 0.5, uv)  # raytrace.comp:254-256

    if (cfg is not None and cfg.enable_normal_maps and cfg.enable_textures
            and flat and scene.meta.get("n_bump_maps", 0) > 0
            and scene.meta.get("n_textures", 0) > 0):
        normal = bump(scene, cfg, srow, uv, normal, is_tri)

    if flat:
        albedo = srow[:, 16:19]
        emission = srow[:, 19:22]
        reflectance = srow[:, 22]
        ior = srow[:, 23]
        tex_id = srow[:, 24].to(I32)
        sampler = srow[:, 25].to(I32)
        metal_tex = srow[:, 29].to(I32)
        alpha_tex = srow[:, 30].to(I32)
    else:
        # instances share their mesh's rows: the material and sampler are
        # the instance's (quirk Q11's forest layout)
        mat = scene.obj_mat[obj_i].long()
        albedo = scene.mat_albedo[mat]
        emission = (scene.mat_emission[mat]
                    * scene.mat_emission_strength[mat][:, None])
        reflectance = scene.mat_reflectance[mat]
        ior = scene.mat_ior[mat]
        tex_id = scene.mat_albedo_tex[mat]
        sampler = scene.obj_sampler[obj_i]
        metal_tex = scene.mat_metalness_tex[mat]
        alpha_tex = scene.mat_alpha_tex[mat]

    if scene.n_spheres > 0:
        is_sphere = hit.kind == traverse.KIND_SPHERE
        sphere_i = torch.where(is_sphere, hit.prim, 0).long()
        s_n = hp - scene.sphere_pos[sphere_i]
        s_n = s_n / torch.clamp(norm(s_n, keepdim=True), min=1e-20)
        s_n = s_n * torch.where(front, 1.0, -1.0)[:, None]
        normal = torch.where(is_sphere[:, None], s_n, normal)
        smat = scene.sphere_mat[sphere_i].long()
        sp = is_sphere[:, None]
        albedo = torch.where(sp, scene.mat_albedo[smat], albedo)
        emission = torch.where(
            sp,
            scene.mat_emission[smat]
            * scene.mat_emission_strength[smat][:, None],
            emission,
        )
        reflectance = torch.where(
            is_sphere, scene.mat_reflectance[smat], reflectance
        )
        ior = torch.where(is_sphere, scene.mat_ior[smat], ior)
        tex_id = torch.where(is_sphere, scene.mat_albedo_tex[smat], tex_id)
        metal_tex = torch.where(
            is_sphere, scene.mat_metalness_tex[smat], metal_tex
        )
        alpha_tex = torch.where(
            is_sphere, scene.mat_alpha_tex[smat], alpha_tex
        )

    return (hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
            sampler, metal_tex, alpha_tex, front)


def bump(scene, cfg, srow, uv, normal, is_tri):
    """Height-map bump mapping (the JAX package's ``_shade_fetch``
    branch): the tangent frame solved from the row's edges and UV deltas,
    ``[E1; E2] = [T B] . [[du1, dv1], [du2, dv2]]^T``, made orthonormal
    against the shading normal (Gram-Schmidt), and the normal tilted by
    ``cfg.bump_scale`` times the height gradient: three taps of the bump
    texture's red channel (column 31), one texel apart in u and in v."""
    bump_tex = srow[:, 31].to(I32)
    e1, e2 = srow[:, 35:38], srow[:, 38:41]
    uv0, uv1, uv2 = srow[:, 9:11], srow[:, 11:13], srow[:, 13:15]
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok_det = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    t_vec = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    b_vec = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv[:, None]
    t_vec = t_vec - normal * dot(t_vec, normal)[:, None]
    t_hat = t_vec / torch.clamp(norm(t_vec, keepdim=True), min=1e-20)
    b_vec = (b_vec - normal * dot(b_vec, normal)[:, None]
             - t_hat * dot(b_vec, t_hat)[:, None])
    b_hat = b_vec / torch.clamp(norm(b_vec, keepdim=True), min=1e-20)
    hw = scene.tex_size[torch.clamp(bump_tex, min=0).long()].to(F32)
    step_u = 1.0 / torch.clamp(hw[:, 1], min=2.0)
    step_v = 1.0 / torch.clamp(hw[:, 0], min=2.0)
    zeros = torch.zeros_like(step_u)
    smp = srow[:, 25].to(I32)  # the instance's sampler
    h0 = sample_texture(scene, bump_tex, uv, smp)[:, 0]
    h_u = sample_texture(scene, bump_tex,
                          uv + torch.stack([step_u, zeros], 1), smp)[:, 0]
    h_v = sample_texture(scene, bump_tex,
                          uv + torch.stack([zeros, step_v], 1), smp)[:, 0]
    pert = normal - cfg.bump_scale * (
        (h_u - h0)[:, None] * t_hat + (h_v - h0)[:, None] * b_hat)
    pert = pert / torch.clamp(norm(pert, keepdim=True), min=1e-20)
    use = is_tri & (bump_tex >= 0) & ok_det
    return torch.where(use[:, None], pert, normal)


def apply_material_maps(scene, cfg, uv, sampler, albedo, emission,
                         reflectance, tex_id, metal_tex, alpha_tex):
    """Sample albedo/metalness/alpha maps into the per-hit material params.

    Albedo map multiplies the albedo; the metalness map's red channel
    REPLACES ``reflectance``; an alpha-map red channel < 0.5 marks the hit
    as a cutout (a pass-through delta bounce, emission zeroed).
    Returns (albedo, emission, reflectance, cutout).
    """
    cutout = torch.zeros(uv.shape[:1], dtype=torch.bool, device=uv.device)
    if not (cfg.enable_textures and scene.meta.get("n_textures", 0) > 0):
        return albedo, emission, reflectance, cutout
    tex_rgb = sample_texture(scene, tex_id, uv, sampler)
    albedo = torch.where((tex_id >= 0)[:, None], albedo * tex_rgb, albedo)
    if scene.meta.get("n_metalness_maps", 0) > 0:
        m_rgb = sample_texture(scene, metal_tex, uv, sampler)
        reflectance = torch.where(metal_tex >= 0, m_rgb[:, 0], reflectance)
    if scene.meta.get("n_alpha_maps", 0) > 0:
        a_rgb = sample_texture(scene, alpha_tex, uv, sampler)
        cutout = (alpha_tex >= 0) & (a_rgb[:, 0] < 0.5)
        emission = torch.where(cutout[:, None], 0.0, emission)
    return albedo, emission, reflectance, cutout


def sample_texture(scene: CompiledScene, tex_id, uv, sampler):
    """Bilinear/nearest fetch from the padded sRGB texture stack (v flipped:
    OBJ uv origin bottom-left vs row-major images)."""
    tid, near, quad, ax, ay = texel_taps(scene, tex_id, uv)

    def fetch(tap):
        iy, ix = tap
        return srgb_to_linear(scene.tex_data[tid, iy, ix])

    c00, c10, c01, c11 = (fetch(t) for t in quad)
    bilinear = (
        c00 * (1 - ax) * (1 - ay)
        + c10 * ax * (1 - ay)
        + c01 * (1 - ax) * ay
        + c11 * ax * ay
    )
    nearest = fetch(near)
    return torch.where((sampler == 1)[:, None], bilinear, nearest)


def texel_taps(scene: CompiledScene, tex_id, uv):
    """The taps :func:`sample_texture` reads of texture ``tex_id`` at
    ``uv`` (uv wrapped, v flipped): the texture's index in the stack
    (clamped to 0), the nearest tap, the four bilinear taps (x0, y0),
    (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1), each an ``(iy, ix)``
    pair of i64 indices clamped to the texture's own size, and the
    bilinear weights ``ax``, ``ay`` (N,1)."""
    tid = torch.clamp(tex_id, min=0).long()
    hw = scene.tex_size[tid].to(F32)  # (N,2) = (h,w)
    h, w_ = hw[:, 0], hw[:, 1]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    fx = u * w_ - 0.5
    fy = (1.0 - v) * h - 0.5
    x_max = (w_ - 1).to(I32)
    y_max = (h - 1).to(I32)

    def at(ix, iy):
        return (torch.minimum(torch.clamp(iy, min=0), y_max).long(),
                torch.minimum(torch.clamp(ix, min=0), x_max).long())

    x0 = torch.floor(fx).to(I32)
    y0 = torch.floor(fy).to(I32)
    near = at(torch.round(fx).to(I32), torch.round(fy).to(I32))
    quad = (at(x0, y0), at(x0 + 1, y0), at(x0, y0 + 1), at(x0 + 1, y0 + 1))
    return tid, near, quad, (fx - x0)[:, None], (fy - y0)[:, None]


def srgb_to_linear(texels):
    """Linear f32 values of sRGB bytes (a u8 tensor of any shape): the
    texture fetch's decode.  ``kernels/shade.py`` tabulates it over the
    256 byte values, so the shade kernel's decode is one lookup."""
    srgb = texels.to(F32) / 255.0
    return torch.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    )


def analytic_nee(scene, li, l_dir, l_dist, reached):
    """Occlusion NEE's light side: the sampled light's emission and its
    pdf at the sampled distance where the shadow ray ``reached`` it, else
    0 -> ``(l_emit, real_l_pdf)``."""
    li = li.long()
    l_emit = lights.rect_light_emission(scene, li)
    real_l_pdf = torch.where(
        reached, lights.rect_light_pdf_analytic(scene, li, l_dir, l_dist),
        0.0)
    return l_emit, real_l_pdf


def resolve_direct(real_l_pdf, n_lights_w, cos_pdf_at_l, l_emit, nee_k,
                    is_diff, fresh_direct, direct_base):
    """MIS light-sample resolve -> next round's pending ``direct``: the
    power-heuristic light-side weight and the 0/1-NEE delta sentinel
    (raytrace.comp:449-456,500-505)."""
    real_l_pdf = real_l_pdf / n_lights_w
    w1 = real_l_pdf**2 / (real_l_pdf**2 + cos_pdf_at_l**2)
    w1 = torch.where(torch.isnan(w1), 0.0, w1)
    direct_diff = l_emit * nee_k * torch.where(
        real_l_pdf == 0.0, 0.0, w1 / real_l_pdf
    )[:, None]
    new_direct = torch.where(is_diff[:, None], direct_diff, -1.0)
    return torch.where(fresh_direct[:, None], new_direct, direct_base)


def octant(direction):
    """Direction octant, (N,) i32: bit k set where component k < 0."""
    return (
        (direction[:, 0] < 0).to(I32)
        + 2 * (direction[:, 1] < 0).to(I32)
        + 4 * (direction[:, 2] < 0).to(I32)
    )


DEAD_KEY = 1 << 30  # the bin key of a lane that is not alive


def morton_bits(scene: CompiledScene) -> bool:
    """Does the bin key hold origin morton bits: a scene with triangles,
    flattened, or a forest whose world box is finite
    (``CompiledScene.forest_box``)?  Read from the scene alone, with no
    device operation."""
    if not scene.meta.get("n_tris", 0):
        return False
    return (scene.meta.get("flattened", False)
            or scene.forest_box is not None)


def bin_box(scene: CompiledScene):
    """The box of the bin key's morton cells, ``(minimum, extent)`` (3,)
    f32 on the scene's device, the extent clamped to 1e-6: a flattened
    scene's BVH root box; a forest's world box, the union of its
    instances' (``CompiledScene.forest_box``, built once per scene); None
    where the key has no morton bits (:func:`morton_bits`)."""
    if not morton_bits(scene):
        return None
    if scene.meta.get("flattened", False):
        root = scene.bvh_packed[scene.obj_bvh_root[0].long()]
        mn, mx = root[0:3], root[3:6]
        return mn, torch.clamp(mx - mn, min=1e-6)
    return scene.forest_box


def bin_key(scene: CompiledScene, origin, direction, alive, mb=5, db=0):
    """Traversal-coherence sort key (int32): (direction octant [+ optional
    finer direction bits], origin morton cell in :func:`bin_box`); dead
    lanes key to the end.  Mesh-free scenes key by octant only.  (The JAX
    package keys forests by octant only too; the port gives them the
    morton cell, which changes the lanes' order and no lane's result.)"""
    oct_ = octant(direction)
    key = oct_ << (3 * mb + 3 * db)
    if db:
        dq = torch.clamp(
            torch.abs(direction) * (1 << db), 0, (1 << db) - 1
        ).to(I32)
        dmix = (dq[:, 0] << (2 * db)) | (dq[:, 1] << db) | dq[:, 2]
        key = key | (dmix << (3 * mb))
    box = bin_box(scene)
    if box is not None:
        mn, extent = box
        cell = torch.clamp(
            ((origin - mn) / extent) * (1 << mb),
            0.0,
            float((1 << mb) - 1),
        ).to(I32)
        morton = torch.zeros_like(oct_)
        for b in range(mb):
            for ax in range(3):
                morton = morton | (((cell[:, ax] >> b) & 1) << (3 * b + ax))
        key = key | morton
    return torch.where(alive, key, DEAD_KEY).to(I32)


def key_runs(skey):
    """Runs of equal keys among the live lanes of the sorted bin keys
    ``skey`` (dead lanes, :data:`DEAD_KEY`, sort last): () i64, the count
    of live lanes whose key differs from the lane's before it."""
    start = torch.ones_like(skey, dtype=torch.bool)
    start[1:] = skey[1:] != skey[:-1]
    return (start & (skey != DEAD_KEY)).sum()


def primary_rays(cam, cfg, frame: int, pix, s) -> CameraRays:
    """Camera rays of pixels ``pix`` at samples ``s``; ``cam`` is
    ``(rotation, position, fov, aspect, near)``.  With ``cfg.aa_jitter``
    the pixel corner moves by two uniforms of draw index 999."""
    jitter = None
    if cfg.aa_jitter:
        jitter = rng.uniforms(cfg.seed ^ 0xA11A5, pix, frame, s, 999, 2)
        jitter = jitter - 0.5
    return raygen(*cam, pix, cfg.width, cfg.height, jitter)


class Lanes(NamedTuple):
    """A round's next lane state, in the order of the packed rows that
    the state permute moves: nine (N,3) f32 vectors, then seven (N,)
    columns (f32 or bool), then six (N,) i32 columns."""

    origin: torch.Tensor  # the next ray: bounce, regenerated or kept
    direction: torch.Tensor
    atten: torch.Tensor
    total: torch.Tensor
    acc: torch.Tensor
    direct_base: torch.Tensor  # ``direct`` where NEE adds nothing
    nee_origin: torch.Tensor  # the shadow ray
    l_dir: torch.Tensor
    nee_k: torch.Tensor  # albedo * cos / pi toward the light
    alive: torch.Tensor
    bad: torch.Tensor
    fresh_direct: torch.Tensor  # NEE resolves this lane's ``direct``
    is_diff: torch.Tensor
    cos_pdf_at_l: torch.Tensor
    l_dist: torch.Tensor
    nee_active: torch.Tensor  # the shadow ray is traced
    j: torch.Tensor
    s: torch.Tensor
    pix: torch.Tensor
    slot: torch.Tensor
    li: torch.Tensor  # the sampled light
    sb: torch.Tensor


N_VEC = 9  # (N,3) fields of Lanes, then N_COL (N,) columns packed as f32
N_COL = 7
PACKED_F = 3 * N_VEC + N_COL  # 34 f32 words
PACKED_I = 6  # j, s, pix, slot, li, sb: i32 words, stored as their bits
ROW = PACKED_F + PACKED_I  # 40 words, 160 B: five 32 B sectors a lane
_BOOL_COLS = (0, 1, 2, 3, 6)  # alive, bad, fresh_direct, is_diff, nee_active


def shade_lanes(scene: CompiledScene, cfg, space: str, w, frame: int,
                n_spp: int, cam):
    """One round's shading of the wave ``w`` (``wavefront.Wave``) ->
    ``(lanes, continuing, nee_sem, n_lights_w)``: the next :class:`Lanes`
    in lane order, the lanes that bounce on, those whose shadow ray counts
    as a semantic ray, and the inverse light-pick pdf.

    Shades each lane's pending hit (``space`` says which shade table its
    triangle ids index), resolves the pending light, adds the sky to
    escaped lanes, samples the three BSDF lobes and the NEE light, plays
    russian roulette, banks finished samples and regenerates their pixel's
    next sample (``cam`` as :func:`primary_rays` takes it).
    """
    hit = w.hit
    j = w.j
    sample = w.sb + w.s
    did = w.alive & hit.did_hit

    (hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
     sampler, metal_tex, alpha_tex, front) = shade_fetch(
        scene, CameraRays(w.origin, w.direction), hit, space, cfg
    )
    albedo, emission, reflectance, cutout = apply_material_maps(
        scene, cfg, uv, sampler, albedo, emission, reflectance,
        tex_id, metal_tex, alpha_tex,
    )

    # ---- pending light resolve (raytrace.comp:500-505)
    was_delta = w.direct[:, 0] == -1.0
    final_light = torch.where(was_delta[:, None], emission, w.direct)
    contrib = final_light + torch.where(j == 0, 1.0, 0.0)[:, None] * emission
    total = torch.where(did[:, None], w.total + contrib * w.atten, w.total)
    bad = w.bad | (
        did
        & (torch.isnan(total).any(dim=-1) | (total < 0).any(dim=-1))
    )

    # ---- escape: environment light (raytrace.comp:531-534)
    esc = w.alive & ~hit.did_hit
    env_l = env_ops.environment_light(scene, w.direction)
    total = torch.where(esc[:, None], total + w.atten * env_l, total)

    shaded = did & ~bad

    # ---- BSDF lobes (branchless; raytrace.comp:507-515)
    u6 = rng.uniforms(cfg.seed, w.pix, frame, sample, j, 7)
    is_spec = reflectance != 0.0
    is_diel = ~is_spec & (ior != -1.0)
    is_diff = ~is_spec & ~is_diel

    nee_origin = hp + normal * 0.01  # raytrace.comp:432
    l_dir, li, n_lights_w, l_dist = lights.sample_rect_light(
        scene, nee_origin, u6[:, 0], u6[:, 1], u6[:, 2]
    )
    cos_pdf_at_l = bsdf.cosine_hemisphere_pdf(normal, l_dir)
    cos_dir = bsdf.cosine_hemisphere_dir(normal, u6[:, 3], u6[:, 4])
    real_cos_pdf = bsdf.cosine_hemisphere_pdf(normal, cos_dir)
    rad_diff = (
        albedo
        * INV_PI
        * (dot(normal, cos_dir) / torch.clamp(real_cos_pdf, min=1e-20))[
            :, None
        ]
    )
    nee_k = albedo * (
        INV_PI * torch.clamp(dot(normal, l_dir), min=0.0)
    )[:, None]

    dir_spec = intersect.reflect(w.direction, normal)
    ior_eff = torch.where(front, 1.0 / ior, ior)
    cosine = dot(-w.direction, normal)
    sine = sqrt(torch.clamp(1.0 - cosine * cosine, min=0.0))
    solution = (ior_eff * sine > 1.0) | (
        bsdf.schlick(cosine, ior_eff) > u6[:, 5]
    )
    dir_diel = torch.where(
        solution[:, None],
        dir_spec,
        intersect.refract(w.direction, normal, ior_eff),
    )
    sign_diel = torch.where(
        solution, 1.0, torch.sign(dot(normal, w.direction))
    )
    new_dir = torch.where(
        is_spec[:, None],
        dir_spec,
        torch.where(is_diel[:, None], dir_diel, cos_dir),
    )
    sec_rad = albedo if cfg.tint_spec_diel else 1.0
    radiance = torch.where(is_diff[:, None], rad_diff, sec_rad)
    origin_sign = torch.where(is_diel, sign_diel, 1.0)
    # alpha cutout: pass-through delta bounce (see apply_material_maps)
    new_dir = torch.where(cutout[:, None], w.direction, new_dir)
    radiance = torch.where(cutout[:, None], 1.0, radiance)
    is_diff = is_diff & ~cutout
    atten = w.atten * torch.where(shaded[:, None], radiance, 1.0)

    # ---- russian roulette (raytrace.comp:519-524)
    rr = torch.clamp(atten.max(dim=-1).values, max=cfg.rr_clamp)
    rr = torch.where(j <= cfg.rr_start_bounce, 1.0, rr)
    killed = u6[:, 6] > rr
    atten = atten / torch.clamp(rr, min=1e-20)[:, None]

    continuing = shaded & ~killed & (j < cfg.bounce_limit)
    # Facing-away shadow rays contribute exactly zero, so they are
    # resolved analytically instead of traversed; ``nee_sem`` keeps
    # them in the semantic ray count.
    nee_sem = continuing & is_diff
    nee_active = nee_sem & (dot(normal, l_dir) > 0.0)

    # ---- sample completion + regeneration
    path_ends = w.alive & ~continuing
    sample_color = torch.where(bad[:, None], 0.0, total)
    acc = w.acc + torch.where(path_ends[:, None], sample_color, 0.0)
    s_new = w.s + path_ends.to(I32)
    regen = path_ends & (s_new < n_spp)

    prim = primary_rays(cam, cfg, frame, w.pix, w.sb + s_new)
    bounce_origin = hp + normal * (origin_sign * 1e-5)[:, None]
    bounce_origin = torch.where(
        cutout[:, None], hp + w.direction * 1e-4, bounce_origin
    )
    new_origin = torch.where(
        continuing[:, None],
        bounce_origin,
        torch.where(regen[:, None], prim.origin, w.origin),
    )
    new_dir = torch.where(
        continuing[:, None],
        new_dir,
        torch.where(regen[:, None], prim.direction, w.direction),
    )
    alive = continuing | regen
    j_new = torch.where(continuing, j + 1, 0).to(I32)
    total = torch.where(path_ends[:, None], 0.0, total)
    atten = torch.where(path_ends[:, None], 1.0, atten)
    bad = bad & ~path_ends

    # ---- post-NEE ``direct`` ingredients (resolved after traversal)
    fresh_direct = shaded & ~path_ends
    direct_base = torch.where(path_ends[:, None], 0.0, w.direct)

    lanes = Lanes(
        origin=new_origin, direction=new_dir, atten=atten, total=total,
        acc=acc, direct_base=direct_base, nee_origin=nee_origin, l_dir=l_dir,
        nee_k=nee_k, alive=alive, bad=bad, fresh_direct=fresh_direct,
        is_diff=is_diff, cos_pdf_at_l=cos_pdf_at_l, l_dist=l_dist,
        nee_active=nee_active, j=j_new, s=s_new, pix=w.pix, slot=w.slot,
        li=li.to(I32), sb=w.sb,
    )
    return lanes, continuing, nee_sem, n_lights_w


def pack_split(lanes: Lanes):
    """The (N, PACKED_F) f32 rows (booleans as 0.0 / 1.0) and the
    (N, PACKED_I) i32 rows of ``lanes``: the two parts of a packed row."""
    fi = lambda x: x.to(F32)[:, None]
    vec = list(lanes[:N_VEC])
    cols = [fi(x) if x.dtype == torch.bool else x[:, None]
            for x in lanes[N_VEC:N_VEC + N_COL]]
    return (torch.cat(vec + cols, dim=1),
            torch.stack(list(lanes[N_VEC + N_COL:]), dim=1))


def unpack_split(packed_f, packed_i) -> Lanes:
    """:func:`pack_split` undone: views of the rows, booleans as
    ``> 0.5``."""
    vec = [packed_f[:, 3 * k:3 * k + 3] for k in range(N_VEC)]
    cols = [packed_f[:, 3 * N_VEC + k] for k in range(N_COL)]
    cols = [c > 0.5 if k in _BOOL_COLS else c for k, c in enumerate(cols)]
    return Lanes(*vec, *cols, *packed_i.unbind(dim=1))


def pack_lanes(lanes: Lanes):
    """The (N, ROW) f32 rows of ``lanes``, the state permute's input: the
    PACKED_F f32 words of :func:`pack_split`, then its PACKED_I i32 words
    as their bits (copied, never converted)."""
    packed_f, packed_i = pack_split(lanes)
    return torch.cat([packed_f, packed_i.view(F32)], dim=1)


def unpack_lanes(packed) -> Lanes:
    """:func:`pack_lanes` undone: views of the rows, the i32 words' bits
    viewed as i32."""
    return unpack_split(packed[:, :PACKED_F],
                        packed[:, PACKED_F:ROW].view(I32))
