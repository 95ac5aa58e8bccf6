"""Wavefront path-tracing integrators: path regeneration and the static
scan.

Port of ``ray_tracer_tpu/integrator/wavefront.py``'s main path
(``trace_wave`` / ``_trace_wave_lanes``): every wavefront round shades the
pending hits of all live lanes (fat-row shade fetch, the three BSDF lobes
evaluated branchlessly, rect-light NEE, MIS resolve, russian roulette),
regenerates finished paths with their pixel's next sample, bins the lanes
by (direction octant, origin morton cell) with one stable sort and one
packed state permute, and traces the merged wavefront: closest hit for
bounce and camera rays, any-hit occlusion for the NEE shadow rays.  Both
traversals run the BVH8 kernels.  Where :func:`_fused_round_ok` holds
(the main path's configuration among others), the shading, the permute
and the NEE resolve of a round are the three CUDA kernels of
``kernels/shade.py`` (:func:`_fused_round`); elsewhere the same round
runs as torch ops (:func:`_torch_round`), the two equal bit for bit.
The per-lane shading itself is ``integrator/shading.py``.  The loop is a
Python ``while`` whose
exit test is one device-to-host read per round (the live count with the
round's ray counts, and on the rope-walk route its error flag beside
them); multi-phase drain shrinks
the state arrays as lanes retire.  While a ``torch.profiler`` runs, the
loop records its own host ranges (``utils/trace.py``): the first wave,
each round and each live-count read, with a round's width and live count,
and the ray counts of the call.  The traversal route
(group kernel, packet walk or cluster route) follows ``cfg.routing``; see
``ops/traverse.py``.

:func:`trace` is the static scan (``path_regen=False``, and every
``estimator`` ablation): one sample per lane through ``bounce_limit + 1``
masked bounces, with the debug heatmaps' counting walk under
``with_heatmap``.

Radiometric semantics are the reference package's (its module docstring
lists the reference shader's quirks this reproduces): the 0/1-NEE pending
``direct`` accounting, dropped pending NEE on escape or russian roulette,
and whole-sample zeroing on NaN or negative radiance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig, Routing
from ..kernels import lanewalk, shade
from ..ops import env as env_ops
from ..ops import intersect, traverse
from ..ops.intersect import dot, sqrt
from ..sampling import bsdf, lights, rng
from ..scene.types import CompiledScene
from ..utils.trace import mark, span
from . import shading
from .shading import (
    CameraRays,
    analytic_nee as _analytic_nee,
    apply_material_maps as _apply_material_maps,
    bin_key as _bin_key,
    octant as _octant,
    primary_rays,
    raygen,
    resolve_direct as _resolve_direct,
    shade_fetch as _shade_fetch,
)

INV_PI = bsdf.INV_PI
F32 = torch.float32
I32 = torch.int32



def _occlusion(scene, rt, o, d, active, tmax, rope_err=None,
               sort: bool = False):
    """Occlusion of the NEE shadow rays inside ``tmax``; under ``sort``
    (``nee_prebin="sort"``) traced in the order of their own bin key and
    scattered back, which changes no lane's result."""
    if not sort:
        return traverse.traverse_anyhit(scene, o, d, active, tmax=tmax,
                                        routing=rt, rope_err=rope_err)
    order = torch.argsort(_bin_key(scene, o, d, active, rt.bin_bits,
                                   rt.bin_dir_bits), stable=True)
    occ_sorted = traverse.traverse_anyhit(
        scene, o[order], d[order], active[order], tmax=tmax[order],
        routing=rt, rope_err=rope_err)
    occ = torch.empty_like(occ_sorted)
    occ[order] = occ_sorted
    return occ



def _closest_nee(scene: CompiledScene, li, l_dir, nee_hit: traverse.Hit):
    """Closest-hit NEE resolve (``nee_anyhit=False``; the JAX package's,
    its ``wavefront.py:679-690`` and ``:1351-1372``): the emission of the
    material the shadow ray hit (a sphere's, or its triangle instance's,
    ``nee_hit.obj``) and the light pdf at the hit's distance, 0 unless
    that material emits -> ``(l_emit, real_l_pdf)``.  ``nee_hit`` comes
    from a traversal with ``raw=False``."""
    is_sph = nee_hit.kind == traverse.KIND_SPHERE
    is_tri = nee_hit.kind == traverse.KIND_TRI
    nee_mat = torch.where(
        is_sph,
        scene.sphere_mat[torch.where(is_sph, nee_hit.prim, 0).long()],
        scene.obj_mat[torch.where(is_tri, nee_hit.obj, 0).long()],
    )
    nee_mat = torch.where(nee_hit.did_hit, nee_mat, 0).long()
    nee_strength = scene.mat_emission_strength[nee_mat]
    l_emit = scene.mat_emission[nee_mat] * nee_strength[:, None]
    hit_emissive = nee_hit.did_hit & (nee_strength > 0.0)
    real_l_pdf = lights.rect_light_pdf(scene, li, l_dir, nee_hit.dst,
                                       hit_emissive)
    return l_emit, real_l_pdf


def trace(scene: CompiledScene, rays: CameraRays, pixel_id, frame: int,
          sample: int, cfg: RenderConfig, with_stats: bool = False,
          with_profile: bool = False, with_heatmap: bool = False):
    """The static scan: one path-traced sample for a batch of rays -> (N,3)
    linear radiance (the JAX package's ``trace``, ``path_regen=False``).

    ``bounce_limit + 1`` bounces over every lane, dead lanes masked, in a
    Python loop where the JAX package scans.  With ``with_stats`` also the
    (2,) f32 ray counts (semantic, traced); with ``with_profile``
    ``(color, n_rays, per_bounce)``, ``per_bounce`` the occupancy counts
    ``(alive, nee_active)``, two (bounce_limit + 1,) f32 tensors stacked
    over the bounce loop; with ``with_heatmap`` also the
    per-lane ``(box_tests, tri_tests)`` over the whole path, every
    traversal through the counting walk
    (``ops/traverse.py::traverse_with_stats``) with the NEE shadow rays
    resolved by closest hit and folded into their lane.

    The ``estimator`` ablations ``"cosine"`` and ``"uniform"`` trace no
    shadow rays: every lobe defers to the next hit's emission.  Without
    the heatmap, ``nee_anyhit=True`` takes closest hit and occlusion from
    the routes of ``cfg.routing``; ``nee_anyhit=False`` traces bounce and
    shadow rays in one closest-hit launch, dead lanes moved last first
    when ``sort_bounce_rays`` (a stable two-bucket partition).
    """
    cfg.check()
    n = rays.origin.shape[0]
    dev = rays.origin.device
    f3 = lambda v: torch.full((n, 3), v, dtype=F32, device=dev)
    rt = cfg.resolved_routing()
    # occlusion NEE keeps the route's own prim space; the closest-hit
    # resolve reads every hit as a global triangle with its instance
    use_raw = cfg.nee_anyhit and not with_heatmap
    space = traverse.prim_space(scene, rt) if use_raw else "tri"
    mis = cfg.estimator == "mis"
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    if with_heatmap:
        hit, (box, tri) = traverse.traverse_with_stats(
            scene, rays.origin, rays.direction, ones)
    else:
        hit = traverse.traverse(scene, rays.origin, rays.direction, ones,
                                routing=rt, raw=use_raw)
        box = tri = None
    prof_alive, prof_nee = [], []
    origin, direction = rays.origin, rays.direction
    atten, total, direct = f3(1.0), f3(0.0), f3(0.0)
    alive = ones
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    n_rays = torch.full((2,), float(n), dtype=F32, device=dev)

    for j in range(cfg.bounce_limit + 1):
        did = alive & hit.did_hit
        (hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
         sampler, metal_tex, alpha_tex, front) = _shade_fetch(
            scene, CameraRays(origin, direction), hit, space, cfg
        )
        albedo, emission, reflectance, cutout = _apply_material_maps(
            scene, cfg, uv, sampler, albedo, emission, reflectance,
            tex_id, metal_tex, alpha_tex,
        )

        # ---- pending light resolve (raytrace.comp:500-505)
        was_delta = direct[:, 0] == -1.0
        final_light = torch.where(was_delta[:, None], emission, direct)
        contrib = final_light + emission if j == 0 else final_light
        total = torch.where(did[:, None], total + contrib * atten, total)
        bad = bad | (
            did & (torch.isnan(total).any(dim=-1) | (total < 0).any(dim=-1))
        )

        # ---- escape: environment light (raytrace.comp:531-534)
        esc = alive & ~hit.did_hit
        env_l = env_ops.environment_light(scene, direction)
        total = torch.where(esc[:, None], total + atten * env_l, total)

        shaded = did & ~bad
        alive = shaded

        # ---- BSDF lobes (branchless; raytrace.comp:507-515)
        u6 = rng.uniforms(cfg.seed, pixel_id, frame, sample, j, 7)
        is_spec = reflectance != 0.0
        is_diel = ~is_spec & (ior != -1.0)
        is_diff = ~is_spec & ~is_diel

        nee_origin = hp + normal * 0.01  # raytrace.comp:432
        l_dir, li, n_lights_w, l_dist = lights.sample_rect_light(
            scene, nee_origin, u6[:, 0], u6[:, 1], u6[:, 2]
        )
        cos_pdf_at_l = bsdf.cosine_hemisphere_pdf(normal, l_dir)
        if cfg.estimator == "uniform":
            cos_dir = bsdf.uniform_hemisphere_dir(normal, u6[:, 3], u6[:, 4])
            real_cos_pdf = torch.full((n,), 0.5 * INV_PI, dtype=F32,
                                      device=dev)
        else:
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

        dir_spec = intersect.reflect(direction, normal)
        ior_eff = torch.where(front, 1.0 / ior, ior)
        cosine = dot(-direction, normal)
        sine = sqrt(torch.clamp(1.0 - cosine * cosine, min=0.0))
        solution = (ior_eff * sine > 1.0) | (
            bsdf.schlick(cosine, ior_eff) > u6[:, 5]
        )
        dir_diel = torch.where(
            solution[:, None], dir_spec,
            intersect.refract(direction, normal, ior_eff),
        )
        sign_diel = torch.where(
            solution, 1.0, torch.sign(dot(normal, direction))
        )
        new_dir = torch.where(
            is_spec[:, None], dir_spec,
            torch.where(is_diel[:, None], dir_diel, cos_dir),
        )
        sec_rad = albedo if cfg.tint_spec_diel else 1.0
        radiance = torch.where(is_diff[:, None], rad_diff, sec_rad)
        origin_sign = torch.where(is_diel, sign_diel, 1.0)
        # alpha cutout: pass-through delta bounce (see _apply_material_maps)
        new_dir = torch.where(cutout[:, None], direction, new_dir)
        radiance = torch.where(cutout[:, None], 1.0, radiance)
        is_diff = is_diff & ~cutout
        atten = atten * torch.where(alive[:, None], radiance, 1.0)

        # ---- russian roulette (raytrace.comp:519-524)
        if j <= cfg.rr_start_bounce:
            rr = torch.ones(n, dtype=F32, device=dev)
        else:
            rr = torch.clamp(atten.max(dim=-1).values, max=cfg.rr_clamp)
        alive = alive & ~(u6[:, 6] > rr)
        atten = atten / torch.clamp(rr, min=1e-20)[:, None]
        # the last bounce's traversal results are never read
        alive = alive & (j < cfg.bounce_limit)
        nee_sem = alive & is_diff
        nee_active = nee_sem & (dot(normal, l_dir) > 0.0)
        if not mis:
            nee_active = torch.zeros_like(nee_active)
            nee_sem = torch.zeros_like(nee_sem)

        new_origin = hp + normal * (origin_sign * 1e-5)[:, None]
        new_origin = torch.where(
            cutout[:, None], hp + direction * 1e-4, new_origin
        )
        new_origin = torch.where(alive[:, None], new_origin, origin)
        new_dir = torch.where(alive[:, None], new_dir, direction)

        if (use_raw and scene.n_lights == 0) or (not mis
                                                and not with_heatmap):
            # no shadow launch: NEE cannot contribute (no rect lights) or
            # the estimator takes none
            hit = traverse.traverse(scene, new_origin, new_dir, alive,
                                    routing=rt, raw=use_raw)
            nee_active = torch.zeros_like(nee_active)
            nee_sem = torch.zeros_like(nee_sem)
            l_emit = f3(0.0)
            real_l_pdf = torch.zeros(n, dtype=F32, device=dev)
        elif use_raw:
            # closest-hit bounce rays + any-hit shadow rays; the light pdf
            # is analytic at the sampled distance
            hit = traverse.traverse(scene, new_origin, new_dir, alive,
                                    routing=rt)
            occluded = _occlusion(scene, rt, nee_origin, l_dir, nee_active,
                                  l_dist * (1.0 - 1e-3))
            l_emit, real_l_pdf = _analytic_nee(scene, li, l_dir, l_dist,
                                               nee_active & ~occluded)
        else:
            # one closest-hit launch: bounce rays ++ shadow rays, the
            # shadow rays clipped just past the sampled light point
            hit, nee_hit, counts = _combined_closest(
                scene, cfg, rt, new_origin, new_dir, alive, nee_origin,
                l_dir, nee_active, l_dist * 1.002 + 1e-3, with_heatmap)
            if with_heatmap:
                box, tri = box + counts[0], tri + counts[1]
            l_emit, real_l_pdf = _closest_nee(scene, li, l_dir, nee_hit)

        real_l_pdf = real_l_pdf / n_lights_w  # uniform light pick
        w1 = real_l_pdf**2 / (real_l_pdf**2 + cos_pdf_at_l**2)
        w1 = torch.where(torch.isnan(w1), 0.0, w1)
        # sign-preserving: a back-side sample's negative pdf trips the
        # bad-sample zeroing (raytrace.comp:460,505)
        direct_diff = l_emit * nee_k * torch.where(
            real_l_pdf == 0.0, 0.0, w1 / real_l_pdf
        )[:, None]
        if mis:
            new_direct = torch.where(is_diff[:, None], direct_diff, -1.0)
        else:
            new_direct = f3(-1.0)
        direct = torch.where(shaded[:, None], new_direct, direct)

        n_alive = alive.sum().to(F32)
        n_nee_act = nee_active.sum().to(F32)
        n_rays = n_rays + torch.stack([
            n_alive + nee_sem.sum().to(F32),
            n_alive + n_nee_act,
        ])
        if with_profile:
            prof_alive.append(n_alive)
            prof_nee.append(n_nee_act)
        origin, direction = new_origin, new_dir

    color = torch.where(bad[:, None], 0.0, total)
    if with_heatmap:
        return color, (box, tri)
    if with_profile:
        return color, n_rays, (torch.stack(prof_alive),
                               torch.stack(prof_nee))
    if with_stats:
        return color, n_rays
    return color


def _combined_closest(scene, cfg, rt, o, d, alive, nee_o, nee_d,
                      nee_active, nee_tmax, with_heatmap):
    """Closest hit of the bounce rays and the shadow rays in one launch,
    triangles as global ids with their instance (``raw=False``):
    ``(hit, nee_hit, counts)``, ``counts`` the shadow-lane-folded
    ``(box_tests, tri_tests)`` of the counting walk with the heatmap,
    else None."""
    n = o.shape[0]
    o_both = torch.cat([o, nee_o])
    d_both = torch.cat([d, nee_d])
    a_both = torch.cat([alive, nee_active])
    t_both = torch.cat([torch.full((n,), intersect.BIG, dtype=F32,
                                   device=o.device), nee_tmax])
    counts = None
    if with_heatmap:
        both, (sb, st) = traverse.traverse_with_stats(
            scene, o_both, d_both, a_both, tmax=t_both)
        counts = (sb[:n] + sb[n:], st[:n] + st[n:])
    elif cfg.sort_bounce_rays:
        # alive-first: a stable two-bucket partition, undone after
        alive_i = a_both.to(torch.int64)
        n_alive = alive_i.sum()
        dest = torch.where(a_both, torch.cumsum(alive_i, 0) - 1,
                           n_alive + torch.cumsum(1 - alive_i, 0) - 1)
        order = torch.empty_like(dest)
        order[dest] = torch.arange(dest.shape[0], device=dest.device)
        both = traverse.traverse(
            scene, o_both[order], d_both[order], a_both[order],
            tmax=t_both[order], routing=rt, raw=False)
        both = traverse.Hit(*(x[dest] for x in both))
    else:
        both = traverse.traverse(scene, o_both, d_both, a_both, tmax=t_both,
                                 routing=rt, raw=False)
    hit = traverse.Hit(*(x[:n] for x in both))
    nee_hit = traverse.Hit(*(x[n:] for x in both))
    return hit, nee_hit, counts


def render_sample(scene: CompiledScene, rot, pos, fov, aspect, near,
                  pixel_id, frame: int, sample: int, cfg: RenderConfig):
    """One path-traced sample per listed pixel through the static scan ->
    (N,3)."""
    jitter = None
    if cfg.aa_jitter:
        jitter = rng.uniforms(cfg.seed ^ 0xA11A5, pixel_id, frame, sample,
                              999, 2) - 0.5
    rays = raygen(rot, pos, fov, aspect, near, pixel_id, cfg.width,
                  cfg.height, jitter)
    return trace(scene, rays, pixel_id, frame, sample, cfg)



def _bin_order(scene, rt, origin, direction, alive, continuing,
               hit: traverse.Hit, pix):
    """``(order, runs)``: the lanes' order after a round's binning (dead
    lanes last), by ``rt.bin_mode``, and in the ``"morton"`` mode the
    runs of equal keys among the live lanes (``shading.key_runs``; None
    in the others): ``"morton"`` sorts by :func:`_bin_key`; ``"leaf"``
    keys continuing lanes by (octant, previous-hit primitive; spheres
    after the triangles) and regenerated camera lanes by pixel id;
    ``"hier"`` keeps the morton order and sorts the lanes inside each key
    by that primitive or pixel (two stable argsorts).  Each is a pure
    re-permutation (the JAX package's ``wavefront.py:1213-1268``)."""
    if rt.bin_mode == "morton":
        skey, order = torch.sort(_bin_key(scene, origin, direction, alive,
                                          rt.bin_bits, rt.bin_dir_bits),
                                 stable=True)
        return order, shading.key_runs(skey)
    pk = torch.clamp(hit.prim, 0, (1 << 24) - 1)
    pk = torch.where(hit.kind == traverse.KIND_SPHERE, (1 << 24) - 64 + pk,
                     pk)
    pix = pix.to(I32)
    if rt.bin_mode == "leaf":
        key = torch.where(continuing, (_octant(direction) << 24) | pk,
                          (1 << 29) | pix)
        key = torch.where(alive, key, shading.DEAD_KEY)
        return torch.argsort(key, stable=True), None
    key = _bin_key(scene, origin, direction, alive, rt.bin_bits,
                   rt.bin_dir_bits)
    order = torch.argsort(torch.where(continuing, pk, pix), stable=True)
    return order[torch.argsort(key[order], stable=True)], None


def _lane_groups(n_lanes: int, n_spp: int, cfg: RenderConfig) -> int:
    """Sample-split factor g for the spp-lane population mode: each pixel's
    ``n_spp`` samples are split across g lanes so the binnable population
    grows g-fold.  Prefers g = n_spp; otherwise the largest divisor of
    n_spp that keeps the lanes within ``cfg.lane_pool`` (0 = 1 << 23)."""
    pool = cfg.lane_pool if cfg.lane_pool else (1 << 23)
    cap = max(1, pool // max(n_lanes, 1))
    if cap >= n_spp:
        return n_spp
    for d in range(cap, 1, -1):
        if n_spp % d == 0:
            return d
    return 1


def trace_wave(scene: CompiledScene, rot, pos, fov, aspect, near,
               pixel_id, frame: int, sample_base: int, n_spp: int,
               cfg: RenderConfig, with_stats: bool = False):
    """All ``n_spp`` samples of each pixel -> per-pixel color SUM (N,3),
    plus the (semantic, traced) ray counts when ``with_stats``.

    Expands to ``g = _lane_groups(...)`` lanes per pixel (each owning a
    contiguous run of sample indices) and folds the g per-group sums back
    per pixel in ascending order.
    """
    cfg.check()
    n = pixel_id.shape[0]
    g = _lane_groups(n, n_spp, cfg)
    if g <= 1:
        return _trace_wave_lanes(
            scene, rot, pos, fov, aspect, near, pixel_id, frame,
            torch.full_like(pixel_id, sample_base, dtype=I32), n_spp, cfg,
            with_stats,
        )
    per = n_spp // g
    pix_g = torch.cat([pixel_id.to(I32)] * g)
    base_g = torch.cat(
        [torch.full_like(pixel_id, sample_base + k * per, dtype=I32)
         for k in range(g)]
    )
    out = _trace_wave_lanes(
        scene, rot, pos, fov, aspect, near, pix_g, frame, base_g, per, cfg,
        with_stats,
    )
    lanes = out[0] if with_stats else out
    acc = lanes[:n]
    for k in range(1, g):  # ordered left fold = sequential sample order
        acc = acc + lanes[k * n:(k + 1) * n]
    return (acc, out[1]) if with_stats else acc


class Wave(NamedTuple):
    origin: torch.Tensor  # (N,3) ray of the PENDING hit
    direction: torch.Tensor
    hit: traverse.Hit
    atten: torch.Tensor
    total: torch.Tensor
    direct: torch.Tensor
    bad: torch.Tensor
    alive: torch.Tensor  # (N,) lane has a pending hit to shade
    j: torch.Tensor  # (N,) i32 bounce index of the pending hit
    s: torch.Tensor  # (N,) i32 sample index (== n_spp -> retired)
    sb: torch.Tensor  # (N,) i32 per-lane sample-index base
    acc: torch.Tensor  # (N,3) banked color sum of completed samples
    pix: torch.Tensor  # (N,) i32 pixel id
    slot: torch.Tensor  # (N,) i32 original lane (output position)
    n_rays: torch.Tensor  # (2,) i64: semantic, traced
    n_alive: torch.Tensor  # () i64: the count of ``alive``
    # (4,) i64 that ``n_rays`` and ``n_alive`` view, where a round wrote
    # them as one buffer, with the runs of equal bin keys among the live
    # lanes after the round's sort (0 where its bins were no morton key's),
    # and where textures are in use (``shading.maps_on``) a fifth word, the
    # lanes the round's alpha maps cut out; the first wave has none
    tally: Optional[torch.Tensor] = None


_PER_WAVE = ("n_rays", "n_alive", "tally")


def _slice_wave(w: Wave, m: int) -> Wave:
    """The first ``m`` lanes of every per-lane field."""
    return Wave(*(
        x if name in _PER_WAVE
        else traverse.Hit(*(h[:m] for h in x)) if name == "hit"
        else x[:m]
        for name, x in zip(Wave._fields, w)
    ))


def _fused_round_ok(scene: CompiledScene, cfg: RenderConfig,
                    rt: Routing) -> bool:
    """Does a wavefront round run the round kernels of
    ``kernels/shade.py`` (:func:`_fused_round`)?  Decided by the
    configuration alone, before any launch, on any scene (flattened,
    forest or without meshes; triangles and/or spheres, any number of rect
    lights, the analytic sky; albedo, metalness and alpha maps and, with
    ``enable_normal_maps``, a flattened scene's bump maps, through the
    shade kernel's maps instance): binned by the morton key (``bin_rays``
    on, ``bin_mode="morton"``; a mesh-free scene's key is its octant),
    with occlusion NEE traced after the permute
    (``nee_anyhit=True``, ``nee_prebin="off"``), on any traversal route.

    Every other configuration runs the torch round (:func:`_torch_round`):
    ``nee_prebin``, ``leaf``/``hier`` bins, ``nee_anyhit=False`` and
    ``bin_rays=False``; the static scan (:func:`trace`) is another
    integrator.  This is a route, not a fallback: a kernel that fails to
    build or launch raises."""
    return (cfg.bin_rays is not False and rt.bin_mode == "morton"
            and rt.nee_prebin == "off" and cfg.nee_anyhit)


def _first_wave(c: shade.Round, pixel_id, sample_base, rope_err=None):
    """The wave before the first round: every lane's camera ray at its
    first sample, traversed."""
    n = pixel_id.shape[0]
    dev = pixel_id.device
    pix0 = pixel_id.to(I32)
    s0 = torch.zeros(n, dtype=I32, device=dev)
    sb0 = sample_base.to(I32)
    rays0 = primary_rays(c.cam, c.cfg, c.frame, pix0, sb0 + s0)
    hit0 = traverse.traverse(
        c.scene, rays0.origin, rays0.direction,
        torch.ones(n, dtype=torch.bool, device=dev), routing=c.rt,
        rope_err=rope_err, raw=c.cfg.nee_anyhit,
    )
    f3 = lambda v: torch.full((n, 3), v, dtype=F32, device=dev)
    return Wave(
        origin=rays0.origin.contiguous(), direction=rays0.direction,
        hit=hit0, atten=f3(1.0), total=f3(0.0), direct=f3(0.0),
        bad=torch.zeros(n, dtype=torch.bool, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        j=torch.zeros(n, dtype=I32, device=dev), s=s0, sb=sb0, acc=f3(0.0),
        pix=pix0, slot=torch.arange(n, dtype=I32, device=dev),
        n_rays=torch.full((2,), n, dtype=torch.int64, device=dev),
        n_alive=torch.full((), n, dtype=torch.int64, device=dev),
    )


def _gather_lanes(lanes: shading.Lanes, order) -> shading.Lanes:
    """The torch round's state permute: the lane state gathered by
    ``order`` with torch's own indexing, as two arrays of rows, f32 and
    i32 (``shading.pack_split``).  Gathering the 40-word rows of
    ``shading.pack_lanes`` instead is slower in torch: 12.55 ms at round 0
    of the benchmark frame against 10.27, 11.20 with the rows 4 bytes
    past a 16-byte boundary (NVIDIA H100 80GB HBM3, 700 W;
    ``tools/measure_permute.py``)."""
    packed_f, packed_i = shading.pack_split(lanes)
    return shading.unpack_split(packed_f[order], packed_i[order])


def _torch_round(c: shade.Round, w: Wave, rope_err=None) -> Wave:
    """One wavefront round in torch ops: shade (``shading.shade_lanes``),
    bin and permute the lane state, traverse the merged wavefront (bounce
    ++ regenerated primary rays) and resolve NEE.

    ``bin_rays=False`` keeps the lanes in place.  ``nee_anyhit=False``
    resolves NEE by a closest-hit query after the round's traversal, every
    hit a global triangle with its instance (``raw=False``, ``shade_tri``
    rows); with occlusion NEE, ``routing.nee_prebin`` moves the shadow
    query and the MIS resolve before the state permute.
    """
    scene, cfg, rt = c.scene, c.cfg, c.rt
    dev = w.alive.device
    do_bin = cfg.bin_rays is not False
    use_raw = cfg.nee_anyhit
    prebin = use_raw and rt.nee_prebin != "off"

    lanes, continuing, nee_sem, n_lights_w, cut = shading.shade_lanes(
        scene, cfg, c.space, w, c.frame, c.n_spp, c.cam)
    if use_raw and scene.n_lights == 0:
        n_nee = torch.zeros(2, dtype=torch.int64, device=dev)
    else:
        n_nee = torch.stack([nee_sem.sum(), lanes.nee_active.sum()])
    (new_origin, new_dir, atten, total, acc, direct_base, nee_origin, l_dir,
     nee_k, alive, bad, fresh_direct, is_diff, cos_pdf_at_l, l_dist,
     nee_active, j_cur, s_cur, pix, slot, li, sb_cur) = lanes

    if prebin:
        # ---- pre-permute NEE: the shadow query and the MIS resolve
        # run here, so the permute carries the resolved ``direct``
        if scene.n_lights == 0:
            l_emit = torch.zeros_like(nee_k)
            real_l_pdf = torch.zeros_like(l_dist)
        else:
            occluded = _occlusion(
                scene, rt, nee_origin, l_dir, nee_active,
                l_dist * (1.0 - 1e-3), rope_err,
                sort=do_bin and rt.nee_prebin == "sort")
            l_emit, real_l_pdf = _analytic_nee(
                scene, li, l_dir, l_dist, nee_active & ~occluded)
        direct = _resolve_direct(
            real_l_pdf, n_lights_w, cos_pdf_at_l, l_emit, nee_k,
            is_diff, fresh_direct, direct_base,
        )

    runs = None  # the key runs, counted where the bins are morton keys
    if do_bin:
        # ---- coherence binning: one permutation of the lanes by
        # their bin key and one packed row-gather per dtype move the
        # whole lane state; per-lane results are permutation-invariant.
        order, runs = _bin_order(scene, rt, new_origin, new_dir, alive,
                                 continuing, w.hit, w.pix)
        if prebin:
            # the slim pack: NEE is resolved into ``direct`` already
            fi = lambda x: x.to(F32)[:, None]
            packed = torch.cat(
                [new_origin, new_dir, atten, total, acc, direct,
                 fi(alive), fi(bad)], dim=1)[order]
            packed_i = torch.stack(
                [j_cur, s_cur, pix, slot, sb_cur], dim=1)[order]
            v3 = lambda k: packed[:, 3 * k : 3 * k + 3]
            (new_origin, new_dir, atten, total, acc, direct) = (
                v3(k) for k in range(6))
            alive = packed[:, 18] > 0.5
            bad = packed[:, 19] > 0.5
            j_cur, s_cur, pix, slot, sb_cur = packed_i.unbind(dim=1)
        else:
            (new_origin, new_dir, atten, total, acc, direct_base,
             nee_origin, l_dir, nee_k, alive, bad, fresh_direct, is_diff,
             cos_pdf_at_l, l_dist, nee_active, j_cur, s_cur, pix, slot, li,
             sb_cur) = _gather_lanes(lanes, order)

    # ---- traverse the merged wavefront (bounce ++ regenerated primary)
    hit_next = traverse.traverse(scene, new_origin, new_dir, alive,
                                 routing=rt, rope_err=rope_err,
                                 raw=use_raw)

    # ---- NEE shadow query for continuing diffuse lanes
    if prebin:
        pass  # resolved into ``direct`` before the permute
    elif use_raw:
        if scene.n_lights == 0:
            l_emit = torch.zeros_like(nee_k)
            real_l_pdf = torch.zeros_like(l_dist)
        else:
            occluded = _occlusion(scene, rt, nee_origin, l_dir,
                                  nee_active, l_dist * (1.0 - 1e-3),
                                  rope_err)
            l_emit, real_l_pdf = _analytic_nee(
                scene, li, l_dir, l_dist, nee_active & ~occluded)
    else:
        nee_hit = traverse.traverse(
            scene, nee_origin, l_dir, nee_active,
            tmax=l_dist * 1.002 + 1e-3, routing=rt, rope_err=rope_err,
            raw=False)
        l_emit, real_l_pdf = _closest_nee(scene, li.long(), l_dir,
                                          nee_hit)
    if not prebin:
        direct = _resolve_direct(
            real_l_pdf, n_lights_w, cos_pdf_at_l, l_emit, nee_k,
            is_diff, fresh_direct, direct_base,
        )

    n_alive = alive.sum()
    if runs is None:
        runs = torch.zeros_like(n_alive)
    words = [w.n_rays + n_alive + n_nee, n_alive.view(1), runs.view(1)]
    if cut is not None:
        words.append(cut.sum().view(1))
    tally = torch.cat(words)
    return Wave(
        origin=new_origin, direction=new_dir, hit=hit_next, atten=atten,
        total=total, direct=direct, bad=bad, alive=alive, j=j_cur,
        s=s_cur, sb=sb_cur, acc=acc, pix=pix, slot=slot,
        n_rays=tally[:2], n_alive=tally[2], tally=tally,
    )


def _fused_round(c: shade.Round, w: Wave, rope_err=None) -> Wave:
    """One wavefront round through the round kernels (where
    :func:`_fused_round_ok`): the shade kernel writes every lane's next
    state as packed rows, its bin key and the round's ray counts; a stable
    sort orders the keys; the permute kernel gathers the rows into the
    next wave's columns and counts the sorted keys' runs into the tally;
    the traversals run as in the torch round; the NEE kernel resolves
    ``direct``.  The same values as :func:`_torch_round`, bit for bit, on
    every device."""
    scene = c.scene
    packed, key, tally = shade.shade_round(c, w)
    skey, order = torch.sort(key, stable=True)
    lanes = shade.permute_rows(packed, order, skey, tally[3:4])
    hit = traverse.traverse(scene, lanes.origin, lanes.direction,
                            lanes.alive, routing=c.rt, rope_err=rope_err)
    occluded = None
    if scene.n_lights:
        occluded = _occlusion(scene, c.rt, lanes.nee_origin, lanes.l_dir,
                              lanes.nee_active,
                              lanes.l_dist * (1.0 - 1e-3), rope_err)
    direct = shade.nee_resolve(scene, lanes, occluded)
    return Wave(
        origin=lanes.origin, direction=lanes.direction, hit=hit,
        atten=lanes.atten, total=lanes.total, direct=direct, bad=lanes.bad,
        alive=lanes.alive, j=lanes.j, s=lanes.s, sb=lanes.sb, acc=lanes.acc,
        pix=lanes.pix, slot=lanes.slot, n_rays=tally[:2], n_alive=tally[2],
        tally=tally,
    )


def _round_context(scene, rot, pos, fov, aspect, near, frame: int,
                   n_spp: int, cfg: RenderConfig):
    """``(c, round_)``: the context every round of one wavefront call
    reads, and the round function its configuration takes."""
    rt = cfg.resolved_routing()
    fused = _fused_round_ok(scene, cfg, rt)
    space = traverse.prim_space(scene, rt) if cfg.nee_anyhit else "tri"
    cam = (rot, pos, fov, aspect, near)
    c = shade.Round(scene, cfg, rt, space, cam, frame, n_spp,
                    shade.frame_constants(scene, cam) if fused else None,
                    shade.srgb_table(rot.device)
                    if fused and shade.maps_on(scene, cfg) else None)
    return c, _fused_round if fused else _torch_round


def _trace_wave_lanes(scene, rot, pos, fov, aspect, near, pixel_id,
                      frame: int, sample_base, n_spp: int, cfg: RenderConfig,
                      with_stats: bool = False):
    """All ``n_spp`` samples of each lane's pixel, with path regeneration,
    coherence binning and multi-phase drain -> color sums (N,3).

    Each round is :func:`_fused_round` where :func:`_fused_round_ok`, else
    :func:`_torch_round`.  ``bin_rays=False`` runs the rounds at full
    width in lane order (no key, no permute, no drain).
    """
    n = pixel_id.shape[0]
    dev = pixel_id.device
    c, round_ = _round_context(scene, rot, pos, fov, aspect, near, frame,
                               n_spp, cfg)

    # the rope walk's error flag, read with each round's live count
    rope_err = traverse.rope_error_flag(scene, c.rt, dev)
    # a round's counts land in pinned memory, as ``int`` takes the first
    # wave's: one device-to-host copy a read either way
    host = torch.empty(5, dtype=torch.int64, pin_memory=dev.type == "cuda")
    rays = (n, n)  # the ray counts the last read took: the first wave's
    runs = 0  # the key runs it took: none before the first sort
    cut = None  # the cutout lanes it took, where the round counted them

    def n_live(w: Wave) -> int:
        """Live lanes: one device-to-host copy per round, of the count and,
        on the rope-walk route, its error flag beside it; the ray counts
        ride in the same copy wherever a round wrote them beside the count,
        and in the rope walk's; the key runs and the cutouts wherever a
        round wrote them."""
        nonlocal rays, runs, cut
        with span("rt.live_read"):
            if rope_err is not None:
                *rays, count, err = torch.cat([w.n_rays, w.n_alive.view(1),
                                               rope_err.long()]).tolist()
                lanewalk.raise_on_flag(err, scene.meta["rope_rows"])
                return count
            if w.tally is None:
                return int(w.n_alive)
            words = host[:w.tally.shape[0]].copy_(w.tally).tolist()
            rays, count, runs = words[:2], words[2], words[3]
            cut = words[4] if len(words) > 4 else None
            return count

    def round_span(width: int, live: int):
        """The round's range: its width, the live count and, where the
        read before it took them, the key runs of the lanes it shades and
        the cutout lanes of the round before it."""
        if cut is not None:
            if runs:
                return span("rt.round lanes=%d live=%d runs=%d cut=%d",
                            width, live, runs, cut)
            return span("rt.round lanes=%d live=%d cut=%d", width, live, cut)
        if runs:
            return span("rt.round lanes=%d live=%d runs=%d", width, live,
                        runs)
        return span("rt.round lanes=%d live=%d", width, live)

    with span("rt.first_wave lanes=%d", n):
        w = _first_wave(c, pixel_id, sample_base, rope_err)

    if cfg.bin_rays is False:
        # one loop at full width: the lanes never move, so lane i is
        # pixel_id[i] throughout
        while (live := n_live(w)) > 0:
            with round_span(n, live):
                w = round_(c, w, rope_err)
        mark("rt.rays samples=%d sem=%d traced=%d", n * n_spp, *rays)
        return (w.acc, w.n_rays) if with_stats else w.acc

    # ---- multi-phase drain: the bin key sorts dead lanes last, so once
    # the alive count fits the next width the live lanes form a prefix;
    # the retired suffix is banked and the state arrays shrink by ``div``.
    div = cfg.drain_div if cfg.drain_div else 4
    widths = [n]
    while widths[-1] % div == 0 and widths[-1] // div >= 8192:
        widths.append(widths[-1] // div)

    banked_acc, banked_slot = [], []
    for i in range(len(widths)):
        nxt = widths[i + 1] if i + 1 < len(widths) else 0
        # inline, not a helper: a helper's argument would hold the width's
        # first wave alive through all its rounds
        while (live := n_live(w)) > nxt:
            with round_span(widths[i], live):
                w = round_(c, w, rope_err)
        if nxt:
            banked_acc.append(w.acc[nxt:])
            banked_slot.append(w.slot[nxt:])
            w = _slice_wave(w, nxt)
    mark("rt.rays samples=%d sem=%d traced=%d", n * n_spp, *rays)
    banked_acc.append(w.acc)
    banked_slot.append(w.slot)
    acc = torch.zeros((n, 3), dtype=F32, device=dev)
    acc[torch.cat(banked_slot).long()] = torch.cat(banked_acc)
    if with_stats:
        return acc, w.n_rays
    return acc
