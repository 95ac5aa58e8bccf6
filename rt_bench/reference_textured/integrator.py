"""The textured reference path tracer: the default reference's
(``rt_bench/reference/integrator.py``: camera, sky, lobes, NEE with MIS,
roulette, blend, the reference renderer's order), with what a textured
scene adds at each hit, in the program's order:

- the UV at the hit: the corners' UVs interpolated by the barycentrics
  the shading point re-derives, 0.5 where two corners share a UV;
- the bump map: the tangent frame solved from the triangle's edges and
  UV deltas, made orthonormal against the shading normal, and the normal
  tilted by ``bump_scale`` (1 unless the render constants say) times the
  height gradient, three taps one texel apart in u and in v;
- the albedo map: the material's albedo times the map;
- the alpha map: a hit whose alpha is below 0.5 is cut out.  The path
  passes straight through: its direction kept, its origin moved 1e-4
  along it, the hit's emission zeroed, its throughput unchanged, no
  shadow ray from it, and a delta bounce for the pending light resolve
  (the next hit's emission counts whole).  It spends a bounce of the
  limit and plays roulette like any other.  Shadow rays ignore alpha: a
  cut-out triangle still blocks them.

Every map is fetched as the program fetches it: the UV wrapped to [0, 1),
v flipped, bilinear over the four texels around ``(u * w - 0.5, (1 - v) *
h - 0.5)`` (each tap clamped to the map's edge), each texel's sRGB byte
decoded to linear first.

Departures from the reference renderer (``raytrace.comp``, SURVEY Q1 and
Q8): its shader binds the maps and interpolates the UVs but samples no
map, and its bump frame is never computed, so it renders every textured
scene flat; this reference, like the program, samples them.  The bump and
alpha maps are the scene's, so they apply whatever the render constants'
``enable_normal_maps`` says.  The scene's maps are generated
(``rt_bench/scenes/sponza_textured.py``).
"""

from __future__ import annotations

import torch

from ..reference import rng
from ..reference.integrator import (INV_PI, PATHS, camera_rays, cosine_dir,
                                    cosine_pdf, norm, sky)
from ..reference.trace import closest, cross, dot, occluded
from .scene import TexturedRefScene


def srgb_to_linear(texels):
    srgb = texels.to(torch.float32) / 255.0
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)


def fetch(rs: TexturedRefScene, which, uv):
    """Bilinear taps of map ``which`` (N,) at ``uv`` (N,2) -> (N,3) linear
    values (in ``uv``'s dtype)."""
    tid = torch.clamp(which, min=0)
    size = rs.tex_size[tid]
    hw = size.to(uv.dtype)
    h, w = hw[:, 0], hw[:, 1]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    fx = u * w - 0.5
    fy = (1.0 - v) * h - 0.5
    # the last texel, in integers: exact in any dtype of the UVs
    x_max = (size[:, 1] - 1).to(torch.int32)
    y_max = (size[:, 0] - 1).to(torch.int32)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]

    def texel(ix, iy):
        iy = torch.minimum(torch.clamp(iy, min=0), y_max).long()
        ix = torch.minimum(torch.clamp(ix, min=0), x_max).long()
        return srgb_to_linear(rs.texels[tid, iy, ix]).to(uv.dtype)

    c00, c10 = texel(x0, y0), texel(x0 + 1, y0)
    c01, c11 = texel(x0, y0 + 1), texel(x0 + 1, y0 + 1)
    return (c00 * (1 - ax) * (1 - ay) + c10 * ax * (1 - ay)
            + c01 * (1 - ax) * ay + c11 * ax * ay)


def bump(rs: TexturedRefScene, k, uv, normal, is_tri, scale):
    """The shading normal tilted by the bump map of triangle ``k``."""
    which = rs.bump_map[k]
    e1, e2 = rs.e1[k], rs.e2[k]
    c = rs.uv[k]
    duv1 = c[:, 1] - c[:, 0]
    duv2 = c[:, 2] - c[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    t_vec = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    b_vec = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv[:, None]
    t_vec = t_vec - normal * dot(t_vec, normal)[:, None]
    t_hat = t_vec / torch.clamp(norm(t_vec, keepdim=True), min=1e-20)
    b_vec = (b_vec - normal * dot(b_vec, normal)[:, None]
             - t_hat * dot(b_vec, t_hat)[:, None])
    b_hat = b_vec / torch.clamp(norm(b_vec, keepdim=True), min=1e-20)
    hw = rs.tex_size[torch.clamp(which, min=0)].to(uv.dtype)
    step_u = 1.0 / torch.clamp(hw[:, 1], min=2.0)
    step_v = 1.0 / torch.clamp(hw[:, 0], min=2.0)
    zeros = torch.zeros_like(step_u)
    h0 = fetch(rs, which, uv)[:, 0]
    h_u = fetch(rs, which, uv + torch.stack([step_u, zeros], 1))[:, 0]
    h_v = fetch(rs, which, uv + torch.stack([zeros, step_v], 1))[:, 0]
    pert = normal - scale * ((h_u - h0)[:, None] * t_hat
                             + (h_v - h0)[:, None] * b_hat)
    pert = pert / torch.clamp(norm(pert, keepdim=True), min=1e-20)
    use = is_tri & (which >= 0) & ok
    return torch.where(use[:, None], pert, normal)


def shade_point(rs: TexturedRefScene, o, d, t, tri, scale):
    """The default reference's shading point, bump-mapped, with the albedo
    and alpha maps applied -> (hit point, unit shading normal, albedo,
    emission, cutout)."""
    is_tri = tri >= 0
    k = torch.where(is_tri, tri, 0)
    hp = o + d * t[:, None]
    v0, e1, e2, n = rs.v0[k], rs.e1[k], rs.e2[k], rs.n_geo[k]
    d_eps = torch.where(d == 0.0, torch.full_like(d, 1e-20), d)
    q = cross(o - v0, d_eps)
    d0 = -dot(d_eps, n)
    dinv = 1.0 / torch.where(d0 == 0.0, torch.full_like(d0, 1e-20), d0)
    zero = torch.zeros_like(d0)
    hu = torch.where(is_tri, dot(e2, q) * dinv, zero)
    hv = torch.where(is_tri, -dot(e1, q) * dinv, zero)
    front = d0 >= 1e-8
    w = 1.0 - hu - hv
    vn = rs.vn[k]
    nrm = vn[:, 0] * w[:, None] + vn[:, 1] * hu[:, None] + vn[:, 2] * hv[:, None]
    nrm = nrm * torch.where(front, 1.0, -1.0).to(d.dtype)[:, None]
    normal = nrm / torch.clamp(norm(nrm, keepdim=True), min=1e-20)
    c = rs.uv[k]
    uv = c[:, 0] * w[:, None] + c[:, 1] * hu[:, None] + c[:, 2] * hv[:, None]
    uv = torch.where(rs.uv_flat[k][:, None], 0.5, uv)
    normal = bump(rs, k, uv, normal, is_tri, scale)
    albedo, emission = rs.albedo[k], rs.emission[k]
    tex = rs.albedo_map[k]
    albedo = torch.where((tex >= 0)[:, None], albedo * fetch(rs, tex, uv),
                         albedo)
    alpha = rs.alpha_map[k]
    cutout = (alpha >= 0) & (fetch(rs, alpha, uv)[:, 0] < 0.5)
    emission = torch.where(cutout[:, None], 0.0, emission)
    return hp, normal, albedo, emission, cutout


def radiance(rs: TexturedRefScene, cfg: dict, o, d, pix, frame, sample,
             first, colour=None):
    """One sample's radiance for each path -> (N,3) in ``colour``, as the
    default reference's ``radiance`` with the maps (the module's
    docstring)."""
    n = o.shape[0]
    dt = rs.dtype
    ct = colour or dt
    dev = o.device
    f3 = lambda v: torch.full((n, 3), v, dtype=ct, device=dev)
    light = rs.light
    scale = cfg.get("bump_scale", 1.0)
    t, tri = first
    atten, total, direct = f3(1.0), f3(0.0), f3(0.0)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(cfg["bounce_limit"] + 1):
        did = alive & (tri >= 0)
        hp, normal, albedo, emission, cutout = shade_point(rs, o, d, t, tri,
                                                           scale)
        albedo, emission = albedo.to(ct), emission.to(ct)

        was_delta = direct[:, 0] == -1.0
        final_light = torch.where(was_delta[:, None], emission, direct)
        contrib = final_light + emission if j == 0 else final_light
        total = torch.where(did[:, None], total + contrib * atten, total)
        bad = bad | (did & (torch.isnan(total).any(dim=-1)
                            | (total < 0).any(dim=-1)))
        esc = alive & ~(tri >= 0)
        total = torch.where(esc[:, None],
                            total + atten * sky(rs.env, d).to(ct), total)
        shaded = did & ~bad
        alive = shaded

        u = rng.uniforms(cfg["seed"], pix, frame, sample, j, 7).to(dt)
        nee_o = hp + normal * 0.01
        point = light["corner"] + light["edge_u"] * u[:, 1:2] \
            + light["edge_v"] * u[:, 2:3]
        vec = point - nee_o
        l_dist = norm(vec)
        l_dir = vec / torch.clamp(l_dist, min=1e-20)[:, None]
        cos_pdf_at_l = cosine_pdf(normal, l_dir)
        new_dir = cosine_dir(normal, u[:, 3], u[:, 4])
        real_cos_pdf = cosine_pdf(normal, new_dir)
        rad = albedo * INV_PI * (dot(normal, new_dir) / torch.clamp(
            real_cos_pdf, min=1e-20)).to(ct)[:, None]
        nee_k = albedo * (INV_PI * torch.clamp(dot(normal, l_dir),
                                               min=0.0)).to(ct)[:, None]
        # a cutout: straight on, throughput kept
        new_dir = torch.where(cutout[:, None], d, new_dir)
        rad = torch.where(cutout[:, None], 1.0, rad)
        atten = atten * torch.where(alive[:, None], rad, 1.0)

        if j <= cfg["rr_start_bounce"]:
            rr = torch.ones(n, dtype=ct, device=dev)
        else:
            rr = torch.clamp(atten.max(dim=-1).values, max=cfg["rr_clamp"])
        alive = alive & ~(u[:, 6] > rr)
        atten = atten / torch.clamp(rr, min=1e-20)[:, None]
        alive = alive & (j < cfg["bounce_limit"])
        nee_on = alive & ~cutout & (dot(normal, l_dir) > 0.0)

        sign = torch.ones(n, dtype=dt, device=dev)
        new_o = hp + normal * (sign * 1e-5)[:, None]
        new_o = torch.where(cutout[:, None], hp + d * 1e-4, new_o)
        new_o = torch.where(alive[:, None], new_o, o)
        new_dir = torch.where(alive[:, None], new_dir, d)
        t, tri = closest(rs, new_o, new_dir, alive)
        blocked = occluded(rs, nee_o, l_dir, nee_on, l_dist * (1.0 - 1e-3))

        reached = nee_on & ~blocked
        cos_l = dot(light["normal"], l_dir)
        pdf = torch.where(reached, l_dist * l_dist / (cos_l * light["area"]),
                          0.0).to(ct)
        pdf = pdf / 1.0  # one light, picked with probability 1
        cos_pdf_at_l = cos_pdf_at_l.to(ct)
        w1 = pdf ** 2 / (pdf ** 2 + cos_pdf_at_l ** 2)
        w1 = torch.where(torch.isnan(w1), 0.0, w1)
        direct_diff = light["emission"].to(ct) * nee_k * torch.where(
            pdf == 0.0, 0.0, w1 / pdf)[:, None]
        # a cutout's pending light is a delta bounce's
        direct_diff = torch.where(cutout[:, None], -1.0, direct_diff)
        direct = torch.where(shaded[:, None], direct_diff, direct)
        o, d = new_o, new_dir
    return torch.where(bad[:, None], 0.0, total)


def render_pixels(rs: TexturedRefScene, cfg: dict, cam: dict, pix,
                  n_frames: int, colour=None):
    """The progressive image at pixels ``pix`` after ``n_frames`` steps, as
    the default reference's ``render_pixels`` with this :func:`radiance`
    -> (P,3) in ``colour`` (``rs.dtype`` unless given)."""
    ct = colour or rs.dtype
    dev = pix.device
    spp = cfg["spp"]
    per_pixel = n_frames * spp
    block = max(1, PATHS // per_pixel)
    out = []
    for a in range(0, pix.shape[0], block):
        p = pix[a:a + block].to(torch.int64)
        co, cd = camera_rays(cam, cfg["width"], cfg["height"], p, rs.dtype)
        cdist, ctri = closest(rs, co, cd, torch.ones(
            p.shape[0], dtype=torch.bool, device=dev))
        rep = lambda x: x.repeat_interleave(per_pixel, dim=0)
        frame = torch.arange(n_frames, device=dev).repeat_interleave(spp)
        frame = frame.repeat(p.shape[0])
        sample = torch.arange(per_pixel, device=dev).repeat(p.shape[0])
        lum = radiance(rs, cfg, rep(co), rep(cd), rep(p), frame, sample,
                       (rep(cdist), rep(ctri)), colour)
        lum = lum.reshape(p.shape[0], n_frames, spp, 3)
        accum = torch.zeros((p.shape[0], 3), dtype=ct, device=dev)
        for f in range(n_frames):
            color = lum[:, f, 0]
            for k in range(1, spp):
                color = color + lum[:, f, k]
            color = color / spp
            w = torch.tensor(1.0, dtype=torch.float32) / (float(f) + 1.0)
            accum = accum * (1.0 - w) + color * w
        out.append(accum)
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=ct,
                                                 device=dev)
