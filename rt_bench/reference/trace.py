"""Ray queries of the plain reference: closest hit and occlusion against
world-space triangles, in plain torch.

The triangles sit in clusters of at most 64, the clusters in runs of
:data:`~rt_bench.reference.scene.SUPER` (``reference/scene.py``).  A query
lists, for every ray, the (ray, cluster) pairs whose padded boxes the ray
enters inside its ``tmax``: first each ray against every run's box, then
each run it enters against its clusters' boxes.  The triangles of the
pairs are tested with the Moller-Trumbore form of the reference renderer
(``raytrace.comp``'s ``triangleIntersection``: a hit at ``t >= 0`` with all
three barycentrics at least 0, back faces skipped where the triangle is
front-only).  Occlusion tests every pair.  Closest hit tests each ray's
nearest :data:`FIRST` clusters, then only the pairs that begin before the
best hit so far; of equal distances the lowest triangle id wins.  All of
it runs on every ray at once, in blocks that bound the memory.
"""

from __future__ import annotations

import torch

from .scene import RefScene

BIG = 99999999.0  # the miss distance
EPS_FRONT = 1e-8  # front-face determinant cutoff
FIRST = 2  # nearest clusters a closest-hit ray tests before pruning
ROWS = 1 << 16  # rays, or (ray, run) pairs, a block
PAIRS = 1 << 17  # (ray, cluster) pairs a block of triangle tests


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _slab(o, inv, lo, hi, tmax):
    """Rays (P,3) against boxes (M,3) or (P,M,3) -> (hit (P,M), entry (P,M))
    where the ray enters the box before ``tmax``."""
    if lo.dim() == 2:
        lo, hi = lo[None], hi[None]
    t1 = (lo - o[:, None]) * inv[:, None]
    t2 = (hi - o[:, None]) * inv[:, None]
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1)
    entry = torch.clamp(near, min=0.0)
    return (far >= near) & (far >= 0) & (entry < tmax[:, None]), entry


def _pairs(rs: RefScene, o, inv, tmax):
    """Every (ray, cluster) pair whose box the ray enters -> (ray (Q,),
    cluster (Q,), entry (Q,))."""
    rays, cls, ents = [], [], []
    for a in range(0, o.shape[0], ROWS):
        hit, _ = _slab(o[a:a + ROWS], inv[a:a + ROWS], rs.su_min, rs.su_max,
                       tmax[a:a + ROWS])
        r1, s1 = hit.nonzero(as_tuple=True)
        r1 = r1 + a
        for b in range(0, r1.shape[0], ROWS):
            r, s = r1[b:b + ROWS], s1[b:b + ROWS]
            cl = rs.su_cl[s]  # (P, SUPER), -1 padding
            safe = torch.clamp(cl, min=0)
            hit2, ent = _slab(o[r], inv[r], rs.cl_min[safe], rs.cl_max[safe],
                              tmax[r])
            i, j = (hit2 & (cl >= 0)).nonzero(as_tuple=True)
            rays.append(r[i])
            cls.append(cl[i, j])
            ents.append(ent[i, j])
    if not rays:
        e = torch.zeros(0, dtype=torch.int64, device=o.device)
        return e, e, torch.zeros(0, dtype=o.dtype, device=o.device)
    return torch.cat(rays), torch.cat(cls), torch.cat(ents)


def _test(rs: RefScene, o, d, clus):
    """Rays x the triangles of one cluster each -> (distance, triangle id)
    of the nearest hit (BIG, -1 on none; the lowest id of equal
    distances)."""
    ids = rs.cl_tri[clus]  # (P, L)
    valid = ids >= 0
    tri = torch.where(valid, ids, 0)
    v0, e1, e2, n = rs.v0[tri], rs.e1[tri], rs.e2[tri], rs.n_geo[tri]
    o_ = o[:, None].expand_as(v0)
    d_ = d[:, None].expand_as(v0)
    rov0 = o_ - v0
    q = cross(rov0, d_)
    d0 = -dot(d_, n)
    inv = 1.0 / d0
    dst = dot(rov0, n) * inv
    u = dot(e2, q) * inv
    v = -dot(e1, q) * inv
    w = 1.0 - u - v
    front = d0 >= EPS_FRONT
    hit = ((dst >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
           & ~(~front & rs.front_only[tri]) & valid)
    dst = torch.where(hit, dst, torch.full_like(dst, BIG))
    best = dst.amin(dim=1)
    top = torch.iinfo(torch.int64).max
    first = torch.where((dst == best[:, None]) & hit, ids,
                        torch.full_like(ids, top)).amin(dim=1)
    return best, torch.where(best < BIG, first, -1)


def _test_pairs(rs: RefScene, o, d, ray, clus):
    ts, tris = [], []
    for a in range(0, ray.shape[0], PAIRS):
        r = ray[a:a + PAIRS]
        t, tri = _test(rs, o[r], d[r], clus[a:a + PAIRS])
        ts.append(t)
        tris.append(tri)
    if not ts:
        return (torch.zeros(0, dtype=o.dtype, device=o.device),
                torch.zeros(0, dtype=torch.int64, device=o.device))
    return torch.cat(ts), torch.cat(tris)


def _inverse(d):
    return 1.0 / torch.where(d == 0, torch.full_like(d, 1e-20), d)


def closest(rs: RefScene, o, d, active):
    """Nearest hit of each active ray -> (distance (N,), triangle (N,) i64);
    a miss or an inactive ray gives (BIG, -1)."""
    n = o.shape[0]
    big = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    tmax = torch.where(active, big, torch.full_like(big, -1.0))
    ray, clus, ent = _pairs(rs, o, _inverse(d), tmax)
    # group the pairs by ray, nearest first; rank them within the ray
    order = torch.argsort(ent, stable=True)
    order = order[torch.argsort(ray[order], stable=True)]
    ray, clus, ent = ray[order], clus[order], ent[order]
    count = torch.bincount(ray, minlength=n)
    start = torch.cumsum(count, 0) - count
    rank = torch.arange(ray.shape[0], device=o.device) - start[ray]
    best = big.clone()
    hits_t, hits_tri, hits_ray = [], [], []
    for part in (rank < FIRST, None):
        if part is None:  # the rest, where they begin before the best hit
            part = (rank >= FIRST) & (ent < best[ray])
        r = ray[part]
        t, tri = _test_pairs(rs, o, d, r, clus[part])
        best = best.scatter_reduce(0, r, t, reduce="amin")
        hits_t.append(t)
        hits_tri.append(tri)
        hits_ray.append(r)
    t, tri, r = torch.cat(hits_t), torch.cat(hits_tri), torch.cat(hits_ray)
    win = (tri >= 0) & (t == best[r])
    top = torch.iinfo(torch.int64).max
    first = torch.full((n,), top, dtype=torch.int64, device=o.device)
    first = first.scatter_reduce(0, r[win], tri[win], reduce="amin")
    tri_out = torch.where(first == top, -1, first)
    return torch.where(tri_out >= 0, best, big), tri_out


def occluded(rs: RefScene, o, d, active, tmax):
    """Is there any hit strictly inside ``tmax``, for each active ray?"""
    tmax = torch.where(active, tmax, torch.full_like(tmax, -1.0))
    ray, clus, _ = _pairs(rs, o, _inverse(d), tmax)
    t, tri = _test_pairs(rs, o, d, ray, clus)
    blocked = (tri >= 0) & (t < tmax[ray])
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    out[ray[blocked]] = True
    return out
