"""Cluster-route traversal: enumerate, group, test, resolve.

Port of ``ray_tracer_tpu/ops/cluster_trace.py``.  Closest-hit (and
occlusion) triangle traversal in three stages:

1. ENUMERATE: per ray, the clusters whose AABB it enters within its clip
   distance.  Either the packet kernel's emit walk over the cluster BVH8
   (``cluster_enum="packet"``) or two brute-force box levels
   (``"boxes"``: every ray against the <= 128 super boxes, then each
   (ray, super) pair against that super's cluster boxes).
2. GROUP: (ray, cluster) pairs sort by cluster id and run-pad to 128, so
   every 128-pair chunk shares one cluster; dead tails get chunk id -1.
3. TEST + RESOLVE: the chunk kernel tests each chunk against its cluster's
   coefficient page; per-ray results fold back with scatter-min.

Lanes whose candidates overflow the ``cluster_k`` emit slots (or the
pair capacity) are left out of the pair phase and traced by the packet
walk instead, so correctness never depends on K.  Triangle ids here are
GLOBAL (cluster ranges are contiguous triangle ranges): ``prim_space`` is
'tri' and shading reads ``scene.shade_tri``.

The capacities (pairs per ray, runs, slice width) are the JAX package's,
so the same lanes overflow in both; JAX's ``.at[].min``/``.max`` become
``scatter_reduce_`` and its ``mode="drop"`` scatters become writes to one
extra slot past the end that is cut off.
"""

from __future__ import annotations

import torch

from ..config import Routing
from ..kernels import cluster as kcluster
from ..kernels import packet
from ..scene.types import CompiledScene

BIG = 99999999.0
SENT = 2**30  # pair-key sentinel: sorts after every cluster id
IMAX = 2**31 - 1
SLICE = 1 << 17  # rays per slice: bounds the (rays x K) pair arrays
K_S = 8  # level-1 super emit slots of the box enumeration

I32 = torch.int32
I64 = torch.int64


def use_cluster(scene: CompiledScene, routing: Routing) -> bool:
    """The cluster route applies when asked for (``cluster="on"``) on a
    scene compiled with cluster tables.  ``"auto"`` is off, as the JAX
    package measured it; its SMEM-size bound on the enumeration tree is a
    TPU limit and is not carried over."""
    return routing.cluster == "on" and scene.meta.get("n_clusters", 0) > 0


def _uvfront_global(tri_packed, origin, direction, prim):
    """Barycentrics and facing for a GLOBAL triangle id: the
    re-derivation of ``packet.reconstruct_uvfront`` over the (T,16) global
    record table, for callers that need them from the traversal (the
    integrator re-derives them in its shade fetch instead)."""
    rec = tri_packed[prim.clamp(min=0).long()]
    return packet._uvfront(rec, origin, direction, prim)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _compact_rows(slot_mat, row_ray, row_ok, cap: int):
    """Compact a (R,K) slot matrix (-1 = empty) into flat pair arrays.

    Returns (flat_val (cap,) with SENT padding, flat_ray (cap,), row_ovf
    (R,) rows whose slots would spill past ``cap``).  Row order is kept;
    rows that spill, and every row after the first one that does, are
    left out.
    """
    R, K = slot_mat.shape
    dev = slot_mat.device
    ok = (slot_mat >= 0) & row_ok[:, None]
    cnt = ok.sum(dim=1)
    base = torch.cumsum(cnt, 0) - cnt
    row_ovf = base + cnt > cap
    ok = ok & ~row_ovf[:, None]
    k_rank = torch.cumsum(ok.long(), dim=1) - 1
    dest = torch.where(ok, base[:, None] + k_rank, cap).reshape(-1)
    flat_val = torch.full((cap + 1,), SENT, dtype=I32, device=dev)
    flat_val[dest] = slot_mat.reshape(-1).to(I32)
    flat_ray = torch.zeros(cap + 1, dtype=I32, device=dev)
    flat_ray[dest] = row_ray[:, None].expand(R, K).reshape(-1).to(I32)
    return flat_val[:cap], flat_ray[:cap], row_ovf


def _group_pairs(pair_key, pair_ray, max_runs: int):
    """Sort pairs by key (stable) and run-pad each key's run to a multiple
    of 128, so every 128-pair chunk shares one key.

    Returns (key_p (m2,), ray_p (m2,), live_p (m2,), chunk_key (g2,) with
    -1 for dead chunks, g2).
    """
    m = pair_key.shape[0]
    dev = pair_key.device
    pe, order = torch.sort(pair_key, stable=True)
    ray_sorted = pair_ray[order]
    prev = torch.cat([torch.full((1,), -9, dtype=I32, device=dev), pe[:-1]])
    newrun = pe != prev
    run_id = torch.cumsum(newrun.long(), 0) - 1
    arange = torch.arange(m, device=dev)
    run_start = torch.cummax(torch.where(newrun, arange, 0), 0).values
    pos_in_run = arange - run_start
    rid = run_id.clamp(max=max_runs - 1)
    lens = torch.zeros(max_runs, dtype=I64, device=dev)
    lens.index_add_(0, rid, torch.ones_like(rid))
    padded = (lens + 127) // 128 * 128
    offs = torch.cumsum(padded, 0) - padded
    dest = offs[rid] + pos_in_run
    m2 = _ceil(m + max_runs * 128, 128) * 128
    g2 = m2 // 128
    key_p = torch.full((m2,), SENT, dtype=I32, device=dev)
    key_p[dest] = pe
    ray_p = torch.zeros(m2, dtype=I32, device=dev)
    ray_p[dest] = ray_sorted
    live_p = key_p < SENT
    chunk_key = key_p.reshape(g2, 128)[:, 0]
    chunk_key = torch.where(chunk_key >= SENT, -1, chunk_key)
    return key_p, ray_p, live_p, chunk_key, g2


def _chunk_feats(feats, rays, live):
    """(m2,16) per-pair features, zero on dead pairs -> (g2,16,128)."""
    f = torch.where(live[:, None], feats[rays.long()], 0.0)
    return f.reshape(-1, 128, 16).transpose(1, 2).contiguous()


def _flag_rays(n, rays, flags):
    """(n,) bool: rays with any set flag among their pairs."""
    out = torch.zeros(n, dtype=I32, device=rays.device)
    out.scatter_reduce_(0, rays.long(), flags.to(I32), "amax")
    return out > 0


def _enum_boxes(scene, feats, routing, lane_active):
    """Two-level box enumeration (no tree walk): every ray against the
    super page, then (ray, super) pairs grouped by super against that
    super's cluster page.  Cluster ids are contiguous per super, so page
    column c of super s is cluster ``super_cstart[s] + c``.

    Returns (pair_cid, pair_ray, ovf_b), the packet enumeration's
    contract after compaction.
    """
    n = feats.shape[0]
    dev = feats.device
    S = int(scene.meta["n_supers"])
    K = routing.cluster_k
    ray_ids = torch.arange(n, dtype=I32, device=dev)

    # level 1: all rays vs the single super page (pad rows: tmax 0 -> miss)
    g1 = _ceil(n, 128)
    f1 = torch.zeros((g1 * 128, 16), dtype=torch.float32, device=dev)
    f1[:n] = feats
    f1 = f1.reshape(g1, 128, 16).transpose(1, 2).contiguous()
    w1 = kcluster.box_hits(scene.super_page[None].contiguous(), f1,
                           torch.zeros(g1, dtype=I32, device=dev))
    words1 = w1.transpose(1, 2).reshape(-1, 4)[:n]
    sslots, sovf = kcluster.extract_slots(words1, K_S)  # (n,K_S) super ids
    ovf_b = sovf & lane_active

    cap1 = _ceil(n * 3, 128) * 128
    psid, pray, ovf1 = _compact_rows(
        sslots, ray_ids, lane_active & ~ovf_b, cap1
    )
    ovf_b = ovf_b | ovf1

    # level 2: pairs grouped by super, each chunk vs its cluster page
    sp, rayp, livep, chunk_sid, _ = _group_pairs(psid, pray, S + 2)
    rays_safe = torch.where(livep, rayp, 0)
    w2 = kcluster.box_hits(scene.super_cpage,
                           _chunk_feats(feats, rays_safe, livep), chunk_sid)
    words2 = w2.transpose(1, 2).reshape(-1, 4)
    cols, povf = kcluster.extract_slots(words2, K)  # (m2,K) page columns
    cstart = scene.super_cstart[sp.clamp(0, max(S - 1, 0)).long()]
    cid_mat = torch.where(cols >= 0, cstart[:, None] + cols, -1)
    ovf_b = ovf_b | _flag_rays(n, rays_safe, povf & livep)

    # final (ray, cluster) pair list, pair-major compaction
    cap2 = _ceil(n * max(K // 2, 2), 128) * 128
    pair_ok = livep & ~ovf_b[rays_safe.long()]
    pair_cid, pair_ray, ovf3 = _compact_rows(cid_mat, rayp, pair_ok, cap2)
    return pair_cid, pair_ray, ovf_b | _flag_rays(n, rays_safe, ovf3 & livep)


def cluster_traverse(scene: CompiledScene, origin, direction, tmax0,
                     routing: Routing, anyhit: bool = False):
    """(dst, prim): the closest hit's distance (``tmax0`` on a miss) and
    GLOBAL triangle id (-1 on a miss); under ``anyhit``, ``dst = -BIG`` on
    occluded lanes and ``prim = -1``.

    Wavefronts beyond ``SLICE`` rays run slice by slice (the last slice
    padded with inactive lanes, as the JAX package's ``lax.map`` pads it):
    the pair phase materializes (rays x K) rows, which at whole-frame
    sizes would take gigabytes.
    """
    n = origin.shape[0]
    if n <= SLICE:
        return _cluster_traverse_slice(scene, origin, direction, tmax0,
                                       routing, anyhit)
    outs = []
    for s in range(0, n, SLICE):
        o, d, tm = (x[s:s + SLICE] for x in (origin, direction, tmax0))
        pad = SLICE - o.shape[0]
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, o.new_ones((pad, 3))])
            tm = torch.cat([tm, tm.new_full((pad,), -BIG)])
        outs.append(_cluster_traverse_slice(scene, o, d, tm, routing,
                                            anyhit))
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def _cluster_traverse_slice(scene: CompiledScene, origin, direction, tmax0,
                            routing: Routing, anyhit: bool):
    n = origin.shape[0]
    dev = origin.device
    K = routing.cluster_k
    C = int(scene.meta["n_clusters"])
    t_c = int(scene.meta["cluster_t_c"])
    lane_active = tmax0 > -BIG / 2
    feats = kcluster.ray_features(origin, direction, tmax0)  # (n,16)

    # ---- 1. enumerate candidate clusters per ray
    if routing.cluster_enum == "boxes" and scene.meta.get("n_supers", 0):
        pair_cid, pair_ray, ovf_b = _enum_boxes(scene, feats, routing,
                                                lane_active)
    else:
        slots, ovf = packet.packet_traverse_wide(
            scene.cwide_packed, scene.cwide_packed, origin, direction,
            tmax0, 8, top_k=K, emit_leaves=True,
        )
        ovf_b = (ovf > 0) & lane_active
        # ray-major compaction to a population-mean capacity; rays whose
        # pairs would spill past it join the overflow fallback
        pair_cap = _ceil(n * max(K // 2, 2), 128) * 128
        pair_cid, pair_ray, ovf2 = _compact_rows(
            slots, torch.arange(n, dtype=I32, device=dev),
            ~ovf_b & lane_active, pair_cap,
        )
        ovf_b = ovf_b | ovf2

    # ---- 2. group pairs by cluster (stable sort + 128-run padding)
    pe_p, ray_p, live_p, chunk_cid, _ = _group_pairs(pair_cid, pair_ray,
                                                     C + 2)

    # ---- 3. test chunks, resolve per ray with scatter-min
    t_chunk, p_chunk = kcluster.cluster_pairs_test(
        scene.clus_mt, _chunk_feats(feats, ray_p, live_p), chunk_cid,
        t_c=t_c,
    )
    t_flat = t_chunk.reshape(-1)
    p_flat = p_chunk.reshape(-1)
    gprim = scene.clus_start[pe_p.clamp(0, C - 1).long()] + p_flat.clamp(
        min=0)
    tval = torch.where(live_p & (p_flat >= 0), t_flat, BIG)
    ray_safe = torch.where(live_p, ray_p, 0).long()
    t_min = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    t_min.scatter_reduce_(0, ray_safe, tval, "amin")
    hit = t_min < tmax0
    dst = torch.where(hit, t_min, tmax0)

    # ---- overflow lanes: the packet walk (their pairs were left out
    # above, so it is the sole source of their result)
    tm_fb = torch.where(ovf_b & lane_active, tmax0, -BIG).contiguous()
    fb_dst, fb_prim = packet.packet_traverse_wide(
        scene.wide_packed, scene.leaf_rows, origin, direction, tm_fb,
        scene.meta.get("wide_leaf_recs", 8), anyhit=anyhit,
    )
    if anyhit:
        dst = torch.where(ovf_b, fb_dst, torch.where(hit, -BIG, tmax0))
        return dst, torch.full_like(fb_prim, -1)

    # the lowest global id among the pairs at the minimum
    win = live_p & (tval == t_min[ray_safe]) & (tval < tmax0[ray_safe])
    cand = torch.where(win, gprim, IMAX)
    prim = torch.full((n,), IMAX, dtype=I32, device=dev)
    prim.scatter_reduce_(0, ray_safe, cand, "amin")
    prim = torch.where(hit, prim, -1)
    fb_gprim = torch.where(
        fb_prim >= 0, scene.leaf_map[fb_prim.clamp(min=0).long()], fb_prim
    )
    return (torch.where(ovf_b, fb_dst, dst),
            torch.where(ovf_b, fb_gprim, prim))
