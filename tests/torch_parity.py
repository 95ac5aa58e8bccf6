"""Shared helpers of the ``test_torch_*`` parity tests.

The same builder script runs against either package's scene module, so
the JAX reference and the torch port compile one scene from one set of
generated OBJ files.
"""

import os

import numpy as np
import torch

BIG = 99999999.0


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")
    return path


def quad_grid(n):
    """n x n tessellated unit quad in the xz plane (geometric normal -y)."""
    verts = [
        (i / n - 0.5, 0.0, j / n - 0.5)
        for j in range(n + 1)
        for i in range(n + 1)
    ]
    faces = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i + 1
            faces.append((a, a + 1, a + n + 2))
            faces.append((a, a + n + 2, a + n + 1))
    return verts, faces


def unit_box():
    verts = [
        (x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)
    ]
    quads = [(1, 3, 7, 5), (2, 6, 8, 4), (1, 5, 6, 2), (3, 4, 8, 7),
             (1, 2, 4, 3), (5, 7, 8, 6)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return verts, faces


def room_scene(pkg, tmp):
    """Asset-free triangle scene: diffuse floor/wall/box, a mirror box, a
    glass box, an emissive quad with its rect-light entry, a glass sphere
    and the environment light.  ``pkg`` is ``ray_tracer_tpu`` or
    ``ray_tracer_tpu_torch``."""
    floor = write_obj(os.path.join(tmp, "floor.obj"), *quad_grid(8))
    box = write_obj(os.path.join(tmp, "box.obj"), *unit_box())
    quad = write_obj(os.path.join(tmp, "quad.obj"), *quad_grid(1))
    M = pkg.Material
    b = pkg.SceneBuilder()
    b.add_material(M(name="white"))
    b.add_material(M(albedo=(0.9, 0.2, 0.2), name="red"))
    b.add_material(M(albedo=(0.2, 0.9, 0.3), name="green"))
    b.add_material(M(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 1.0, 1.0),
                     emission_strength=4.0, name="light"))
    b.add_material(M(reflectance=1.0, name="mirror"))
    b.add_material(M(ior=1.5, name="glass"))
    b.add_obj(floor, material=0, position=(0, 0.5, 0), scale=(4, 1, 4))
    b.add_obj(floor, material=1, position=(-1.2, -0.5, 0),
              rotation_deg=(0, 0, 90), scale=(2, 1, 4))
    b.add_obj(box, material=2, position=(-0.5, 0.2, 0.3),
              rotation_deg=(0, 25, 0), scale=(0.5, 0.6, 0.5))
    b.add_obj(box, material=4, position=(0.6, 0.1, 0.5),
              rotation_deg=(0, -20, 0), scale=(0.4, 0.8, 0.4))
    b.add_obj(box, material=5, position=(0.1, 0.3, -0.5),
              rotation_deg=(0, 40, 0), scale=(0.35, 0.4, 0.35))
    b.add_obj(quad, material=3, position=(0, -1.5, 0), scale=(0.8, 1, 0.8))
    b.add_rect_light(corner=(-0.4, -1.5, -0.4), edge_u=(0.8, 0, 0),
                     edge_v=(0, 0, 0.8), normal=(0, -1, 0), material=3)
    b.add_sphere((0.5, 0.15, -0.3), 0.3, 5)
    b.set_environment(pkg.Environment(enabled=True))
    b.set_camera(pkg.Camera(position=(0.0, -0.5, -3.2),
                            angles_deg=(8.0, 0.0, 0.0)))
    return b


def soup_scene(pkg, tmp, seed=1234, n_tris=400):
    """Random triangle soup in [-2.4, 2.4]^3 (tests/test_group.py's mesh)."""
    rand = np.random.default_rng(seed)
    tris = (
        rand.uniform(-2, 2, (n_tris, 1, 3))
        + rand.uniform(-0.4, 0.4, (n_tris, 3, 3))
    ).astype(np.float32)
    path = os.path.join(tmp, "soup.obj")
    with open(path, "w") as f:
        for t in tris:
            for v in t:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(n_tris):
            f.write(f"f {3*i+1} {3*i+2} {3*i+3}\n")
    b = pkg.SceneBuilder()
    b.add_material(pkg.Material())
    b.add_obj(path, material=0)
    return b


def sponza_builders(tmp, monkeypatch, n_tris_target):
    """``sponza_proxy`` from each package, (JAX, port).  The JAX preset reads
    ``light2.obj`` from its assets directory: it is handed the quad the port
    generates."""
    from ray_tracer_tpu.scene import presets as j_presets
    from ray_tracer_tpu_torch.scene import presets as t_presets

    with open(os.path.join(tmp, "light2.obj"), "w") as f:
        f.write(t_presets.obj_text(t_presets.SKYLIGHT_VERTS,
                                   t_presets.SKYLIGHT_FACES))
    monkeypatch.setattr(j_presets, "DEFAULT_ASSETS", tmp)
    return (j_presets.sponza_proxy(n_tris_target=n_tris_target),
            t_presets.sponza_proxy(n_tris_target=n_tris_target))


def scene_arrays(jax_scene):
    """numpy field dict + meta of a JAX CompiledScene (before device_put)."""
    arrays, meta = jax_scene.tree_flatten()
    return dict(zip(jax_scene._ARRAY_FIELDS, map(np.asarray, arrays))), meta


def assert_images_match(img, ref, atol=2e-3, max_diverged=0.01):
    """Images agree pixel by pixel within ``atol`` except for at most a
    ``max_diverged`` fraction of pixels, and on average within ``atol``.

    The two packages do not round alike: XLA contracts multiply-adds into
    FMAs inside its fusions and has its own sin/cos/pow, so in a rare lane
    a sample path takes the other side of a Fresnel, roulette or grazing
    test and the pixel moves by a whole sample's weight.  The JAX package's
    own two traversal routes diverge so in 2 of the 1600 pixels of the
    40x40 room scene.
    """
    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    diverged = (diff.max(axis=-1) > atol).mean()
    assert diverged <= max_diverged, f"{diverged:.2%} of pixels differ"
    assert diff.mean() < atol, diff.mean()


def route_rays(rand, name, n):
    """Seeded rays for the traversal-route tests: across the soup scene,
    or inside the room scene with a quarter straight down."""
    if name == "room":
        o = rand.uniform(-1.0, 0.4, (n, 3)).astype(np.float32)
    else:
        o = rand.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    if name == "room":
        d[::4] = [0.0, 1.0, 0.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 0] = 0.0  # exercise the zero-direction guard
    return o, d


def route_tmax(rand, case, n):
    """Per-ray clip distances: BIG, random ('clipped'), or BIG with every
    third lane inactive ('inactive')."""
    tmax = np.full(n, BIG, np.float32)
    if case == "clipped":
        tmax = rand.uniform(0.1, 6.0, n).astype(np.float32)
    if case == "inactive":
        tmax[::3] = -BIG
    return tmax


def assert_tri_ties(sc, o, d, prim, jprim, hit, obj=None):
    """Where two routes' global triangle ids differ on a hit, both
    triangles accept the ray (by the port's arithmetic) at the same t
    within the traversal tolerance (rtol 1e-5, atol 1e-6): a tie, decided
    by visit order or by an ulp of rounding.  At most 1% of the rays.
    On a forest scene ``obj`` names each hit's instance: its rays are
    taken to that instance's object space first."""
    from ray_tracer_tpu_torch.kernels.bvh8 import mt_test

    differ = hit & (prim != jprim)
    if differ.any():
        oo, dd = o[differ], d[differ]
        if obj is not None:
            m = sc.obj_inv_transform.numpy()[obj[differ]]
            oo = np.einsum("nij,nj->ni", m[:, :3, :3], oo) + m[:, :3, 3]
            dd = np.einsum("nij,nj->ni", m[:, :3, :3], dd)
            oo, dd = oo.astype(np.float32), dd.astype(np.float32)
        dd = torch.from_numpy(np.where(dd == 0.0, np.float32(1e-20), dd))
        oo = torch.from_numpy(oo)
        t_a, _, _, _, ok_a = mt_test(sc.tri_packed[prim[differ]], oo, dd)
        t_b, _, _, _, ok_b = mt_test(sc.tri_packed[jprim[differ]], oo, dd)
        assert ok_a.all() and ok_b.all()
        np.testing.assert_allclose(t_a.numpy(), t_b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert differ.mean() < 1e-2
    return differ


def deep_chain(depth, seed=5, leaves=3, loose=False, rows=1):
    """BVH8 tables (``wide_packed``, ``leaf_rows``) of a chain ``depth``
    wide nodes deep: node k holds node k+1's cube (half-size 4 * 0.97^(k+1))
    as an interior child and ``leaves`` leaf slots of one to three random
    triangles inside its own cube, children sorted along x (the sort axis).
    Every cube holds the origin, so rays through the middle walk the whole
    chain.  ``loose``: each leaf's box is its node's whole cube, so the
    interior child sorts first and a ray from inside the innermost cube
    pointing up x (or an occlusion ray) descends the chain before it tests
    any leaf, holding one stack word per level.  ``rows=2``: two-row leaf
    slots of one to sixteen triangles instead (the code's count capped at
    15, as scene/builder.py writes it)."""
    rand = np.random.default_rng(seed)
    nodes = np.zeros((depth, 128), np.float32)
    leaf_rows = []
    for k in range(depth):
        half = 4.0 * 0.97 ** k
        children = []  # (box (6,), code)
        if k + 1 < depth:
            inner = 4.0 * 0.97 ** (k + 1)
            children.append((np.r_[[-inner] * 3, [inner] * 3], k + 1))
        for _ in range(leaves):
            cnt = int(rand.integers(1, 4 if rows == 1 else 17))
            v = rand.uniform(-half, half, (cnt, 3, 3)).astype(np.float32)
            rec = np.full((8 * rows, 16), np.nan, np.float32)
            e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
            rec[:cnt, 0:3], rec[:cnt, 3:6], rec[:cnt, 6:9] = v[:, 0], e1, e2
            rec[:cnt, 9:12] = np.cross(e1, e2)
            rec[:cnt, 12:16] = 0.0
            flat = v.reshape(-1, 3)
            box = (np.r_[[-half] * 3, [half] * 3] if loose
                   else np.r_[flat.min(axis=0), flat.max(axis=0)])
            children.append((box, -(len(leaf_rows) * 16 + min(cnt, 15)) - 1))
            leaf_rows.extend(rec.reshape(rows, 128))
        children.sort(key=lambda ch: float(ch[0][0] + ch[0][3]))
        nodes[k, :64] = np.nan
        nodes[k, 6:64:8] = 0.0
        for c, (box, code) in enumerate(children):
            nodes[k, 8 * c:8 * c + 6] = box
            nodes[k, 8 * c + 6] = code
        nodes[k, 7] = 0.0  # the sort axis: x
    return nodes, np.stack(leaf_rows)


def binary_chain(depth, seed=5, loose=False):
    """Binary-BVH tables (``bvh_packed`` (B,8), ``bvh_axis`` (B,) i32,
    ``tri_packed`` (T,16)) of a chain of ``depth`` interior nodes, as the
    narrow walk reads them: interior node k (id 0 for the root, 2k - 1
    after it) holds the cube of half-size 4 * 0.97^k and has as children,
    at ids 2k + 1 and 2k + 2, interior node k + 1 (the first child) and a
    leaf of one to three random triangles inside its cube; the last
    interior node has two such leaves.  Each split axis is random.  Every
    cube holds the origin.  ``loose``: each leaf's box is its parent's
    cube, so a ray from inside the innermost cube whose direction is
    positive on every axis enters both children of every node, the
    interior one first (it is the near child), and holds one pushed leaf
    per level: ``depth`` words, the host's depth cap at ``depth`` 64."""
    rand = np.random.default_rng(seed)
    n_nodes = 2 * depth + 1
    nodes = np.zeros((n_nodes, 8), np.float32)
    ints = nodes.view(np.int32)
    axis = rand.integers(0, 3, n_nodes).astype(np.int32)
    tris = []

    def leaf(node, half):
        cnt = int(rand.integers(1, 4))
        v = rand.uniform(-half, half, (cnt, 3, 3)).astype(np.float32)
        rec = np.zeros((cnt, 16), np.float32)
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        rec[:, 0:3], rec[:, 3:6], rec[:, 6:9] = v[:, 0], e1, e2
        rec[:, 9:12] = np.cross(e1, e2)
        flat = v.reshape(-1, 3)
        nodes[node, :6] = (np.r_[[-half] * 3, [half] * 3] if loose
                           else np.r_[flat.min(axis=0), flat.max(axis=0)])
        ints[node, 6], ints[node, 7] = len(tris), cnt
        tris.extend(rec)

    for k in range(depth):
        node = 0 if k == 0 else 2 * k - 1
        half = 4.0 * 0.97 ** k
        nodes[node, :6] = np.r_[[-half] * 3, [half] * 3]
        ints[node, 6], ints[node, 7] = 2 * k + 1, 0
        if k + 1 == depth:
            leaf(2 * k + 1, half)
        leaf(2 * k + 2, half)
    return nodes, axis, np.stack(tris)


def cluster_pairs_full(clus_mt, feats, chunk_cid, t_c):
    """The cluster test as a full contraction, the form the chunk kernel
    had before it dropped the page's zero entries: all 16 feature rows
    against all 5 x t_c page columns, each block's 16 terms summed in row
    order from 0.0, over every column (NaN padding is never accepted)."""
    g = feats.shape[0]
    t_out = torch.full((g, 128), BIG, dtype=torch.float32)
    p_out = torch.full((g, 128), -1, dtype=torch.int32)
    live = (chunk_cid >= 0).nonzero().squeeze(1)
    ids = torch.arange(t_c)[:, None]
    for s in range(0, live.numel(), 64):
        gi = live[s : s + 64]
        page = clus_mt[chunk_cid[gi].long()]  # (b,16,5*t_c)
        fr = feats[gi]
        o = fr[:, 0:3] - page[:, 10:13, 0:1]
        d = fr[:, 3:6]
        c = torch.stack([
            o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
            o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
            o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0],
        ], dim=1)
        f = torch.cat([o, d, c, fr[:, 9:16]], dim=1)  # (b,16,128)
        acc = torch.zeros((gi.numel(), 5 * t_c, 128), dtype=torch.float32)
        for r in range(16):
            acc = acc + page[:, r, :, None] * f[:, r, None, :]
        T, B, U, V, FO = acc.split(t_c, dim=1)
        rb = 1.0 / B
        t, u, v = T * rb, U * rb, V * rb
        w = 1.0 - u - v
        ok = (t >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
        ok = ok & ~((~(B >= 1e-8)) & (FO > 0.5))
        tt = torch.where(ok, t, BIG)
        tmin = tt.amin(dim=1)
        first = torch.where(tt == tmin[:, None], ids, t_c).amin(dim=1)
        t_out[gi] = tmin
        p_out[gi] = torch.where(tmin < BIG, first, -1).to(torch.int32)
    return t_out, p_out


def box_hits_full(pages, feats, chunk_pid):
    """The box test as the full contraction the kernel had before it
    dropped the page's zero entries: each slab plane is page rows 0-2
    against 1/d, three products summed in row order, over all 128
    columns (NaN padding sets no bit)."""
    g = feats.shape[0]
    out = torch.zeros((g, 4, 128), dtype=torch.int32)
    live = (chunk_pid >= 0).nonzero().squeeze(1)
    weights = 1 << torch.arange(32, dtype=torch.int64)
    for s in range(0, live.numel(), 64):
        gi = live[s : s + 64]
        page = pages[chunk_pid[gi].long()]  # (b,16,768)
        fr = feats[gi]
        iv = 1.0 / fr[:, 3:6]
        oiv = fr[:, 0:3] * iv
        raw = (page[:, 0, :, None] * iv[:, 0, None, :]
               + page[:, 1, :, None] * iv[:, 1, None, :]
               + page[:, 2, :, None] * iv[:, 2, None, :])  # (b,768,128)
        t1x, t2x, t1y, t2y, t1z, t2z = (
            raw[:, k * 128 : (k + 1) * 128] - oiv[:, k // 2, None, :]
            for k in range(6))
        tmin = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z))
        tmx = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z))
        hit = (tmx >= tmin) & (tmx > 0) & (tmin < fr[:, 13, None, :])
        words = (hit.reshape(-1, 4, 32, 128).long()
                 * weights[:, None]).sum(dim=2)
        out[gi] = (words - (words >= 2**31).long() * 2**32).to(torch.int32)
    return out


def hand_built_pages(tri_packed, t_c):
    """Cluster pages (``accel/cluster.py::_mt_pages``) over the first
    triangles of a ``tri_packed`` table: clusters of 1, t_c, t_c // 2 (at
    least 2) and 3 triangles, anchored at their vertex means.  Returns
    (pages (4,16,5*t_c), starts (4,) numpy, counts (4,) i32 tensor)."""
    from ray_tracer_tpu_torch.accel.cluster import _mt_pages

    tp = np.asarray(tri_packed)
    counts = np.array([1, t_c, max(t_c // 2, 2), 3], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    anchors = np.stack([tp[s:s + c, 0:3].mean(axis=0)
                        for s, c in zip(starts, counts)])
    anchors = anchors.astype(np.float32).astype(np.float64)
    pages = _mt_pages(tp, starts, counts, t_c, anchors)
    return torch.from_numpy(pages), starts, torch.from_numpy(counts)


def aimed_chunks(tri_packed, starts, counts, cids, rand):
    """(G,16,128) features of rays aimed at random points of random
    triangles of each chunk's cluster (``cids``, -1 = dead) from up to 2
    units away; every seventh lane is padding (zero features), and a dead
    chunk is all padding."""
    from ray_tracer_tpu_torch.kernels.cluster import ray_features

    tp = np.asarray(tri_packed)
    counts = np.asarray(counts)
    feats = torch.zeros((len(cids), 16, 128))
    for g, ci in enumerate(cids):
        if ci < 0:
            continue
        rec = tp[starts[ci] + rand.integers(0, counts[ci], 128)]
        a, b = rand.uniform(0, 1, (2, 128, 1))
        a, b = np.where(a + b > 1, 1 - a, a), np.where(a + b > 1, 1 - b, b)
        point = rec[:, 0:3] + a * rec[:, 3:6] + b * rec[:, 6:9]
        o = point + rand.uniform(-2, 2, (128, 3))
        d = point - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        f = ray_features(torch.from_numpy(o.astype(np.float32)),
                         torch.from_numpy(d.astype(np.float32)))
        f[::7] = 0.0
        feats[g] = f.T
    return feats


def entry_dist(origin, direction, ent, entry_box):
    """(N,E) entry distance of each lane into the entry boxes (rows of the
    (W,8) ``entry_box`` table) of its entries ``ent`` (N,E): the kernels'
    slab test, op for op, +inf on a miss, on entries without a box (the
    root) and on -1."""
    box = entry_box[ent.long().clamp(min=0)]
    d = torch.where(direction == 0.0, 1e-20, direction)
    inv = 1.0 / d
    oi = origin * inv
    t1 = box[:, :, 0:3] * inv[:, None] - oi[:, None]
    t2 = box[:, :, 3:6] * inv[:, None] - oi[:, None]
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmx = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    near = (tmx >= tmin) & (tmx > 0) & (box[:, :, 6] != 0) & (ent >= 0)
    return torch.where(near, tmin, float("inf"))


def deep_in_order(nodes, leaf_rows, origin, direction, tmax0, entries,
                  packet_size, max_recs, anyhit=False, entry_box=None,
                  order=None, stats=None):
    """The DEEP walk of every lane, one entry's subtree after the other,
    each bounded by the best so far: one single-entry DEEP walk per turn.
    ``order`` (N,E) holds the list index of each lane's entry at each turn;
    by default the list order, last entry first, which is the DEEP walk
    before its redesign (its entries pushed untested in list order onto
    the walk's stack).  With an ``entry_box`` table (``tools/deep_walk_variants.py::
    entry_boxes``) an entry that has a box is walked only where the ray
    enters it within the best so far (the cull); ``stats["skipped"]``
    then counts the (lane, turn) pairs it skipped.  ``(dst, prim)``."""
    from ray_tracer_tpu_torch.kernels import packet

    n = origin.shape[0]
    ent = entries[torch.arange(n) // packet_size]
    if order is None:
        order = torch.arange(ent.shape[1] - 1, -1, -1).expand(n, -1)
    ent = ent.gather(1, order)
    dst, prim = tmax0.clone(), torch.full((n,), -1, dtype=torch.int32)
    skipped = 0
    for turn in range(ent.shape[1]):
        col = ent[:, turn:turn + 1]
        if entry_box is not None:
            boxed = (entry_box[col[:, 0].long().clamp(min=0), 6] != 0)
            dist = entry_dist(origin, direction, col, entry_box)[:, 0]
            skip = (col[:, 0] >= 0) & boxed & ~(dist < dst)
            skipped += int(skip.sum())
            col = torch.where(skip[:, None], -1, col)
        d, p = packet.packet_traverse_wide_reference(
            nodes, leaf_rows, origin, direction, dst, max_recs,
            anyhit=anyhit, entries=col.contiguous(), packet_size=1)
        prim = torch.where(p >= 0, p, prim)
        dst = d
    if stats is not None:
        stats["skipped"] = skipped
    return dst, prim


def nearest_first(origin, direction, entries, packet_size, entry_box):
    """(N,E) list indices of each lane's entries nearest first: by
    :func:`entry_dist` (ties, the root and -1 at +inf, by list index)."""
    n = origin.shape[0]
    ent = entries[torch.arange(n) // packet_size]
    key = entry_dist(origin, direction, ent, entry_box)
    return torch.sort(key, dim=1, stable=True).indices


def _textured_box(path, mtllib=None, groups=("box",)):
    """The unit box with per-face uvs and normals; its faces split among
    ``groups`` (``usemtl`` names when ``mtllib`` is given)."""
    verts, faces = unit_box()
    lines = [f"mtllib {mtllib}\n"] if mtllib else []
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts]
    lines += ["vt 0 0\n", "vt 1 0\n", "vt 1 1\n", "vt 0.25 0.75\n"]
    lines += ["vn 0 0 -1\n", "vn 0 1 0\n"]
    per = -(-len(faces) // len(groups))
    for g, name in enumerate(groups):
        if mtllib:
            lines.append(f"usemtl {name}\n")
        for k, (a, b, c) in enumerate(faces[g * per:(g + 1) * per]):
            n = 1 + k % 2
            lines.append(f"f {a}/1/{n} {b}/2/{n} {c}/3/{n}\n")
    with open(path, "w") as f:
        f.write("".join(lines))
    return path


def _png(path, seed):
    from ray_tracer_tpu_torch.integrator import film

    rgb = np.random.default_rng(seed).integers(0, 256, (6, 5, 3), np.uint8)
    with open(path, "wb") as f:
        f.write(film.encode_png_uint8(rgb))
    return path


def stand_in_assets(tmp):
    """Stand-ins for the files the asset-backed presets read: small OBJs
    under the shipped names (2 x 2 quads for the Cornell walls, the
    skylight quad for the light, a textured box for every model), seeded PNGs for their maps, and the
    bobadog OBJ with its MTL (two ``usemtl`` groups, one ``map_Ka``
    texture).  Returns the directory, for the presets' ``assets=``."""
    for name, n in (("plane", 2), ("ceiling", 1)):  # 2 x 2 walls
        verts, faces = quad_grid(n)
        write_obj(os.path.join(tmp, f"{name}.obj"),
                  [(2 * x, y, 2 * z) for x, y, z in verts], faces)
    light = [(x / 3.0, 0.0, z / 3.0) for x, z in
             ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    write_obj(os.path.join(tmp, "light2.obj"), light, [(1, 2, 3), (1, 3, 4)])
    for k, name in enumerate(("cube", "monkey", "dread", "rb", "squeezer",
                              "slosher", "bunny")):
        _textured_box(os.path.join(tmp, f"{name}.obj"))
        for m, suffix in enumerate(("alb", "mtl")):
            _png(os.path.join(tmp, f"{name}_{suffix}.png"), 2 * k + m)
    dog = os.path.join(tmp, "bobadog")
    os.makedirs(dog, exist_ok=True)
    _textured_box(os.path.join(dog, "bobadog.obj"), mtllib="bobadog.mtl",
                  groups=("body", "eyes"))
    with open(os.path.join(dog, "bobadog.mtl"), "w") as f:
        f.write("newmtl body\nKa 1 1 1\nKd 0.8 0.6 0.9\n"
                "map_Ka bobaxture2.png\n"
                "newmtl eyes\nKd 0.1 0.1 0.1\n")
    _png(os.path.join(dog, "bobaxture2.png"), 99)
    return tmp


def assert_tables_match(jax_scene, tsc):
    """Every table of the port's compiled scene (compiled with
    ``rope_streams=True``) equals the JAX package's for the same builder
    script, NaN-equal, and so does its ``meta``; the tables that only the
    port keeps equal those derived from the JAX tables."""
    from ray_tracer_tpu_torch import CompiledScene
    from ray_tracer_tpu_torch.scene.builder import top_table_or_empty
    from ray_tracer_tpu_torch.scene.types import (
        narrow_root_meta,
        page_counts,
        rope_box_rows,
        rope_placeholder,
    )

    jarr, jmeta = scene_arrays(jax_scene)
    if jmeta["rope_rows"]:
        jarr["rope_streams"], n_box = rope_box_rows(
            jarr["rope_streams"], jmeta["rope_rows"],
            jarr["tri_packed"].shape[0])
        jmeta = {**jmeta, "rope_rows": n_box}
    else:
        jarr["rope_streams"] = rope_placeholder()
    jarr.update(page_counts(jarr, jmeta))
    jarr["wide_top"] = top_table_or_empty(jarr["wide_packed"],
                                          jarr["wide_troot"])
    for f in CompiledScene.array_fields():
        got, want = np.asarray(getattr(tsc, f)), jarr[f]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    jmeta = {**jmeta, **narrow_root_meta(jarr)}
    for k, v in tsc.meta.items():
        assert jmeta[k] == v, k


SHARD_MESHES = [(4, 1), (2, 2), (1, 4)]


def sharded_room_rank(rank, n, store, out, frame):
    """One rank of a gloo world of ``n`` (``parallel.entry.init_rank``: a
    file store, one torch thread): renders the room scene with ``frame``
    (RenderConfig keywords) on every mesh of :data:`SHARD_MESHES` and, on
    rank 0, saves each image to ``out/mesh_<d>x<s>.npy``.  Rank 0 also
    checks that a mesh that does not use the world raises."""
    import torch.distributed as dist

    import ray_tracer_tpu_torch as trt
    from ray_tracer_tpu_torch.parallel import entry, mesh

    entry.init_rank(rank, n, store, cpu=True)
    try:
        tmp = os.path.join(out, f"rank{rank}")
        os.makedirs(tmp, exist_ok=True)
        sc = room_scene(trt, tmp).compile(device="cpu")
        cfg = trt.RenderConfig(**frame)
        for n_data, n_sample in SHARD_MESHES:
            m = mesh.make_mesh(n_data=n_data, n_sample=n_sample)
            assert (m.n_data, m.n_sample) == (n_data, n_sample)
            assert (m.my_data, m.my_sample) == divmod(rank, n_sample)
            img = mesh.render_frame_sharded(sc, cfg, m)
            if rank == 0:
                np.save(os.path.join(out, f"mesh_{n_data}x{n_sample}.npy"),
                        img.numpy())
        if rank == 0:
            try:
                mesh.make_mesh(n_data=3, n_sample=1)
            except ValueError:
                np.save(os.path.join(out, "bad_mesh_raised.npy"), 1)
    finally:
        dist.destroy_process_group()


def _write_quad(path, z=0.0, half=1.5):
    """A z-facing quad spanning [-half, half]^2 with full uv coverage."""
    with open(path, "w") as f:
        f.write(
            f"v -{half} -{half} {z}\nv {half} -{half} {z}\n"
            f"v {half} {half} {z}\nv -{half} {half} {z}\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
            "vn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\nvn 0 0 -1\n"
            "f 1/1/1 3/3/3 2/2/2\nf 1/1/1 4/4/4 3/3/3\n"
        )
    return path


def _write_png(path, rgb):
    from ray_tracer_tpu_torch.integrator import film

    with open(path, "wb") as f:
        f.write(film.encode_png_uint8(rgb))
    return path


def _gradient(n=12):
    """An n x n color gradient with a checker, so that bilinear and
    nearest sampling differ."""
    y, x = np.mgrid[0:n, 0:n]
    rgb = np.stack([x * 255 // (n - 1), y * 255 // (n - 1),
                    ((x + y) % 2) * 200 + 30], axis=-1)
    return rgb.astype(np.uint8)


def _halves(left, right, n=16):
    rgb = np.zeros((n, n, 3), np.uint8)
    rgb[:, : n // 2] = left
    rgb[:, n // 2:] = right
    return rgb


def maps_scene(pkg, tmp, maps):
    """Two textured quads (bilinear left, nearest right) with the maps
    named in ``maps`` ("albedo", "metal", "alpha"), an emissive wall
    behind them with its rect light, under the sky."""
    quad = _write_quad(os.path.join(tmp, "quad.obj"), half=0.9)
    wall = _write_quad(os.path.join(tmp, "wall.obj"), z=2.0, half=4.0)
    alb = _write_png(os.path.join(tmp, "alb.png"), _gradient())
    metal = _write_png(os.path.join(tmp, "metal.png"), _halves(0, 255))
    alpha = _write_png(os.path.join(tmp, "alpha.png"), _halves(255, 0))
    b = pkg.SceneBuilder()
    tex = {"albedo": b.add_texture(alb), "metal": b.add_texture(metal),
           "alpha": b.add_texture(alpha)}
    mat = pkg.Material(
        albedo=(0.9, 0.8, 0.7),
        albedo_tex=tex["albedo"] if "albedo" in maps else -1,
        metalness_tex=tex["metal"] if "metal" in maps else -1,
        alpha_tex=tex["alpha"] if "alpha" in maps else -1,
    )
    m = b.add_material(mat)
    glow = b.add_material(pkg.Material(albedo=(0, 0, 0),
                                       emission_color=(1, 0.9, 0.8),
                                       emission_strength=2.0))
    b.add_obj(quad, material=m, position=(-0.95, 0, 0), sampler=1)
    b.add_obj(quad, material=m, position=(0.95, 0, 0), sampler=0)
    b.add_obj(wall, material=glow)
    b.add_rect_light(corner=(-4, -4, 2), edge_u=(8, 0, 0), edge_v=(0, 8, 0),
                     normal=(0, 0, -1), material=glow)
    b.set_environment(pkg.Environment(enabled=True))
    b.set_camera(pkg.Camera(position=(0, 0, -4), angles_deg=(0, 0, 0)))
    return b


def sphere_maps_scene(pkg, tmp):
    """``sphere_diffuse``'s two spheres with maps, a scene without meshes:
    the small sphere's material has an albedo map and an alpha map that
    cuts everywhere, the ground's an albedo map and a metalness map.  Its
    sphere lanes sample at shade row 0's uv, as both packages do."""
    alb = _write_png(os.path.join(tmp, "sph_alb.png"), _gradient())
    cut = _write_png(os.path.join(tmp, "sph_cut.png"),
                     np.zeros((4, 4, 3), np.uint8))
    metal = _write_png(os.path.join(tmp, "sph_metal.png"),
                       np.full((4, 4, 3), 128, np.uint8))
    b = pkg.SceneBuilder()
    tex = [b.add_texture(path) for path in (alb, cut, metal)]
    small = b.add_material(pkg.Material(albedo=(0.8, 0.6, 0.4),
                                        albedo_tex=tex[0], alpha_tex=tex[1]))
    ground = b.add_material(pkg.Material(albedo=(0.7, 0.7, 0.7),
                                         albedo_tex=tex[0],
                                         metalness_tex=tex[2]))
    b.add_sphere((0.0, -0.5, 0.0), 0.5, small)
    b.add_sphere((0.0, 100.0, 0.0), 100.0, ground)
    b.set_environment(pkg.Environment(enabled=True))
    b.set_camera(pkg.Camera(position=(0.0, -0.6, -3.0),
                            angles_deg=(0.0, 0.0, 0.0)))
    return b


def bump_scene(pkg, tmp, ramp, sampler=0):
    """``tests/test_normal_maps.py``'s scene: a -z-facing textured quad
    with a bump map whose height is ``ramp(column)`` (16x16 gray PNG, made
    here), a dark wall behind the camera, and a rect light in front of the
    quad offset to +x."""
    quad = os.path.join(tmp, "quad.obj")
    wall = os.path.join(tmp, "wall.obj")
    for path, z, half, flip in ((quad, 0.0, 1.5, False),
                                (wall, -3.2, 9.0, True)):
        faces = ("vn 0 0 1\n" * 4 + "f 1/1/1 2/2/2 3/3/3\nf 1/1/1 3/3/3 "
                 "4/4/4\n") if flip else ("vn 0 0 -1\n" * 4 + "f 1/1/1 "
                                          "3/3/3 2/2/2\nf 1/1/1 4/4/4 3/3/3\n")
        with open(path, "w") as f:
            f.write(f"v -{half} -{half} {z}\nv {half} -{half} {z}\n"
                    f"v {half} {half} {z}\nv -{half} {half} {z}\n"
                    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n" + faces)
    from ray_tracer_tpu_torch.integrator import film

    bmap = os.path.join(tmp, f"bump_{ramp.__name__}.png")
    gray = np.zeros((16, 16, 3), np.uint8)
    for j in range(16):
        gray[:, j] = ramp(j)
    with open(bmap, "wb") as f:
        f.write(film.encode_png_uint8(gray))
    b = pkg.SceneBuilder()
    tex = b.add_texture(bmap)
    mat = b.add_material(pkg.Material(albedo=(0.8, 0.8, 0.8), bump_tex=tex))
    dark = b.add_material(pkg.Material(albedo=(0.25, 0.25, 0.25)))
    b.add_obj(quad, material=mat, sampler=sampler)
    b.add_obj(wall, material=dark)
    glow = b.add_material(pkg.Material(emission_color=(1, 1, 1),
                                       emission_strength=6.0))
    b.add_rect_light((1.8, -0.6, -1.6), (0.6, 0.0, 0.0), (0.0, 1.2, 0.0),
                     (0.0, 0.0, -1.0), glow)
    b.set_environment(pkg.Environment(enabled=False))
    b.set_camera(pkg.Camera(position=(0, 0, -2.8), angles_deg=(0, 0, 0)))
    return b


def uphill(j):
    return j * 16


def downhill(j):
    return 240 - j * 16


def level(j):
    return 128


def with_lights(sc, n):
    """The compiled torch scene ``sc`` with ``n`` (0, 1 or 2) rect
    lights: none (its light rows kept as the placeholder), its first
    light (or, in a scene without one, a unit quad above the origin
    facing down, of material 0), or that light and a copy a quarter of
    its diagonal away, of the scene's last material."""
    import dataclasses

    def rows(name):
        return getattr(sc, name)[:1].clone()

    if sc.n_lights:
        light = {k: rows(k) for k in ("light_corner", "light_edge_u",
                                      "light_edge_v", "light_normal",
                                      "light_area", "light_mat")}
    else:
        f = lambda v: torch.tensor([v], dtype=torch.float32,
                                   device=sc.device)
        light = dict(light_corner=f((-0.5, -2.0, -0.5)),
                      light_edge_u=f((1.0, 0.0, 0.0)),
                      light_edge_v=f((0.0, 0.0, 1.0)),
                      light_normal=f((0.0, 1.0, 0.0)),
                      light_area=torch.ones(1, device=sc.device),
                      light_mat=torch.zeros(1, dtype=torch.int32,
                                            device=sc.device))
    if n == 2:
        shift = 0.25 * (light["light_edge_u"] + light["light_edge_v"])
        second = dict(light, light_corner=light["light_corner"] + shift,
                      light_mat=torch.full_like(
                          light["light_mat"], sc.mat_albedo.shape[0] - 1))
        light = {k: torch.cat([light[k], second[k]]) for k in light}
    if n == 0:
        light = {}
    return dataclasses.replace(sc, meta={**sc.meta, "n_lights": n}, **light)


def first_wave(sc, cfg, frame=1, n_spp=2):
    """``(c, round_, w)``: the wavefront's round context and round
    function for ``cfg`` on every pixel of its frame (one lane a pixel,
    ``n_spp`` samples each), and its first wave."""
    from ray_tracer_tpu_torch import api
    from ray_tracer_tpu_torch.integrator import wavefront

    cam = api._camera_arrays(api.scene_camera(sc), cfg, sc.device)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=sc.device)
    c, round_ = wavefront._round_context(sc, *cam, frame, n_spp, cfg)
    return c, round_, wavefront._first_wave(c, ids, torch.zeros_like(ids))


def same_values(a, b):
    """Equal shapes and dtypes, and equal values where NaN equals NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def same_bits(a, b):
    """Equal shapes, dtypes and bits (-0.0 is not 0.0; NaN payloads
    count)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = (x.contiguous().view(torch.int32) for x in (a, b))
    return torch.equal(a, b)


def world_corners(inv_transform, box):
    """The 8 corners of the object-space ``box`` (6,) min3|max3 taken to
    world space by the float64 inverse of the f32 ``inv_transform``
    (4,4): (8,3) f64, as ``packet.forest_cull_table`` takes them."""
    m = np.asarray(inv_transform, np.float32).astype(np.float64)
    box = np.asarray(box, np.float32).astype(np.float64)
    bits = np.arange(8)
    corner = np.stack([box[np.where(bits & 1, 3, 0)],
                       box[np.where(bits & 2, 4, 1)],
                       box[np.where(bits & 4, 5, 2)]], axis=1)
    return (corner - m[:3, 3]) @ np.linalg.inv(m[:3, :3]).T


# the 12 edges of a box as pairs of world_corners' indices
BOX_EDGES = [(a, a | b) for b in (1, 2, 4) for a in range(8) if not a & b]


def grazing_rays(inv_transform, bvh_packed, roots, n_per, rand,
                 spread=4.0):
    """Rays aimed at every instance's root box in world space: at its
    corners and at points of its edges, from origins up to ``spread``
    box sizes away (a tenth of them axis-aligned, so that direction
    components are exactly zero), each target and direction component
    then moved by -1, 0 or +1 ulp.  ``n_per`` rays an instance -> (o, d,
    tmax) f32 numpy; tmax drawn from BIG, above BIG (1e9, inf), 0, -1,
    -BIG and the target's distance times 1 +- 1e-6."""
    big = np.float32(99999999.0)
    inv = np.asarray(inv_transform, np.float32)
    nodes = np.asarray(bvh_packed, np.float32)
    o_all, d_all, t_all = [], [], []
    for k, root in enumerate(roots):
        corner = world_corners(inv[k], nodes[int(root), 0:6])
        size = max(float(np.ptp(corner, axis=0).max()), 1e-6)
        edge = rand.integers(0, 12, n_per)
        a = corner[[BOX_EDGES[e][0] for e in edge]]
        b = corner[[BOX_EDGES[e][1] for e in edge]]
        s = rand.uniform(0.0, 1.0, (n_per, 1))
        s[rand.random(n_per) < 0.4] = rand.integers(0, 2, 1)[0]
        target = a + s * (b - a)
        away = rand.normal(size=(n_per, 3))
        axis = rand.random(n_per) < 0.1
        away[axis] = 0.0
        away[axis, rand.integers(0, 3, int(axis.sum()))] = 1.0
        away /= np.linalg.norm(away, axis=1, keepdims=True)
        dist = size * rand.uniform(0.05, spread, (n_per, 1))
        origin = (target + away * dist).astype(np.float32)
        target = target.astype(np.float32)
        nudge = rand.integers(-1, 2, target.shape)
        target = np.where(nudge > 0, np.nextafter(target, np.inf),
                          np.where(nudge < 0, np.nextafter(target, -np.inf),
                                   target)).astype(np.float32)
        d = (target.astype(np.float64) - origin)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = d.astype(np.float32)
        nudge = rand.integers(-1, 2, d.shape) * (d != 0)
        d = np.where(nudge > 0, np.nextafter(d, np.inf),
                     np.where(nudge < 0, np.nextafter(d, -np.inf), d))
        reach = np.linalg.norm(target.astype(np.float64) - origin, axis=1)
        choice = rand.integers(0, 8, n_per)
        tmax = np.select(
            [choice == 0, choice == 1, choice == 2, choice == 3,
             choice == 4, choice == 5, choice == 6],
            [big, 1e9, np.inf, 0.0, -1.0, -big, reach * (1 - 1e-6)],
            reach * (1 + 1e-6)).astype(np.float32)
        o_all.append(origin)
        d_all.append(d.astype(np.float32))
        t_all.append(tmax)
    return (np.concatenate(o_all), np.concatenate(d_all),
            np.concatenate(t_all))


# f32 bit patterns a copy must keep: quiet and signalling NaNs with
# payloads, both infinities, -0.0, the smallest subnormal
SPECIAL_BITS = np.array([0x7FC00001, 0x7F800123, 0xFFC0BEEF, 0x7F800000,
                         0xFF800000, 0x80000000, 0x00000001],
                        dtype=np.uint32).view(np.int32)


def random_rows(n, seed=0, device="cpu"):
    """(n, 40) f32 packed lane rows of random bits, made with numpy from
    ``seed``: any f32 and i32 value, every 11th word one of
    SPECIAL_BITS."""
    rand = np.random.default_rng(seed)
    bits = rand.integers(-2**31, 2**31, (n, 40)).astype(np.int32)
    flat = bits.reshape(-1)
    flat[::11] = np.resize(SPECIAL_BITS, flat[::11].shape)
    return torch.from_numpy(bits).view(torch.float32).to(device)


def sorted_keys(n, seed=0, device="cpu"):
    """(n,) i32 bin keys as the round's sort leaves them, made with numpy
    from ``seed``: keys below n/4 in ascending order, so runs of several
    lanes and runs of one, then a fifth of the lanes dead
    (``shading.DEAD_KEY``)."""
    from ray_tracer_tpu_torch.integrator import shading

    rand = np.random.default_rng(seed)
    keys = np.sort(rand.integers(0, max(n // 4, 1), n)).astype(np.int32)
    keys[n - n // 5:] = shading.DEAD_KEY
    return torch.from_numpy(keys).to(device)


def random_lanes(n, n_lights=2, fresh="mixed", seed=0, device="cpu"):
    """``shading.Lanes`` of ``n`` random lanes, made with numpy from
    ``seed``: vectors and columns with NaN payloads, infinities, -0.0 and
    zeros among them, random flags (``fresh``: fresh_direct on "all", on
    "none" or on a random half of the lanes), negative i32 words, and a
    light index below ``max(n_lights, 1)``."""
    from ray_tracer_tpu_torch.integrator import shading

    rand = np.random.default_rng(seed)

    def floats(*shape):
        x = rand.normal(size=shape).astype(np.float32)
        bits = x.reshape(-1).view(np.int32)
        bits[::13] = np.resize(SPECIAL_BITS, bits[::13].shape)
        x.reshape(-1)[5::17] = 0.0
        return x

    def unit(count):
        d = rand.normal(size=(count, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    flag = lambda: rand.uniform(size=n) < 0.5
    fresh_direct = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                    "mixed": flag()}[fresh]
    ints = lambda: rand.integers(-2**31, 2**31, n).astype(np.int32)
    f = {k: floats(n, 3) for k in ("origin", "direction", "atten", "total",
                                   "acc", "direct_base", "nee_origin")}
    lanes = dict(
        f, l_dir=unit(n), nee_k=np.abs(floats(n, 3)), alive=flag(),
        bad=flag(), fresh_direct=fresh_direct, is_diff=flag(),
        cos_pdf_at_l=np.abs(floats(n)),
        l_dist=rand.uniform(0.0, 5.0, n).astype(np.float32),
        nee_active=flag(), j=ints(), s=ints(), pix=ints(), slot=ints(),
        li=rand.integers(0, max(n_lights, 1), n).astype(np.int32),
        sb=ints())
    lanes["l_dir"][::29] = np.float32(np.nan)
    lanes["l_dist"][3::31] = 0.0
    return shading.Lanes(**{k: torch.from_numpy(v).to(device)
                            for k, v in lanes.items()})
