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


def assert_tri_ties(sc, o, d, prim, jprim, hit):
    """Where two routes' global triangle ids differ on a hit, both
    triangles accept the ray (by the port's arithmetic) at the same t
    within the traversal tolerance (rtol 1e-5, atol 1e-6): a tie, decided
    by visit order or by an ulp of rounding.  At most 1% of the rays."""
    from ray_tracer_tpu_torch.kernels.bvh8 import mt_test

    differ = hit & (prim != jprim)
    if differ.any():
        dd = np.where(d == 0.0, np.float32(1e-20), d)[differ]
        dd = torch.from_numpy(dd)
        oo = torch.from_numpy(o[differ])
        t_a, _, _, _, ok_a = mt_test(sc.tri_packed[prim[differ]], oo, dd)
        t_b, _, _, _, ok_b = mt_test(sc.tri_packed[jprim[differ]], oo, dd)
        assert ok_a.all() and ok_b.all()
        np.testing.assert_allclose(t_a.numpy(), t_b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert differ.mean() < 1e-2
    return differ


def deep_chain(depth, seed=5, leaves=3, loose=False):
    """BVH8 tables (``wide_packed``, ``leaf_rows``) of a chain ``depth``
    wide nodes deep: node k holds node k+1's cube (half-size 4 * 0.97^(k+1))
    as an interior child and ``leaves`` leaf slots of one to three random
    triangles inside its own cube, children sorted along x (the sort axis).
    Every cube holds the origin, so rays through the middle walk the whole
    chain.  ``loose``: each leaf's box is its node's whole cube, so the
    interior child sorts first and a ray from inside the innermost cube
    pointing up x (or an occlusion ray) descends the chain before it tests
    any leaf, holding one stack word per level."""
    rand = np.random.default_rng(seed)
    nodes = np.zeros((depth, 128), np.float32)
    rows = []
    for k in range(depth):
        half = 4.0 * 0.97 ** k
        children = []  # (box (6,), code)
        if k + 1 < depth:
            inner = 4.0 * 0.97 ** (k + 1)
            children.append((np.r_[[-inner] * 3, [inner] * 3], k + 1))
        for _ in range(leaves):
            cnt = int(rand.integers(1, 4))
            v = rand.uniform(-half, half, (cnt, 3, 3)).astype(np.float32)
            rec = np.full((8, 16), np.nan, np.float32)
            e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
            rec[:cnt, 0:3], rec[:cnt, 3:6], rec[:cnt, 6:9] = v[:, 0], e1, e2
            rec[:cnt, 9:12] = np.cross(e1, e2)
            rec[:cnt, 12:16] = 0.0
            flat = v.reshape(-1, 3)
            box = (np.r_[[-half] * 3, [half] * 3] if loose
                   else np.r_[flat.min(axis=0), flat.max(axis=0)])
            children.append((box, -(len(rows) * 16 + cnt) - 1))
            rows.append(rec.reshape(128))
        children.sort(key=lambda ch: float(ch[0][0] + ch[0][3]))
        nodes[k, :64] = np.nan
        nodes[k, 6:64:8] = 0.0
        for c, (box, code) in enumerate(children):
            nodes[k, 8 * c:8 * c + 6] = box
            nodes[k, 8 * c + 6] = code
        nodes[k, 7] = 0.0  # the sort axis: x
    return nodes, np.stack(rows)


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
