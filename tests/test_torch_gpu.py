"""The CUDA kernels on the card against their plain torch versions.

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Every test is marked ``gpu`` and skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch.kernels import bvh8, cluster, group, lanewalk, packet
from ray_tracer_tpu_torch.ops import cluster_trace
from ray_tracer_tpu_torch.scene import presets

from torch_parity import aimed_chunks, deep_chain, hand_built_pages, soup_scene

BIG = 99999999.0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    return presets.sponza_proxy(n_tris_target=20000).compile(
        clusters=True, rope_streams=True)


@pytest.fixture(scope="module")
def scene16(dev):
    """16-record two-row leaf slots."""
    return presets.sponza_proxy(n_tris_target=20000).compile(
        merge_wide_leaves=True)


def _rays(scene, n, anyhit, seed=7):
    rand = np.random.default_rng(seed)
    box = scene.bvh_packed[0].cpu().numpy()
    o = rand.uniform(box[0:3], box[3:6], (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 1] = 0.0
    tmax = rand.uniform(0.1, 8.0, n).astype(np.float32)
    if not anyhit:
        tmax[::2] = BIG
    tmax[::9] = -BIG
    return [torch.from_numpy(x).to(scene.device) for x in (o, d, tmax)]


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True])
def test_kernel_matches_plain_version(dev, scene, anyhit):
    """Bit for bit: both versions round every op alike (the kernel is
    built with --fmad=false)."""
    args = [scene.wide_packed, scene.leaf_rows, *_rays(scene, 20000, anyhit)]
    group.reset_launches()
    dst, prim = group.group_traverse(*args, anyhit=anyhit)
    assert sum(group.launches.values()) == 1
    rdst, rprim = group.group_traverse_reference(*args, anyhit=anyhit)
    torch.cuda.synchronize()
    assert torch.equal(dst, rdst)
    assert torch.equal(prim, rprim)
    assert (prim >= 0).any() or anyhit


@pytest.fixture(scope="module")
def walk_scenes(dev, scene, tmp_path_factory):
    """(nodes, leaf_rows, ray box) of the main-path scene, of a soup whose
    leaves are merged into one-row slots (a slot's record count sums
    several leaves) and of a loose chain as deep as the walk's stack, whose
    rays from its middle fill the stack (tests/test_torch_group_walk.py)."""
    soup = soup_scene(trt, str(tmp_path_factory.mktemp("soup"))).compile(
        max_leaf_tris=8)
    assert soup.meta["wide_leaf_recs"] == 8
    nodes, rows = (torch.from_numpy(x).to(dev)
                   for x in deep_chain(bvh8.G_STACK, loose=True))
    return {
        "sponza": (scene.wide_packed, scene.leaf_rows,
                   scene.bvh_packed[0].cpu()),
        "soup_leaf8": (soup.wide_packed, soup.leaf_rows,
                       soup.bvh_packed[0].cpu()),
        "deep": (nodes, rows, torch.tensor([-0.1] * 3 + [0.1] * 3)),
    }


def _walk_rays(box, n, anyhit, dev, seed=5):
    rand = np.random.default_rng(seed)
    box = box.numpy()
    o = rand.uniform(box[0:3], box[3:6], (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 1] = 0.0
    tmax = rand.uniform(0.1, 8.0, n).astype(np.float32)
    if not anyhit:
        tmax[::2] = BIG
    tmax[::9] = -BIG
    return [torch.from_numpy(x).to(dev) for x in (o, d, tmax)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 127, 129, 20000])
@pytest.mark.parametrize("name", ["sponza", "soup_leaf8", "deep"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_group_walk_matches_plain_version(dev, walk_scenes, name, n, anyhit):
    """group_walk_kernel against the plain walk, bit for bit, at ray counts
    around its 128-thread block, on merged one-row leaf slots and on a
    tree as deep as its stack."""
    nodes, rows, box = walk_scenes[name]
    args = [nodes, rows, *_walk_rays(box, n, anyhit, dev)]
    group.reset_launches()
    dst, prim = group.group_traverse(*args, anyhit=anyhit)
    assert sum(group.launches.values()) == (1 if n else 0)
    rdst, rprim = group.group_traverse_reference(*args, anyhit=anyhit)
    torch.cuda.synchronize()
    assert torch.equal(dst, rdst) and torch.equal(prim, rprim)
    if n == 20000:
        assert (prim >= 0).any() or (anyhit and (dst < -1.0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sponza", "soup_leaf8", "deep"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_group_walk_matches_the_packet_walk(dev, walk_scenes, name, anyhit):
    """The new kernel against walk_kernel (the packet walk, one-row slots)
    on the same rays: the same visits, so the same outputs."""
    nodes, rows, box = walk_scenes[name]
    args = [nodes, rows, *_walk_rays(box, 20000, anyhit, dev, seed=6)]
    got = group.group_traverse(*args, anyhit=anyhit)
    packet.reset_launches()
    want = packet.packet_traverse_wide(*args, 8, anyhit=anyhit)
    assert packet.launches["packet8_anyhit" if anyhit else "packet8_wide"] == 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("anyhit", [False, True])
def test_packet_walk_matches_plain_version(dev, scene, scene16, rows,
                                           anyhit):
    sc = scene16 if rows == 2 else scene
    recs = sc.meta["wide_leaf_recs"]
    assert (recs == 16) == (rows == 2)
    args = [sc.wide_packed, sc.leaf_rows, *_rays(sc, 20000, anyhit)]
    packet.reset_launches()
    dst, prim = packet.packet_traverse_wide(*args, recs, anyhit=anyhit)
    assert sum(packet.launches.values()) == 1
    rdst, rprim = packet.packet_traverse_wide_reference(*args, recs,
                                                        anyhit=anyhit)
    torch.cuda.synchronize()
    assert torch.equal(dst, rdst) and torch.equal(prim, rprim)
    assert (prim >= 0).any() or anyhit


@pytest.mark.gpu
def test_packet_emit_matches_plain_version(dev, scene):
    o, d, tmax = _rays(scene, 20000, False)
    args = [scene.cwide_packed, scene.cwide_packed, o, d, tmax, 8]
    packet.reset_launches()
    slots, ovf = packet.packet_traverse_wide(*args, top_k=16,
                                             emit_leaves=True)
    assert packet.launches["packet8_emit"] == 1
    rslots, rovf = packet.packet_traverse_wide_reference(
        *args, top_k=16, emit_leaves=True)
    torch.cuda.synchronize()
    assert torch.equal(slots, rslots) and torch.equal(ovf, rovf)
    assert (slots >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("start", ["top", "deep"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_treelet_modes_match_plain_version(dev, scene, start, anyhit):
    """The TOP and DEEP walks of two-phase traversal, every output bit for
    bit (the slots in their order too): kernel and twin walk each ray in
    the same order."""
    n_packets, packet_size, deep_e = 10, 2048, 16
    args = [scene.wide_packed, scene.leaf_rows,
            *_rays(scene, n_packets * packet_size, anyhit),
            scene.meta["wide_leaf_recs"]]
    if start == "top":
        kw = dict(top_k=5, troot=scene.wide_troot)
    else:  # each packet: up to 16 treelet roots, the root in every third
        rand = np.random.default_rng(3)
        roots = scene.wide_troot.nonzero()[:, 0].cpu().numpy()
        entries = np.full((n_packets, deep_e), -1, np.int32)
        for g in range(n_packets):
            pick = rand.permutation(roots)[:rand.integers(1, deep_e)]
            entries[g, :len(pick)] = pick
            if g % 3 == 0:
                entries[g, -1] = 0
        kw = dict(deep_e=deep_e, entries=torch.from_numpy(entries).to(dev),
                  packet_size=packet_size)
    assert scene.meta["n_treelets"] > 0
    packet.reset_launches()
    got = packet.packet_traverse_wide(*args, anyhit=anyhit, **kw)
    mode = f"packet8_{start}" + ("_anyhit" if anyhit else "")
    assert packet.launches[mode] == sum(packet.launches.values()) == 1
    kw.pop("deep_e", None)
    want = packet.packet_traverse_wide_reference(*args, anyhit=anyhit, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (4 if start == "top" else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any() or (anyhit and (got[0] < -1.0).any())
    if start == "top":
        assert (got[2] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("clipped", [False, True])
def test_narrow_walk_matches_plain_version(dev, scene, clipped):
    o, d, tmax = _rays(scene, 20000, clipped)
    args = [scene.bvh_packed, scene.bvh_axis, scene.tri_packed, o, d, tmax,
            int(scene.obj_bvh_root[0])]
    packet.reset_launches()
    got = packet.packet_traverse(*args)
    assert packet.launches["packet_narrow"] == 1
    want = packet.packet_traverse_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True])
def test_rope_walk_matches_plain_version(dev, scene, anyhit):
    args = [scene.rope_streams, scene.meta["rope_rows"],
            *_rays(scene, 20000, anyhit)]
    lanewalk.reset_launches()
    dst, prim = lanewalk.lanewalk_traverse(*args, anyhit=anyhit)
    mode = "lanewalk_anyhit" if anyhit else "lanewalk_closest"
    assert lanewalk.launches[mode] == 1
    rdst, rprim = lanewalk.lanewalk_traverse_reference(*args, anyhit=anyhit)
    torch.cuda.synchronize()
    assert torch.equal(dst, rdst) and torch.equal(prim, rprim)
    assert (prim >= 0).any() or (anyhit and (dst < -1.0).any())


@pytest.mark.gpu
def test_rope_walk_raises_on_a_malformed_stream(dev, scene):
    """A stream whose links loop raises through the kernel's error flag
    instead of hanging the card."""
    streams = scene.rope_streams.clone()
    streams[:, :, 6:8] = 0.0  # every BOX row links back to row 0
    with pytest.raises(RuntimeError, match="did not end"):
        lanewalk.lanewalk_traverse(streams, scene.meta["rope_rows"],
                                   *_rays(scene, 256, False))


@pytest.mark.gpu
def test_cluster_kernels_match_plain_versions(dev, scene):
    o, d, tmax = _rays(scene, 4096, False)
    feats = cluster.ray_features(o, d, tmax)
    slots, ovf = packet.packet_traverse_wide(
        scene.cwide_packed, scene.cwide_packed, o, d, tmax, 8, top_k=16,
        emit_leaves=True)
    pc, pr, _ = cluster_trace._compact_rows(
        slots, torch.arange(4096, dtype=torch.int32, device=dev), ovf == 0,
        4096 * 8)
    _, ray_p, live_p, cid, _ = cluster_trace._group_pairs(
        pc, pr, scene.meta["n_clusters"] + 2)
    fchunks = cluster_trace._chunk_feats(feats, ray_p, live_p)
    t_c = scene.meta["cluster_t_c"]
    cluster.reset_launches()
    t, p = cluster.cluster_pairs_test(scene.clus_mt, fchunks, cid,
                                      scene.clus_count, t_c)
    rt, rp = cluster.cluster_pairs_test_reference(scene.clus_mt, fchunks,
                                                  cid, scene.clus_count, t_c)
    pid = torch.where(cid >= 0, 0, -1).to(torch.int32)
    words = cluster.box_hits(scene.super_cpage, fchunks, pid,
                             scene.super_cpage_count)
    rwords = cluster.box_hits_reference(scene.super_cpage, fchunks, pid,
                                        scene.super_cpage_count)
    torch.cuda.synchronize()
    assert cluster.launches == {"cluster_pairs": 1, "box_hits": 1}
    assert torch.equal(t, rt) and torch.equal(p, rp) and (p >= 0).any()
    assert torch.equal(words, rwords) and (words != 0).any()


# chunk cluster ids (-1 dead): none, one, three, and runs of one chunk and
# of many chunks of one cluster (the page reuse), a cluster change at
# every chunk (the prefetch), and dead chunks between and after
CHUNK_SEQS = {
    "0": [],
    "1": [1],
    "3": [1, -1, 2],
    "many": ([0] + [1] * 9 + [2, 3] * 6 + [-1] * 5 + [3] * 4
             + [0, 1, 2, 3] * 40 + [2] * 30 + [-1] * 30),
}


@pytest.mark.gpu
@pytest.mark.parametrize("seq", list(CHUNK_SEQS))
@pytest.mark.parametrize("t_c", [8, 128, 512])
def test_cluster_pairs_kernel_on_hand_built_pages(dev, scene, t_c, seq):
    """Pages of 1, t_c, t_c / 2 and 3 triangles, against the plain
    version bit for bit."""
    tp = scene.tri_packed.cpu()
    pages, starts, counts = hand_built_pages(tp, t_c)
    cids = CHUNK_SEQS[seq]
    feats = aimed_chunks(tp, starts, counts, cids, np.random.default_rng(3))
    args = [x.to(dev) for x in (pages, feats,
                                torch.tensor(cids, dtype=torch.int32),
                                counts)]
    cluster.reset_launches()
    t, p = cluster.cluster_pairs_test(*args, t_c)
    assert cluster.launches["cluster_pairs"] == (1 if cids else 0)
    rt, rp = cluster.cluster_pairs_test_reference(*args, t_c)
    torch.cuda.synchronize()
    assert torch.equal(t, rt) and torch.equal(p, rp)
    if len(cids) > 3:
        assert int(p.max()) >= t_c // 2 and (p == 0).any()


def _page_runs(rand, n, n_pages):
    """(n,) i32 page ids in runs of 1-6 chunks, -1 (dead) among them."""
    runs = rand.integers(-1, n_pages, n)
    return torch.from_numpy(np.repeat(runs, rand.integers(1, 7, n))[:n]
                            .astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n_chunks", [0, 1, 3, 600])
@pytest.mark.parametrize("level", [1, 2])
def test_box_hits_kernel_matches_plain_version(dev, scene, level, n_chunks):
    """Level 1 (every chunk on the one super page) and level 2 (runs of
    super pages, dead chunks among them); some lanes carry a direction
    component of 1e-40, whose 1/d is inf: they set no bit."""
    o, d, tmax = _rays(scene, n_chunks * 128, False)
    d[::13, 0] = 1e-40
    feats = cluster.ray_features(o, d, tmax).reshape(n_chunks, 128, 16)
    feats = feats.transpose(1, 2).contiguous()
    if level == 1:
        pages = scene.super_page[None].contiguous()
        pid = torch.zeros(n_chunks, dtype=torch.int32)
        count = scene.super_page_count
    else:
        pages, count = scene.super_cpage, scene.super_cpage_count
        pid = _page_runs(np.random.default_rng(level), n_chunks,
                         scene.meta["n_supers"])
    args = (pages, feats, pid.to(dev), count)
    cluster.reset_launches()
    words = cluster.box_hits(*args)
    assert cluster.launches["box_hits"] == (1 if n_chunks else 0)
    rwords = cluster.box_hits_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(words, rwords)
    lanes = words.transpose(1, 2).reshape(-1, 4)
    assert (lanes[::13] == 0).all()
    if n_chunks == 600:
        assert (lanes != 0).any()


@pytest.fixture(scope="module")
def variants(dev):
    """tools/cluster_test_variants.py: the chunk kernels before their
    redesign and the shipped walk at other settings."""
    import os
    import sys

    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import cluster_test_variants

    return cluster_test_variants


@pytest.fixture(scope="module")
def route_chunks(scene, variants):
    """Every chunk-kernel call of both cluster routes on 2^15 rays."""
    return variants.route_chunks(scene, *_rays(scene, 1 << 15, False))


def _chunk_runs(variants, name, kernel, args):
    if kernel == "cluster_pairs":
        return (cluster.cluster_pairs_test(*args),
                variants.cluster_pairs(name, *args))
    return ((cluster.box_hits(*args),), (variants.box_hits(name, *args),))


@pytest.mark.gpu
def test_cluster_kernels_match_the_old_kernels(variants, route_chunks):
    """The chunk kernels against the designs they replaced
    (tools/cluster_test_variants.cu) on the cluster route's chunks for
    bounce-like rays: equal."""
    kernels = {kernel for kernel, _, _ in route_chunks}
    assert kernels == {"cluster_pairs", "box_hits_1", "box_hits_2"}
    for kernel, _, args in route_chunks:
        new, old = _chunk_runs(variants, "old", kernel, args)
        for a, b in zip(new, old):
            assert torch.equal(a, b), kernel
        if kernel == "cluster_pairs":
            assert (new[1] >= 0).any()
        else:
            assert (new[0] != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["shipped", "tile1", "tile2", "tile4",
                                  "tile8", "tile16", "blocks4", "blocks6"])
def test_cluster_kernel_walk_variants_match(variants, route_chunks, name):
    """The shipped walk's other settings, which the measuring tool times,
    compute exactly what the package's kernels compute."""
    for kernel, _, args in route_chunks:
        want, got = _chunk_runs(variants, name, kernel, args)
        for a, b in zip(want, got):
            assert torch.equal(a, b), kernel


@pytest.mark.gpu
def test_render_on_card_uses_the_kernel(dev, scene):
    cfg = trt.RenderConfig(width=32, height=18, samples_per_pixel=2,
                           bounce_limit=4)
    group.reset_launches()
    img = trt.render(scene, cfg)
    torch.cuda.synchronize()
    assert img.shape == (18, 32, 3) and img.device.type == "cuda"
    assert bool(torch.isfinite(img).all())
    assert group.launches["group_traverse"] > 0
    assert group.launches["group_anyhit"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["cluster", "cluster_boxes", "packet",
                                   "narrow", "lanewalk", "two_phase"])
def test_render_routes_on_card(dev, scene, route):
    kw, modes = {
        "cluster": (dict(cluster="on"),
                    ["packet8_emit", "cluster_pairs", "packet8_wide",
                     "packet8_anyhit"]),
        "cluster_boxes": (dict(cluster="on", cluster_enum="boxes"),
                          ["box_hits", "cluster_pairs", "packet8_wide"]),
        "packet": (dict(groups=0, anyhit_group=False),
                   ["packet8_wide", "packet8_anyhit"]),
        "narrow": (dict(wide=False), ["packet_narrow"]),
        "lanewalk": (dict(lanewalk="force"),
                     ["lanewalk_closest", "lanewalk_anyhit"]),
        "two_phase": (dict(two_phase=True),
                      ["packet8_top", "packet8_top_anyhit", "packet8_deep",
                       "packet8_deep_anyhit"]),
    }[route]
    cfg = trt.RenderConfig(width=32, height=18, samples_per_pixel=2,
                           bounce_limit=4, routing=trt.Routing(**kw))
    for m in (group, packet, cluster, lanewalk):
        m.reset_launches()
    img = trt.render(scene, cfg)
    torch.cuda.synchronize()
    assert img.shape == (18, 32, 3) and bool(torch.isfinite(img).all())
    counts = {**group.launches, **packet.launches, **cluster.launches,
              **lanewalk.launches}
    assert all(counts[m] > 0 for m in modes), counts
    assert counts["group_traverse"] == counts["group_anyhit"] == 0
