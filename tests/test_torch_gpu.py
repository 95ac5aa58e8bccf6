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

from torch_parity import (
    aimed_chunks,
    binary_chain,
    deep_chain,
    grazing_rays,
    hand_built_pages,
    soup_scene,
)

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


def _tools_module(name):
    """A module of tools/ (the variants of the kernels, which the package
    does not import)."""
    import importlib
    import os
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def packet_variants(dev):
    """tools/packet_walk_variants.py: the packet walk from the root before
    its redesign (walk_kernel's loop)."""
    return _tools_module("packet_walk_variants")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sponza", "soup_leaf8", "deep"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_group_walk_matches_the_packet_walk(dev, walk_scenes, packet_variants,
                                            name, anyhit):
    """The group kernel against the walk it replaced (walk_kernel's loop,
    the old packet walk with one-row slots, tools/packet_walk_variants.cu)
    on the same rays: the same visits, so the same outputs.  The packet
    walk from the root is the group kernel now: its launch counts under
    the packet walk's mode and equals it too."""
    nodes, rows, box = walk_scenes[name]
    args = [nodes, rows, *_walk_rays(box, 20000, anyhit, dev, seed=6)]
    got = group.group_traverse(*args, anyhit=anyhit)
    packet.reset_launches()
    via_packet = packet.packet_traverse_wide(*args, 8, anyhit=anyhit)
    assert packet.launches["packet8_anyhit" if anyhit else "packet8_wide"] == 1
    want = packet_variants.run("old", *args, 8, anyhit=anyhit)
    torch.cuda.synchronize()
    for g, p, w in zip(got, via_packet, want):
        assert torch.equal(g, w) and torch.equal(p, w)


@pytest.fixture(scope="module")
def packet_walk_cases(dev, scene, scene16):
    """(nodes, leaf_rows, max_recs, rays box, inside) of the packet walk's
    cases, for one- and two-row slots: the scene, and a loose chain as
    deep as the walk's stack whose rays from its middle pointing up x fill
    it (``inside``)."""
    out = {}
    for rows, sc in ((1, scene), (2, scene16)):
        out[rows, "sponza"] = (sc.wide_packed, sc.leaf_rows,
                               sc.meta["wide_leaf_recs"],
                               sc.bvh_packed[0].cpu(), False)
        nodes, leaf_rows = (torch.from_numpy(x).to(dev) for x in deep_chain(
            bvh8.G_STACK, loose=True, rows=rows))
        out[rows, "deep"] = (nodes, leaf_rows, 8 * rows,
                             torch.tensor([-0.1] * 3 + [0.1] * 3), True)
    return out


def _case_rays(box, n, anyhit, dev, case, inside=False, seed=8):
    """_walk_rays, with a direction component of 1e-40 (1/d = inf) on every
    third lane (``case == "tiny"``), or pointing up every axis (``inside``:
    the chains' stack-filling rays)."""
    o, d, tmax = _walk_rays(box, n, anyhit, dev, seed=seed)
    if inside:
        d = d.abs() + 0.05
        d = d / d.norm(dim=1, keepdim=True)
    if case == "tiny":
        d[::3, seed % 3] = 1e-40
    return o, d.contiguous(), tmax


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sponza", "tiny", "deep"])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("anyhit", [False, True])
def test_packet_walk_new_equals_twin_and_old(dev, packet_walk_cases,
                                             packet_variants, case, rows,
                                             anyhit):
    """The packet walk from the root (group_walk_kernel<., rows>) against
    its plain twin and against the old walk (walk_kernel's loop,
    tools/packet_walk_variants.cu), bit for bit: on the scene, with 1e-40
    direction components, and on a chain at the stack cap."""
    nodes, leaf_rows, recs, box, inside = packet_walk_cases[
        rows, "deep" if case == "deep" else "sponza"]
    args = [nodes, leaf_rows, *_case_rays(box, 20000, anyhit, dev, case,
                                          inside), recs]
    packet.reset_launches()
    got = packet.packet_traverse_wide(*args, anyhit=anyhit)
    mode = "packet8_anyhit" if anyhit else "packet8_wide"
    assert packet.launches[mode] == sum(packet.launches.values()) == 1
    want = packet.packet_traverse_wide_reference(*args, anyhit=anyhit)
    old = packet_variants.run("old", *args, anyhit=anyhit)
    torch.cuda.synchronize()
    packet_variants.compare("twin", got, want)
    packet_variants.compare("old", got, old)
    assert (got[1] >= 0).any() or (anyhit and (got[0] < -1.0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["regs_free", "regs72", "regs64", "regs56",
                                  "regs48", "while_while"])
@pytest.mark.parametrize("rows", [1, 2])
def test_packet_walk_pins_match(dev, packet_walk_cases, packet_variants,
                                name, rows):
    """The register pins and the while-while order that
    tools/measure_packet_walk.py times compute exactly what the shipped
    walk computes."""
    nodes, leaf_rows, recs, box, _ = packet_walk_cases[rows, "sponza"]
    for anyhit in (False, True):
        args = [nodes, leaf_rows, *_walk_rays(box, 20000, anyhit, dev), recs]
        packet_variants.compare(
            name, packet_variants.run(name, *args, anyhit=anyhit),
            packet.packet_traverse_wide(*args, anyhit=anyhit))


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


@pytest.fixture(scope="module")
def emit_variants(dev):
    """tools/emit_walk_variants.py: the enumeration walk before its
    redesign (walk_kernel's emit mode) and emit_walk_kernel's variants."""
    return _tools_module("emit_walk_variants")


def _emit_rays(scene, n, seed=11):
    """Rays from inside the scene; every 13th direction component 1e-40
    (a subnormal: its inverse overflows to inf), inactive and clipped
    lanes."""
    o, d, tmax = _rays(scene, n, False, seed)
    d = d.clone()
    d[::13, 0] = 1e-40
    d[5::13, 2] = -1e-40
    return o, d.contiguous(), tmax


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [1, 16, 120, 300, 400])
@pytest.mark.parametrize("n", [1, 129, 20000])
def test_emit_walk_equals_twin_and_old(dev, scene, emit_variants, top_k, n):
    """emit_walk_kernel bit for bit against its plain twin and the walk it
    replaced, at top_k 1 and 16 (blocks of 128 staging their rows), 120
    (64), 300 (32) and 400 (past the staging: rows in place), overflow
    included."""
    o, d, tmax = _emit_rays(scene, n)
    args = [scene.cwide_packed, scene.cwide_packed, o, d, tmax, 8]
    packet.reset_launches()
    slots, ovf = packet.packet_traverse_wide(*args, top_k=top_k,
                                             emit_leaves=True)
    assert packet.launches["packet8_emit"] == 1
    rslots, rovf = packet.packet_traverse_wide_reference(
        *args, top_k=top_k, emit_leaves=True)
    old = emit_variants.run("old", scene.cwide_packed, o, d, tmax, top_k)
    torch.cuda.synchronize()
    assert torch.equal(slots, rslots) and torch.equal(ovf, rovf)
    emit_variants.compare(f"old at top_k {top_k}", (slots, ovf), old)
    if n == 20000:
        assert (slots >= 0).any()
        assert (ovf > 0).any() or top_k > 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["shipped_copy", "fminf_select_minmax",
                                  "stack_local", "push_ids", "rows_in_place",
                                  "regs_free", "regs64", "regs48", "regs40",
                                  "none"])
@pytest.mark.parametrize("top_k", [3, 16])
def test_emit_walk_variants_match(dev, scene, emit_variants, name, top_k):
    o, d, tmax = _emit_rays(scene, 5000)
    want = packet.packet_traverse_wide(
        scene.cwide_packed, scene.cwide_packed, o, d, tmax, 8, top_k=top_k,
        emit_leaves=True)
    emit_variants.compare(name, emit_variants.run(
        name, scene.cwide_packed, o, d, tmax, top_k), want)


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
        kw = dict(top_k=5, troot=scene.wide_troot, wide_top=scene.wide_top)
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
    kw.pop("wide_top", None)
    want = packet.packet_traverse_wide_reference(*args, anyhit=anyhit, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (4 if start == "top" else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any() or (anyhit and (got[0] < -1.0).any())
    if start == "top":
        assert (got[2] >= 0).any()


@pytest.fixture(scope="module")
def top_variants(dev):
    """tools/top_walk_variants.py: the TOP walk before its redesign
    (walk_kernel's TOP mode) and top_walk_kernel's variants."""
    return _tools_module("top_walk_variants")


@pytest.fixture(scope="module")
def top_cases(dev, scene, scene16):
    """(nodes, troot, TOP table, leaf_rows, max_recs, rays box, inside) of
    the TOP walk's cases: the scene with one- and two-row slots, and a
    loose chain whose top level is as deep as the TOP walk's stack, whose
    rays from its middle pointing up x fill it (``inside``)."""
    from ray_tracer_tpu_torch.scene import builder

    out = {}
    for rows, sc in ((1, scene), (2, scene16)):
        assert sc.meta["n_treelets"] > 0
        out[rows, "sponza"] = (sc.wide_packed, sc.wide_troot, sc.wide_top,
                               sc.leaf_rows, sc.meta["wide_leaf_recs"],
                               sc.bvh_packed[0].cpu(), False)
        nodes, leaf_rows = deep_chain(bvh8.TOP_STACK + 64, loose=True,
                                      rows=rows)
        troot = builder.treelet_roots(nodes)
        top = builder.top_table(nodes, troot)
        assert top.shape[0] == bvh8.TOP_STACK
        out[rows, "deep"] = (*(torch.from_numpy(x).to(dev) for x in (
            nodes, troot, top, leaf_rows)), 8 * rows,
            torch.tensor([-0.1] * 3 + [0.1] * 3), True)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [1, 5, 16, 120])
@pytest.mark.parametrize("case", ["sponza", "tiny", "deep"])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("anyhit", [False, True])
def test_top_walk_equals_twin_and_old(dev, top_cases, top_variants, top_k,
                                      case, rows, anyhit):
    """top_walk_kernel bit for bit against its twin over the TOP table,
    against the plain walk over the (W,128) rows and troot, and against the
    walk it replaced (walk_kernel's TOP mode, tools/top_walk_variants.cu):
    at top_k 1, 5, 16 (blocks of 128 staging their rows) and 120 (64),
    overflow included, on one- and two-row slots, with 1e-40 direction
    components (``tiny``) and on a chain whose top level fills the
    stack."""
    nodes, troot, top, leaf_rows, recs, box, inside = top_cases[
        rows, "deep" if case == "deep" else "sponza"]
    o, d, tmax = _case_rays(box, 20000, anyhit, dev, case, inside)
    args = [nodes, leaf_rows, o, d, tmax, recs]
    packet.reset_launches()
    got = packet.packet_traverse_wide(*args, anyhit=anyhit, top_k=top_k,
                                      troot=troot, wide_top=top)
    mode = "packet8_top" + ("_anyhit" if anyhit else "")
    assert packet.launches[mode] == sum(packet.launches.values()) == 1
    twin = bvh8.top_walk_reference(top, leaf_rows, o, d, tmax, anyhit, rows,
                                   top_k)
    plain = packet.packet_traverse_wide_reference(
        *args, anyhit=anyhit, top_k=top_k, troot=troot)
    old = top_variants.run("old", nodes, troot, top, leaf_rows, o, d, tmax,
                           recs, top_k, anyhit=anyhit)
    torch.cuda.synchronize()
    top_variants.compare("twin", got, twin)
    top_variants.compare("plain", got, plain)
    top_variants.compare("old", got, old)
    assert (got[2] >= 0).any()
    assert (got[3] > 0).any() or top_k > 1 or case == "deep"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["shipped_copy", "troot_gathers",
                                  "fminf_select_minmax", "every_record",
                                  "stack_local", "stack96", "rows_in_place",
                                  "regs_free", "regs72", "regs56", "regs48",
                                  "smem_table", "none"])
@pytest.mark.parametrize("top_k", [3, 16])
def test_top_walk_variants_match(dev, top_cases, top_variants, name, top_k):
    """Every variant that tools/measure_top_walk.py times computes exactly
    what the shipped kernel computes, closest hit and occlusion."""
    nodes, troot, top, leaf_rows, recs, box, _ = top_cases[1, "sponza"]
    for anyhit in (False, True):
        o, d, tmax = _case_rays(box, 5000, anyhit, dev, "tiny")
        want = packet.packet_traverse_wide(
            nodes, leaf_rows, o, d, tmax, recs, anyhit=anyhit, top_k=top_k,
            troot=troot, wide_top=top)
        top_variants.compare(name, top_variants.run(
            name, nodes, troot, top, leaf_rows, o, d, tmax, recs, top_k,
            anyhit=anyhit), want)


@pytest.mark.gpu
def test_top_walk_needs_the_table(dev, scene):
    """On the card the TOP walk raises without the scene's TOP table, or
    with an empty one (a scene beyond the walk's limits)."""
    args = [scene.wide_packed, scene.leaf_rows, *_rays(scene, 100, False),
            scene.meta["wide_leaf_recs"]]
    with pytest.raises(ValueError, match="compile()"):
        packet.packet_traverse_wide(*args, top_k=5, troot=scene.wide_troot)
    with pytest.raises(ValueError, match="limits"):
        packet.packet_traverse_wide(
            *args, top_k=5, troot=scene.wide_troot,
            wide_top=scene.wide_top[:0])


@pytest.fixture(scope="module")
def deep_variants(dev):
    """tools/deep_walk_variants.py: the DEEP walk before its redesign."""
    return _tools_module("deep_walk_variants")


@pytest.mark.gpu
@pytest.mark.parametrize("start", ["treelet_roots", "any_nodes"])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("anyhit", [False, True])
def test_deep_walk_matches_plain_version(dev, scene, scene16, deep_variants,
                                         start, rows, anyhit):
    """deep_walk_kernel, bit for bit against its twin, over one- and
    two-row leaf slots, from lists of treelet roots (the route's) or of
    any wide nodes (nested ones too), the root in every third list, with
    inactive lanes; and against the walk it replaced (old_deep_kernel of
    tools/deep_walk_variants.cu), bit for bit too."""
    sc = scene if rows == 1 else scene16
    assert (sc.meta["wide_leaf_recs"] > 8) == (rows == 2)
    n_packets, packet_size, deep_e = 10, 2048, 16
    rand = np.random.default_rng(4)
    if start == "treelet_roots":
        pool = sc.wide_troot.nonzero()[:, 0].cpu().numpy()
    else:
        pool = np.arange(1, sc.wide_packed.shape[0])
    assert len(pool) > 0
    entries = np.full((n_packets, deep_e), -1, np.int32)
    for g in range(n_packets):
        pick = rand.permutation(pool)[:rand.integers(1, deep_e)]
        if g % 3 == 0:
            pick[0] = 0
        entries[g, rand.permutation(deep_e)[:len(pick)]] = pick
    args = [sc.wide_packed, sc.leaf_rows,
            *_rays(sc, n_packets * packet_size, anyhit),
            sc.meta["wide_leaf_recs"]]
    kw = dict(anyhit=anyhit, deep_e=deep_e,
              entries=torch.from_numpy(entries).to(dev),
              packet_size=packet_size)
    packet.reset_launches()
    got = packet.packet_traverse_wide(*args, **kw)
    mode = "packet8_deep" + ("_anyhit" if anyhit else "")
    assert packet.launches[mode] == sum(packet.launches.values()) == 1
    want = packet.packet_traverse_wide_reference(
        *args, **{k: v for k, v in kw.items() if k != "deep_e"})
    old = deep_variants.run("old", *args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    deep_variants.compare("old", got, old)
    assert (got[1] >= 0).any() or (anyhit and (got[0] < -1.0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("clipped", [False, True])
def test_narrow_walk_matches_plain_version(dev, scene, clipped):
    o, d, tmax = _rays(scene, 20000, clipped)
    args = [scene.bvh_packed, scene.bvh_axis, scene.tri_packed, o, d, tmax,
            scene.meta["bvh_root"]]
    packet.reset_launches()
    got = packet.packet_traverse(*args, scene.meta["bvh_root_word"])
    assert packet.launches["packet_narrow"] == 1
    want = packet.packet_traverse_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any()


@pytest.fixture(scope="module")
def narrow_variants(dev):
    """tools/narrow_walk_variants.py: the narrow walk before its redesign
    and the new one with each design element switched."""
    return _tools_module("narrow_walk_variants")


@pytest.fixture(scope="module")
def narrow_cases(dev, scene):
    """(tables, root, root word, rays box, inside) of the narrow walk's
    cases: the scene, and binary chains of MAX_TREE_DEPTH interior levels
    (the host's depth cap), loose (rays up every axis from the middle push
    a leaf at every level) and tight."""
    out = {"sponza": ((scene.bvh_packed, scene.bvh_axis, scene.tri_packed),
                      scene.meta["bvh_root"], scene.meta["bvh_root_word"],
                      scene.bvh_packed[0].cpu(), False)}
    for name, loose in (("chain_loose", True), ("chain", False)):
        tables = [torch.from_numpy(x) for x in binary_chain(
            packet.MAX_TREE_DEPTH, loose=loose)]
        word = packet.narrow_root_word(tables[0], tables[1], 0)
        out[name] = (tuple(t.to(dev) for t in tables), 0, word,
                     torch.tensor([-0.2] * 3 + [0.2] * 3), loose)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sponza", "tiny", "chain_loose", "chain"])
@pytest.mark.parametrize("clipped", [False, True])
def test_narrow_walk_new_equals_twin_and_old(dev, narrow_cases,
                                             narrow_variants, case, clipped):
    """The narrow walk (bvh2_walk_kernel) against its plain twin and the
    old design (tools/narrow_walk_variants.cu), all five outputs bit for
    bit: on the scene, with 1e-40 direction components, and on binary
    chains at the depth cap."""
    tables, root, word, box, inside = narrow_cases[
        "sponza" if case == "tiny" else case]
    args = [*tables, *_case_rays(box, 20000, clipped, dev, case, inside),
            root]
    packet.reset_launches()
    got = packet.packet_traverse(*args, word)
    assert packet.launches["packet_narrow"] == sum(
        packet.launches.values()) == 1
    want = packet.packet_traverse_reference(*args)
    old = narrow_variants.run("old", *args, word)
    torch.cuda.synchronize()
    narrow_variants.compare("twin", got, want)
    narrow_variants.compare("old", got, old)
    assert (got[1] >= 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["shipped_copy", "single_loop",
                                  "reload_on_pop", "two_words", "push_both",
                                  "fminf_select_minmax", "none", "regs_free",
                                  "regs80", "regs64", "regs56", "regs48",
                                  "regs40"])
def test_narrow_walk_variants_match(dev, narrow_cases, narrow_variants,
                                    name):
    """The variants that tools/measure_narrow_walk.py times compute exactly
    what the shipped kernel computes."""
    for case in ("sponza", "chain_loose"):
        tables, root, word, box, inside = narrow_cases[case]
        for clipped in (False, True):
            args = [*tables, *_case_rays(box, 20000, clipped, dev, "",
                                         inside), root, word]
            narrow_variants.compare(
                f"{name} on {case}", narrow_variants.run(name, *args),
                packet.packet_traverse(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True])
def test_rope_walk_matches_plain_version(dev, scene, anyhit):
    args = [scene.rope_streams, scene.tri_packed, scene.meta["rope_rows"],
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
    streams[:, :, 6] = 0.0  # every miss links back to row 0
    with pytest.raises(RuntimeError, match="did not end"):
        lanewalk.lanewalk_traverse(streams, scene.tri_packed,
                                   scene.meta["rope_rows"],
                                   *_rays(scene, 256, False))


@pytest.fixture(scope="module")
def rope_variants(dev):
    """tools/rope_walk_variants.py: the rope walk before its redesign, on
    the old streams, and rope_walk_kernel's variants."""
    return _tools_module("rope_walk_variants")


@pytest.fixture(scope="module")
def old_rope(scene, rope_variants):
    return rope_variants.old_streams(scene)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 129, 20000])
@pytest.mark.parametrize("anyhit", [False, True])
def test_rope_walk_equals_twin_and_old(dev, scene, rope_variants, old_rope,
                                       n, anyhit):
    """rope_walk_kernel bit for bit against its plain twin on the BOX-row
    streams and against the kernel it replaced on the old streams, 1e-40
    direction components included; the twin's stats count what it
    walked."""
    o, d, tmax = _emit_rays(scene, n)
    if anyhit:
        tmax = torch.where(tmax > 1e6, 5.0, tmax)
    args = [scene.rope_streams, scene.tri_packed, scene.meta["rope_rows"],
            o, d, tmax]
    lanewalk.reset_launches()
    dst, prim = lanewalk.lanewalk_traverse(*args, anyhit=anyhit)
    assert sum(lanewalk.launches.values()) == 1
    stats = {}
    rdst, rprim = lanewalk.lanewalk_traverse_reference(*args, anyhit=anyhit,
                                                       stats=stats)
    old = rope_variants.run("old", old_rope[0], scene.tri_packed,
                            old_rope[1], o, d, tmax, anyhit=anyhit)
    torch.cuda.synchronize()
    assert torch.equal(dst, rdst) and torch.equal(prim, rprim)
    rope_variants.compare(f"old, anyhit {anyhit}", (dst, prim), old)
    assert stats["box"] >= int((tmax > -BIG / 2).sum())
    if n == 20000:
        assert (prim >= 0).any() or (anyhit and (dst < -1.0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["shipped_copy", "baseline", "one_row",
                                  "rows64", "leaf_in_one_step",
                                  "fminf_select_minmax", "while_while",
                                  "prefetch_next", "branch_first",
                                  "regs_free", "regs64", "regs48", "regs40",
                                  "none", "branch_pair"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_rope_walk_variants_match(dev, scene, rope_variants, old_rope, name,
                                  anyhit):
    o, d, tmax = _emit_rays(scene, 5000)
    rows = scene.meta["rope_rows"]
    want = lanewalk.lanewalk_traverse(scene.rope_streams, scene.tri_packed,
                                      rows, o, d, tmax, anyhit=anyhit)
    streams, n_rows = ((old_rope if name in rope_variants.OLD_LAYOUT
                        else (scene.rope_streams, rows)))
    rope_variants.compare(name, rope_variants.run(
        name, streams, scene.tri_packed, n_rows, o, d, tmax,
        anyhit=anyhit), want)


@pytest.mark.gpu
def test_rope_walk_error_flag_is_read_by_the_caller(dev, scene):
    """With a flag of the caller's, the walk ORs into it and raises
    nothing; the flag stays set across calls until the caller reads and
    clears it."""
    streams = scene.rope_streams.clone()
    streams[:, :, 6] = float(scene.meta["rope_rows"])  # misses leave it
    flag = lanewalk.error_flag(dev)
    args = [scene.tri_packed, scene.meta["rope_rows"],
            *_rays(scene, 256, False)]
    lanewalk.lanewalk_traverse(scene.rope_streams, *args, err=flag)
    assert int(flag.item()) == 0
    lanewalk.lanewalk_traverse(streams, *args, err=flag)
    lanewalk.lanewalk_traverse(scene.rope_streams, *args, err=flag)
    assert int(flag.item()) == 1
    with pytest.raises(RuntimeError, match="left its stream"):
        lanewalk.raise_on_flag(int(flag.item()), scene.meta["rope_rows"])


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
    return _tools_module("cluster_test_variants")


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


def _card_vs_cpu(gpu, cpu):
    """The card's image against the CPU's: chip_smoke.py's thresholds
    (>= 99% of pixels within 2e-3, mean |diff| < 1e-3)."""
    assert gpu.device.type == "cuda" and bool(torch.isfinite(gpu).all())
    diff = (gpu.cpu() - cpu).abs()
    assert float((diff.amax(dim=-1) <= 2e-3).float().mean()) >= 0.99
    assert float(diff.mean()) < 1e-3


@pytest.mark.gpu
def test_progressive_on_card_matches_cpu(dev, scene, tmp_path):
    """Two progressive steps at 64x36 on the card against the CPU's; the
    state saved on the card resumes on the card."""
    cfg = trt.RenderConfig(width=64, height=36, samples_per_pixel=2,
                           bounce_limit=8)
    card = trt.ProgressiveRenderer(scene, cfg)
    host = trt.ProgressiveRenderer(scene.to("cpu"), cfg)
    group.reset_launches()
    for _ in range(2):
        card.step()
        host.step()
    assert card.accum.device.type == "cuda"
    assert group.launches["group_traverse"] > 0
    _card_vs_cpu(card.accum, host.accum)
    path = str(tmp_path / "state.npz")
    card.save_state(path)
    resumed = trt.ProgressiveRenderer(scene, cfg)
    resumed.load_state(path)
    assert resumed.accum.device.type == "cuda"
    assert torch.equal(resumed.accum, card.accum)


@pytest.mark.gpu
@pytest.mark.parametrize("estimator", ["mis", "cosine", "uniform"])
def test_static_scan_on_card_matches_cpu(dev, scene, estimator):
    cfg = trt.RenderConfig(width=64, height=36, samples_per_pixel=2,
                           bounce_limit=8, path_regen=False,
                           estimator=estimator)
    group.reset_launches()
    gpu = trt.render(scene, cfg)
    torch.cuda.synchronize()
    assert group.launches["group_traverse"] > 0
    if estimator == "mis":
        assert group.launches["group_anyhit"] > 0
    _card_vs_cpu(gpu, trt.render(scene.to("cpu"), cfg))


@pytest.mark.gpu
def test_debug_heatmap_on_card_matches_cpu(dev, scene):
    """The counting walk's box and triangle counts on the card against
    the CPU's, at 64x36, spp 1."""
    from ray_tracer_tpu_torch.api import debug_counts

    cfg = trt.RenderConfig(width=64, height=36, samples_per_pixel=1,
                           bounce_limit=8)
    gb, gt = (x.cpu() for x in debug_counts(scene, cfg))
    cb, ct = debug_counts(scene.to("cpu"), cfg)
    assert float(cb.mean()) > 10
    assert float((gb != cb).float().mean()) <= 0.01
    assert float((gt != ct).float().mean()) <= 0.01
    img = trt.render_debug(scene, cfg, mode=2)
    assert img.device.type == "cuda" and img.shape == (36, 64, 3)


GPU_VALUES = {  # the wavefront's configuration values
    "bin_leaf": dict(routing=trt.Routing(bin_mode="leaf")),
    "bin_hier": dict(routing=trt.Routing(bin_mode="hier")),
    "prebin_sort": dict(routing=trt.Routing(nee_prebin="sort")),
    "prebin_nosort": dict(routing=trt.Routing(nee_prebin="nosort")),
    "unbinned": dict(bin_rays=False),
    "closest_nee": dict(nee_anyhit=False),
    "closest_nee_static": dict(nee_anyhit=False, path_regen=False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("value", list(GPU_VALUES))
def test_config_value_on_card_matches_cpu(dev, scene, value):
    """Each configuration value at 64x36 on the card against the CPU; the
    re-ordering values equal the card's default image bit for bit."""
    cfg = trt.RenderConfig(width=64, height=36, samples_per_pixel=2,
                           bounce_limit=8)
    kw = GPU_VALUES[value]
    group.reset_launches()
    gpu = trt.render(scene, cfg.replace(**kw))
    torch.cuda.synchronize()
    assert group.launches["group_traverse"] > 0
    _card_vs_cpu(gpu, trt.render(scene.to("cpu"), cfg.replace(**kw)))
    if "nee_anyhit" not in kw:
        assert torch.equal(gpu, trt.render(scene, cfg))


@pytest.fixture(scope="module")
def forest_scene(dev):
    return presets.sponza_proxy(n_tris_target=8000).compile(
        flatten_instances=False)


def _forest_cut(sc, instances):
    """The forest ``sc`` with its instances ``instances`` (indices, in
    order, repeats allowed: a repeated instance meets a ray at the same t
    as the first, which keeps it)."""
    import dataclasses

    pick = lambda xs: tuple(xs[k] for k in instances)
    return dataclasses.replace(
        sc, obj_inv_transform=sc.obj_inv_transform[list(instances)]
        .contiguous(),
        meta={**sc.meta, "n_objects": len(instances),
              "obj_roots": pick(sc.meta["obj_roots"]),
              "obj_root_words": pick(sc.meta["obj_root_words"]),
              "forest_cull": pick(sc.meta["forest_cull"])})


@pytest.fixture(scope="module")
def forest_cuts(forest_scene):
    """The forest of every instance, of its largest instance alone (K =
    1), and of every instance four times over (more than the 128 that a
    block stages at once)."""
    sc = forest_scene
    roots = list(sc.meta["obj_roots"])
    ext = sc.bvh_packed[roots, 3:6] - sc.bvh_packed[roots, 0:3]
    k = sc.meta["n_objects"]
    assert 4 * k > 128
    return {"all": sc, "one": _forest_cut(sc, [int(ext.prod(1).argmax())]),
            "four_times": _forest_cut(sc, list(range(k)) * 4)}


def _forest_rays(sc, n, anyhit, seed=9):
    """Rays from points across the whole forest (the union of the root
    boxes) in random directions, a lane in nine inactive."""
    rand = np.random.default_rng(seed)
    lo = sc.bvh_packed[:, 0:3].min(0).values.cpu().numpy()
    hi = sc.bvh_packed[:, 3:6].max(0).values.cpu().numpy()
    o = rand.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 1] = 0.0
    tmax = rand.uniform(0.1, 8.0, n).astype(np.float32)
    if not anyhit:
        tmax[::2] = BIG
    tmax[::9] = -BIG
    return [torch.from_numpy(x).to(sc.device) for x in (o, d, tmax)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 20000])
@pytest.mark.parametrize("cut", ["all", "one", "four_times"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_kernel_matches_plain_version(dev, forest_cuts, cut, n,
                                             anyhit):
    """forest_walk_kernel against its plain version, bit for bit, at ray
    counts around its 128-thread block, on a forest of one instance and
    on one of more instances than a block stages at once, closest hit and
    occlusion; one launch a call."""
    sc = forest_cuts[cut]
    roots, words = sc.forest_roots
    tables = (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform)
    o, d, tmax = _forest_rays(sc, n, anyhit)
    packet.reset_launches()
    got = packet.forest_traverse(*tables, roots, words, sc.forest_cull, o, d,
                                 tmax, anyhit=anyhit)
    assert packet.launches["forest_anyhit" if anyhit else "forest_walk"] == 1
    want = packet.forest_traverse_reference(
        *tables, sc.meta["obj_roots"], o, d, tmax, anyhit=anyhit)
    torch.cuda.synchronize()
    if anyhit:
        assert torch.equal(got, want)
        hit = got
    else:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        hit = got[1] >= 0
        if cut == "four_times":  # every tie goes to the first copy
            assert (got[2][hit] < sc.meta["n_objects"] // 4).all()
    if n == 20000:
        assert hit.any()


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_kernel_matches_old_composition(dev, forest_scene, anyhit):
    """The forest walk against the per-instance composition it replaced
    (tools/measure_forest_walk.py: a cuBLAS product, a narrow-walk launch
    and the merges per instance): the object-space rays round apart, so
    on these rays from open space the hits and instances equal and
    ``dst`` within rtol 1e-5, each in all but 0.1% of the rays
    (``compare_old``, whose ``dst`` budget of 1% is for rays that start on
    a surface)."""
    tool = _tools_module("measure_forest_walk")
    sc = forest_scene
    o, d, tmax = _forest_rays(sc, 20000, anyhit, seed=10)
    new = packet.forest_traverse(*tool.forest_args(sc, (o, d, tmax)),
                                 anyhit=anyhit)
    old = tool.old_forest(sc, o, d, tmax, anyhit=anyhit)
    rec = tool.compare_old("forest walk", new, old, anyhit)
    assert rec["hits_apart"] <= 1e-3
    assert rec.get("dst_apart_of_both", 0.0) <= 1e-3


def _forest_args(sc, o, d, tmax):
    """``packet.forest_traverse``'s arguments for the forest ``sc``."""
    roots, words = sc.forest_roots
    return (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform,
            roots, words, sc.forest_cull, o, d, tmax)


def _grazing(sc, n, seed, above_big=False):
    """About ``n`` rays at the corners and edges of every instance's
    world box (``torch_parity.grazing_rays``), from near and from a
    thousand box sizes away, on the scene's device.  A bound above BIG
    (1e9, inf) enters every node of every tree, in the kernel and in the
    plain walk, whose steps then number the trees' nodes: unless
    ``above_big``, such bounds become BIG."""
    rand = np.random.default_rng(seed)
    tables = (sc.obj_inv_transform.cpu().numpy(),
              sc.bvh_packed.cpu().numpy(), list(sc.meta["obj_roots"]))
    per = max(8, n // len(tables[2]))
    near = grazing_rays(*tables, per, rand, 4.0)
    far = grazing_rays(*tables, per // 4 + 1, rand, 1e3)
    o, d, tmax = (np.concatenate(x) for x in zip(near, far))
    if not above_big:
        tmax = np.minimum(tmax, np.float32(BIG))
    return [torch.from_numpy(x).to(sc.device) for x in (o, d, tmax)]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("cut", ["all", "one", "four_times"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_kernel_on_grazing_rays(dev, forest_cuts, cut, anyhit):
    """Rays that graze every instance's world-box corners and edges, each
    component moved by an ulp, with best t at or below 0, at BIG and above
    it (on the forest of one instance: ``_grazing``): the culling kernel
    equals its plain version bit for bit, and its audit instance finds no
    instance culled whose root test passes, and culls."""
    sc = forest_cuts[cut]
    rays = _grazing(sc, 4000, seed=21, above_big=cut == "one")
    args = _forest_args(sc, *rays)
    got = packet.forest_traverse(*args, anyhit=anyhit)
    want = packet.forest_traverse_reference(
        *args[:4], sc.meta["obj_roots"], *rays, anyhit=anyhit)
    out, counts = packet.forest_audit(*args, anyhit=anyhit)
    torch.cuda.synchronize()
    for a, b, c in zip(_as_tuple(got), _as_tuple(want), _as_tuple(out)):
        assert torch.equal(a, b) and torch.equal(c, b)
    assert counts["violations"] == 0, counts
    assert counts["root_pass"] <= counts["world_pass"] <= counts["scans"]
    if cut != "one":  # every ray is aimed at one of the instances
        assert counts["world_pass"] < counts["scans"], counts


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 3000])
@pytest.mark.parametrize("cut", ["all", "one", "four_times"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_audit_counts(dev, forest_cuts, cut, n, anyhit):
    """The audit instance (forest_walk_kernel<., true>) against its plain
    version on the card, every counter equal; its scans, box and triangle
    tests equal to the plain walk's ``stats``, no violation, its outputs
    the kernel's, and no launch counted."""
    sc = forest_cuts[cut]
    o, d, tmax = _forest_rays(sc, n, anyhit, seed=22)
    args = _forest_args(sc, o, d, tmax)
    packet.reset_launches()
    out, counts = packet.forest_audit(*args, anyhit=anyhit)
    assert not any(packet.launches.values())
    got = packet.forest_traverse(*args, anyhit=anyhit)
    plain, plain_counts = packet.forest_audit_reference(
        *args[:4], sc.meta["obj_roots"], sc.forest_cull, o, d, tmax,
        anyhit=anyhit)
    stats = {}
    packet.forest_traverse_reference(*args[:4], sc.meta["obj_roots"], o, d,
                                     tmax, anyhit=anyhit, stats=stats)
    torch.cuda.synchronize()
    for a, b, c in zip(_as_tuple(out), _as_tuple(got), _as_tuple(plain)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert counts == plain_counts
    assert {k: counts[k] for k in ("scans", "boxes", "tris")} == {
        k: stats[k] for k in ("scans", "boxes", "tris")}
    assert counts["violations"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["old", "flat_best", "flat",
                                     "blocks6_flat", "flat_mask",
                                     "tree_shared", "shipped_copy",
                                     "blocks6"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_walk_variants(dev, forest_cuts, variant, anyhit):
    """Each variant of tools/forest_walk_variants.cu (the kernel before
    the cull; the flat cull in the instance loop, with and without its
    test on the best t, at six blocks an SM; the flat cull into a mask;
    the chunk trees staged in shared memory; the shipped kernel's copy, at
    eight and six blocks an SM) equals the shipped kernel bit for bit, on
    forest rays and grazing rays, with K of 39 and of 156 (two chunks)."""
    tool = _tools_module("forest_walk_variants")
    for cut in ("all", "four_times"):
        sc = forest_cuts[cut]
        rows = tool.scene_rows(sc)
        for rays in (_forest_rays(sc, 20000, anyhit, seed=23),
                     _grazing(sc, 4000, seed=24)):
            args = _forest_args(sc, *rays)
            tool.compare(f"{variant}, {cut}",
                         tool.run(variant, *args, anyhit=anyhit, rows=rows),
                         packet.forest_traverse(*args, anyhit=anyhit))


@pytest.mark.gpu
@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_walk_on_card_matches_cpu(dev, forest_scene, anyhit):
    """The forest walk (one forest_walk_kernel launch, every instance in
    object space) against the same walk on the CPU (its plain version):
    the transforms are elementwise in a fixed order on both, so every
    field of the hit, and the occlusion mask, equal bit for bit."""
    from ray_tracer_tpu_torch.ops import traverse

    sc = forest_scene
    o, d, tmax = _rays(sc, 20000, anyhit, seed=9)
    act = tmax > -BIG
    tmax = torch.where(act, tmax, BIG)
    cpu = sc.to("cpu")
    args = [x.cpu() for x in (o, d, act, tmax)]
    packet.reset_launches()
    if anyhit:
        got = traverse.traverse_anyhit(sc, o, d, act, tmax)
        want = traverse.traverse_anyhit(cpu, *args)
        assert torch.equal(got.cpu(), want) and want.any()
    else:
        got = traverse.traverse(sc, o, d, act, tmax=tmax)
        want = traverse.traverse(cpu, *args[:3], tmax=args[3])
        assert want.did_hit.any()
        for name, a, b in zip(traverse.Hit._fields, got, want):
            assert torch.equal(a.cpu(), b), name
    assert packet.launches["packet_narrow"] == 0
    assert packet.launches["forest_anyhit" if anyhit else "forest_walk"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("value", ["wavefront", "closest_nee", "static",
                                   "unbinned"])
def test_forest_render_on_card_matches_cpu(dev, forest_scene, value):
    kw = {"wavefront": {}, "closest_nee": dict(nee_anyhit=False),
          "static": dict(path_regen=False), "unbinned": dict(bin_rays=False),
          }[value]
    cfg = trt.RenderConfig(width=32, height=18, samples_per_pixel=2,
                           bounce_limit=8, **kw)
    packet.reset_launches()
    gpu = trt.render(forest_scene, cfg)
    torch.cuda.synchronize()
    assert packet.launches["forest_walk"] > 0
    assert packet.launches["packet_narrow"] == 0
    _card_vs_cpu(gpu, trt.render(forest_scene.to("cpu"), cfg))


@pytest.mark.gpu
def test_normal_maps_on_card_match_cpu(dev, tmp_path):
    """A bump-mapped quad (a generated height map) on the card against
    the CPU, both integrators."""
    from torch_parity import bump_scene, uphill

    b = bump_scene(trt, str(tmp_path), uphill)
    sc, cpu = b.compile(), b.compile(device="cpu")
    for regen in (True, False):
        cfg = trt.RenderConfig(width=25, height=23, samples_per_pixel=4,
                               bounce_limit=2, enable_normal_maps=True,
                               bump_scale=4.0, path_regen=regen)
        _card_vs_cpu(trt.render(sc, cfg), trt.render(cpu, cfg))


@pytest.mark.gpu
def test_dryrun_on_card(dev):
    """The port's dry run with one NCCL rank on the card."""
    from ray_tracer_tpu_torch.parallel import entry

    summary = entry.dryrun_multichip(1, timeout=300)
    assert summary["meshes"] == [[1, 1]]


@pytest.fixture(scope="module")
def round_scenes(dev, tmp_path_factory):
    """The scenes of tests/test_torch_shade.py on the card: the textured
    ones run the shade kernel's maps instance, the forests the forest
    walk."""
    from torch_parity import (bump_scene, maps_scene, room_scene,
                              sphere_maps_scene, uphill)

    tmp = str(tmp_path_factory.mktemp("rounds"))
    return {
        "sponza": presets.sponza_proxy(n_tris_target=20000).compile(),
        "spheres": presets.sphere_diffuse().compile(),
        "room": room_scene(trt, tmp).compile(),
        "maps": maps_scene(trt, tmp, ("albedo", "metal", "alpha")).compile(),
        "bump": bump_scene(trt, tmp, uphill).compile(),
        "bump_bilinear": bump_scene(trt, tmp, uphill, sampler=1).compile(),
        "sphere_maps": sphere_maps_scene(trt, tmp).compile(),
        "room_forest": room_scene(trt, tmp).compile(flatten_instances=False),
        "maps_forest": maps_scene(trt, tmp, ("albedo", "metal", "alpha"))
        .compile(flatten_instances=False),
        "sponza_forest": presets.sponza_proxy(n_tris_target=20000).compile(
            flatten_instances=False),
    }


# the configuration values each scene is rendered with
SCENE_CFG = {name: dict(enable_normal_maps=True, bump_scale=4.0)
             for name in ("bump", "bump_bilinear")}
TEXTURED = ("maps", "bump", "bump_bilinear", "sphere_maps")


def _round_cases(names):
    return [
        pytest.param(name, space, n_lights, space == "tri", n_lights != 1,
                     id=f"{name}-{space}-{n_lights}")
        for name in names
        for space in ("slot", "tri") for n_lights in (0, 1, 2)
    ]


ROUND_CASES = _round_cases(("sponza", "spheres", "room"))
FORESTS = ("room_forest", "maps_forest", "sponza_forest")


def _round_launches(sc, cfg, rounds):
    """The round kernels' launch counts of ``rounds`` fused rounds: the
    shade kernel's maps instance where textures are in use, else the
    untextured one."""
    from ray_tracer_tpu_torch.kernels import shade

    maps = shade.maps_on(sc, cfg)
    return {"shade_round": 0 if maps else rounds,
            "shade_round_maps": rounds if maps else 0,
            "permute_rows": rounds, "nee_resolve": rounds}


def _same_all(got, want, what):
    from torch_parity import same_values

    for k, (a, b) in enumerate(zip(got, want)):
        assert same_values(a, b), f"{what}: output {k} differs"


@pytest.mark.gpu
@pytest.mark.parametrize("name,space,n_lights,jitter,tint",
                         ROUND_CASES + _round_cases(TEXTURED)
                         + _round_cases(FORESTS))
def test_round_kernels_match_plain_versions(dev, round_scenes, name, space,
                                            n_lights, jitter, tint):
    """Every round of a 64x36 frame: shade_kernel (on the textured scenes
    its maps instance), permute_kernel and nee_resolve_kernel each against
    its plain version on the same inputs (equal values, NaN equal to NaN),
    then the frame on the card through the kernels against the torch
    round's, bit for bit.  The shade kernel's key is ``shading.bin_key``'s
    (on the forests with the morton bits of the forest's world box), and
    the runs the permute kernel adds to the tally's fourth word equal the
    plain version's and the distinct live keys torch counts (on the
    textured scenes the tally's fifth word is the cutout lanes, held to
    the plain version's with the shade kernel's other outputs)."""
    from ray_tracer_tpu_torch.integrator import shading, wavefront
    from ray_tracer_tpu_torch.kernels import shade
    from ray_tracer_tpu_torch.ops import traverse
    from torch_parity import first_wave, with_lights

    sc = with_lights(round_scenes[name], n_lights)
    routing = trt.Routing(wide=space == "slot")
    cfg = trt.RenderConfig(width=64, height=36, samples_per_pixel=2,
                           bounce_limit=8, routing=routing,
                           aa_jitter=jitter, tint_spec_diel=tint,
                           **SCENE_CFG.get(name, {}))
    c, round_, w = first_wave(sc, cfg)
    assert round_ is wavefront._fused_round
    assert shading.morton_bits(sc) == (name not in ("spheres",
                                                    "sphere_maps"))
    shade.reset_launches()
    rounds = 0
    while int(w.n_alive) > 0:
        out = shade.shade_round(c, w)
        _same_all(out, shade.shade_round_reference(c, w), "shade")
        skey, order = torch.sort(out[1], stable=True)
        runs, want_runs = out[2][3:4], out[2][3:4].clone()
        lanes = shade.permute_rows(out[0], order, skey, runs)
        _same_all(lanes, shade.permute_rows_reference(out[0], order, skey,
                                                      want_runs), "permute")
        live_keys = out[1][out[1] != shading.DEAD_KEY]
        assert int(runs) == int(want_runs) == live_keys.unique().numel()
        occluded = None
        if sc.n_lights:
            occluded = traverse.traverse_anyhit(
                sc, lanes.nee_origin, lanes.l_dir, lanes.nee_active,
                lanes.l_dist * (1.0 - 1e-3), routing=routing)
        _same_all([shade.nee_resolve(sc, lanes, occluded)],
                  [shade.nee_resolve_reference(sc, lanes, occluded)], "nee")
        w = wavefront._fused_round(c, w)
        rounds += 1
    torch.cuda.synchronize()
    assert shade.launches == _round_launches(sc, cfg, 2 * rounds)
    img = trt.render(sc, cfg)
    wavefront_ok = wavefront._fused_round_ok
    try:
        wavefront._fused_round_ok = lambda *a: False
        want = trt.render(sc, cfg)
    finally:
        wavefront._fused_round_ok = wavefront_ok
    assert torch.equal(img, want)


def _checked_frame(sc, cfg, monkeypatch, old=None):
    """One frame through ``render`` on the card with every call of the
    round kernels' wrappers held, bit for bit, against its plain version
    on the same inputs (and, given ``old``, tools/shade_round_variants.py,
    the shade kernel against the one it replaced), then against the frame
    of the torch round.  Returns the widths of the shade calls."""
    from ray_tracer_tpu_torch.integrator import wavefront
    from ray_tracer_tpu_torch.kernels import shade
    from torch_parity import same_bits

    def same(got, want, what):
        for k, (a, b) in enumerate(zip(got, want)):
            assert same_bits(a, b), f"{what}: output {k} differs"

    kernels = {k: getattr(shade, k)
               for k in ("shade_round", "permute_rows", "nee_resolve")}
    widths = []

    def shade_round(c, w):
        out = kernels["shade_round"](c, w)
        same(out, shade.shade_round_reference(c, w), "shade")
        if old is not None:
            same(out, old.run("old", c, w), "shade against the old kernel")
        widths.append(int(w.origin.shape[0]))
        return out

    def permute_rows(packed, order, skey, runs):
        want_runs = runs.clone()
        out = kernels["permute_rows"](packed, order, skey, runs)
        same(out, shade.permute_rows_reference(packed, order, skey,
                                               want_runs), "permute")
        assert torch.equal(runs, want_runs)
        return out

    def nee_resolve(*args):
        out = kernels["nee_resolve"](*args)
        same([out], [shade.nee_resolve_reference(*args)], "nee")
        return out

    with monkeypatch.context() as patch:
        for fn in (shade_round, permute_rows, nee_resolve):
            patch.setattr(shade, fn.__name__, fn)
        shade.reset_launches()
        img = trt.render(sc, cfg)
        torch.cuda.synchronize()
        assert shade.launches == _round_launches(sc, cfg, len(widths))
        patch.setattr(wavefront, "_fused_round_ok", lambda *a: False)
        want = trt.render(sc, cfg)
    assert torch.equal(img, want)
    return widths


# frame sizes whose lanes leave a partial last block of 256 (63x35 at spp
# 2: 4,410 lanes), fill less than one (17x15: 255; 1x1: 1), or drain from
# 32,768 lanes to 8,192 (128x128 at spp 2 on sponza; on the sphere scene
# the last 8,192 or more paths all end in one round, so it never drains),
# with the widths each frame's shade calls take
RAGGED = [
    pytest.param(name, n_lights, w, h, spp, lanes,
                 id=f"{name}-{n_lights}-{w}x{h}-spp{spp}")
    for name, n_lights, drained in (("sponza", 2, (32768, 8192)),
                                    ("spheres", 0, (32768,)),
                                    ("maps", 1, (32768, 8192)),
                                    ("bump_bilinear", 1, (32768, 8192)))
    for w, h, spp, lanes in ((63, 35, 2, (4410,)), (17, 15, 1, (255,)),
                             (1, 1, 1, (1,)), (128, 128, 2, drained))
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_lights,width,height,spp,lanes", RAGGED)
def test_round_kernels_on_ragged_widths(dev, round_scenes, monkeypatch, name,
                                        n_lights, width, height, spp, lanes):
    """Every round of frames whose widths are no multiple of the shade
    kernel's 256-lane tiles: each round kernel (on the textured scenes the
    shade kernel's maps instance) against its plain version, bit for bit,
    and the frame against the torch round's."""
    from torch_parity import with_lights

    sc = with_lights(round_scenes[name], n_lights)
    cfg = trt.RenderConfig(width=width, height=height, samples_per_pixel=spp,
                           bounce_limit=8, **SCENE_CFG.get(name, {}))
    widths = _checked_frame(sc, cfg, monkeypatch)
    assert sorted(set(widths), reverse=True) == list(lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("name", TEXTURED + ("maps_forest",))
def test_textured_frame_equals_the_torch_round(dev, round_scenes,
                                               monkeypatch, name):
    """A textured 240x136 frame (spp 2, bounce limit 8) through the round
    kernels, the maps instance once a round, renders bit-identical to the
    same frame through the torch round (the textured forest too)."""
    from ray_tracer_tpu_torch.integrator import wavefront
    from ray_tracer_tpu_torch.kernels import shade

    sc = round_scenes[name]
    cfg = trt.RenderConfig(width=240, height=136, samples_per_pixel=2,
                           bounce_limit=8, **SCENE_CFG.get(name, {}))
    assert wavefront._fused_round_ok(sc, cfg, cfg.resolved_routing())
    shade.reset_launches()
    img = trt.render(sc, cfg)
    torch.cuda.synchronize()
    rounds = shade.launches["shade_round_maps"]
    assert rounds > 0
    assert shade.launches == _round_launches(sc, cfg, rounds)
    monkeypatch.setattr(wavefront, "_fused_round_ok", lambda *a: False)
    shade.reset_launches()
    want = trt.render(sc, cfg)
    assert sum(shade.launches.values()) == 0
    assert torch.equal(img, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("room_forest", "sponza_forest"))
def test_forest_frame_is_the_same_under_the_octant_key(dev, round_scenes,
                                                      name):
    """A forest's 240x136 frame through the round kernels with the morton
    key and with the octant key alone (``bin_bits=0``): the lanes' order
    differs, the image is the same bit for bit."""
    sc = round_scenes[name]
    cfg = trt.RenderConfig(width=240, height=136, samples_per_pixel=2,
                           bounce_limit=8)
    img = trt.render(sc, cfg)
    octant = trt.render(sc, cfg.replace(routing=trt.Routing(bin_bits=0)))
    assert img.mean() > 0.01
    assert torch.equal(img, octant)


@pytest.fixture(scope="module")
def shade_variants(dev):
    """tools/shade_round_variants.py: the shade kernel before its redesign
    and the new one with each design element switched."""
    return _tools_module("shade_round_variants")


@pytest.mark.gpu
@pytest.mark.parametrize("name,space,n_lights,jitter,tint", ROUND_CASES)
def test_shade_kernel_equals_the_old_kernel(dev, round_scenes, monkeypatch,
                                            shade_variants, name, space,
                                            n_lights, jitter, tint):
    """The round test's frames with the shade kernel held, every round,
    against the kernel it replaced (tools/shade_round_variants.cu::
    old_shade_kernel) and its plain version, bit for bit, the tally
    included."""
    from torch_parity import with_lights

    sc = with_lights(round_scenes[name], n_lights)
    cfg = trt.RenderConfig(width=63, height=35, samples_per_pixel=2,
                           bounce_limit=8,
                           routing=trt.Routing(wide=space == "slot"),
                           aa_jitter=jitter, tint_spec_diel=tint)
    assert _checked_frame(sc, cfg, monkeypatch, old=shade_variants)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["shipped_copy", "vector", "in_place",
                                     "eager", "persistent", "blocks3",
                                     "blocks5", "regs_free",
                                     "in_place_blocks3", "split"])
def test_shade_kernel_variants_match(dev, round_scenes, shade_variants,
                                     variant):
    """The variants that tools/measure_shade_round.py times compute
    exactly what the shipped kernel computes, on every round of a frame
    and on ragged slices of its first wave."""
    from ray_tracer_tpu_torch.integrator import wavefront
    from ray_tracer_tpu_torch.kernels import shade
    from torch_parity import first_wave, with_lights

    sc = with_lights(round_scenes["sponza"], 2)
    cfg = trt.RenderConfig(width=64, height=36, samples_per_pixel=2,
                           bounce_limit=8)
    c, _, w = first_wave(sc, cfg)
    for m in (1, 255, 257, 1000):
        part = wavefront._slice_wave(w, m)
        shade_variants.compare(f"{variant}, {m} lanes",
                               shade_variants.run(variant, c, part),
                               shade.shade_round(c, part))
    while int(w.n_alive) > 0:
        shade_variants.compare(variant, shade_variants.run(variant, c, w),
                               shade.shade_round(c, w))
        w = wavefront._fused_round(c, w)


# the widths of the permute and NEE tests: one lane, less than a warp,
# less than a block, a block and a warp's lane more, and a wide wave
# whose last warp holds three lanes
ROUND_WIDTHS = (1, 31, 255, 257, 2**18 + 3)


def _orders(n, kind, dev):
    if kind == "identity":
        return torch.arange(n, device=dev)
    if kind == "reversed":
        return torch.arange(n - 1, -1, -1, device=dev)
    rand = np.random.default_rng(n)
    return torch.from_numpy(rand.permutation(n)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
@pytest.mark.parametrize("n", ROUND_WIDTHS)
def test_permute_kernel_matches_plain_version(dev, shade_variants, n, kind):
    """permute_kernel on rows of random bits (NaN payloads, -0.0, any i32)
    against its plain version and the kernel it replaced, every column bit
    for bit, with the identity, the reversed and a random order; its count
    of the sorted keys' runs equal to the plain version's, added to what
    the word held."""
    from ray_tracer_tpu_torch.kernels import shade
    from torch_parity import random_rows, same_bits, sorted_keys

    packed = random_rows(n, seed=n, device=dev)
    order = _orders(n, kind, dev)
    skey = sorted_keys(n, seed=n, device=dev)
    runs = torch.full((1,), 7, dtype=torch.int64, device=dev)
    want_runs = runs.clone()
    shade.reset_launches()
    got = shade.permute_rows(packed, order, skey, runs)
    assert shade.launches["permute_rows"] == 1
    for name, want in (
            ("plain", shade.permute_rows_reference(packed, order, skey,
                                                   want_runs)),
            ("old", shade_variants.permute_run("old", packed, order, skey))):
        for field, a, b in zip(got._fields, got, want):
            assert same_bits(a, b), f"{name}: {field}"
    assert torch.equal(runs, want_runs) and int(runs) > 7


@pytest.mark.gpu
def test_permute_floor_gathers_the_rows(dev, shade_variants):
    """The floor that chip_smoke.py times beside permute_kernel
    (tools/shade_round_variants.cu::tma_floor_kernel) is the rows gathered
    by the order, bit for bit, on ragged widths and a random order."""
    from torch_parity import random_rows, sorted_keys

    for n in ROUND_WIDTHS:
        packed = random_rows(n, seed=n + 1, device=dev)
        order = _orders(n, "random", dev)
        skey = sorted_keys(n, seed=n, device=dev)
        shade_variants.compare(
            f"floor, {n} lanes",
            [shade_variants.permute_run("floor_tma", packed, order, skey)],
            [packed[order]])


@pytest.mark.gpu
def test_permute_rows_raises_on_unaligned_rows(dev):
    """permute_kernel's bulk copies need rows on a 16-byte boundary: the
    wrapper raises on rows 4 bytes off one and launches nothing."""
    from ray_tracer_tpu_torch.integrator import shading
    from ray_tracer_tpu_torch.kernels import shade
    from torch_parity import random_rows, sorted_keys

    n = 257
    buf = torch.empty(n * shading.ROW + 4, dtype=torch.float32, device=dev)
    packed = buf[1:1 + n * shading.ROW].view(n, shading.ROW)
    packed.copy_(random_rows(n, seed=3, device=dev))
    assert packed.data_ptr() % 16 == 4
    shade.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        shade.permute_rows(packed, _orders(n, "random", dev),
                           sorted_keys(n, device=dev),
                           torch.zeros(1, dtype=torch.int64, device=dev))
    assert shade.launches["permute_rows"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("fresh", ["all", "none", "mixed"])
@pytest.mark.parametrize("n_lights", [0, 1, 2])
@pytest.mark.parametrize("n", ROUND_WIDTHS)
def test_nee_kernel_matches_plain_version(dev, round_scenes, shade_variants,
                                          n, n_lights, fresh):
    """nee_resolve_kernel on random lanes (all, none or half of them
    fresh; NaN payloads, infinities and zeros among the values) against
    its plain version and the kernel it replaced, bit for bit, with 0, 1
    and 2 rect lights."""
    from ray_tracer_tpu_torch.kernels import shade
    from torch_parity import random_lanes, same_bits, with_lights

    sc = with_lights(round_scenes["room"], n_lights)
    lanes = random_lanes(n, n_lights, fresh, seed=n + n_lights, device=dev)
    rand = np.random.default_rng(n)
    occluded = None if n_lights == 0 else torch.from_numpy(
        rand.uniform(size=n) < 0.4).to(dev)
    shade.reset_launches()
    got = shade.nee_resolve(sc, lanes, occluded)
    assert shade.launches["nee_resolve"] == 1
    assert same_bits(got, shade.nee_resolve_reference(sc, lanes, occluded))
    assert same_bits(got, shade_variants.nee_run("old", sc, lanes, occluded))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "rope"])
def test_profiler_ranges_put_nothing_on_the_device(dev, scene, route,
                                                   monkeypatch):
    """Under ``torch.profiler`` a step's ``rt.*`` ranges stay on the host:
    no device operation carries their names, and the step issues the
    device operations, copies by kind included, of the same step with the
    ranges turned off."""
    import re
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from ray_tracer_tpu_torch.utils import trace

    cuda = torch.autograd.DeviceType.CUDA
    routing = trt.Routing(lanewalk="force") if route == "rope" else None
    cfg = trt.RenderConfig(width=320, height=180, samples_per_pixel=2,
                           bounce_limit=8, routing=routing)
    trt.ProgressiveRenderer(scene, cfg).step()  # builds the kernels

    def device_ops():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trt.ProgressiveRenderer(scene, cfg).step()
            torch.cuda.synchronize()
        events = prof.events()
        host = [e.name for e in events if e.device_type != cuda]
        # by name without template arguments: the rope read's ``cat`` may
        # take another instance for its other inputs
        return Counter(re.sub(r"<.*", "", e.name) for e in events
                       if e.device_type == cuda), host

    traced, host = device_ops()
    assert {"rt.first_wave", "rt.live_read", "rt.round", "rt.rays"} <= {
        n.split(" ")[0] for n in host}
    assert not [n for n in traced if n.startswith("rt.")]
    monkeypatch.setattr(trace, "recording", lambda: False)
    plain, _ = device_ops()
    assert traced == plain
