"""The frozen scene generator gives the program's preset, triangle for
triangle; the reference's world-space tables agree with the program's."""

import numpy as np
import pytest

from rt_bench.port_scene import builder_of
from rt_bench.reference import scene as ref_scene
from rt_bench.scenes import sponza_proxy


def test_generator_equals_the_preset_at_seed_7():
    from ray_tracer_tpu_torch.scene import presets

    spec = sponza_proxy.generate()
    ours, theirs = builder_of(spec), presets.sponza_proxy()
    assert spec.n_tris == 270_114
    assert len(spec.instances) == len(theirs.instances) == 293
    for (ga, ia), (gb, ib) in zip(ours.instances, theirs.instances):
        assert np.array_equal(ia.transform, ib.transform)
        assert (ia.material, ia.name) == (ib.material, ib.name)
        a, b = ours._groups[ga], theirs._groups[gb]
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.normals, b.normals)
        assert a.front_only == b.front_only
    assert ours.materials == theirs.materials
    assert ours.lights == theirs.lights
    assert ours.environment == theirs.environment
    assert ours.camera == theirs.camera


def test_mesh_text_reads_back_as_the_loader_reads_it():
    spec = sponza_proxy.generate(n_tris_target=8000)
    b = builder_of(spec)
    for mesh, (gid, _) in zip(
            [spec.meshes[i.mesh] for i in spec.instances], b.instances):
        assert np.array_equal(mesh.positions(), b._groups[gid].positions)


@pytest.mark.parametrize("objects", ["instances", "usemtl_groups"])
def test_world_triangles_match_the_flattened_compile(objects):
    spec = sponza_proxy.generate(n_tris_target=8000, objects=objects)
    sc = builder_of(spec).compile(device="cpu")
    pos, nrm, mat, fo = ref_scene.world_triangles(spec)
    theirs = sc.tri_packed[:, 0:9].numpy().reshape(-1, 3, 3)
    ours = np.concatenate([pos[:, :1], pos[:, 1:] - pos[:, :1]], axis=1)
    key = lambda a: a.reshape(a.shape[0], -1)[np.lexsort(
        a.reshape(a.shape[0], -1).T[::-1])]
    # the program's table holds SBVH references: the same triangles, some
    # more than once
    uniq = np.unique(theirs.reshape(theirs.shape[0], -1), axis=0)
    assert np.array_equal(key(ours), np.unique(uniq, axis=0))


def test_face_normals_agree_with_the_loaders_to_rounding():
    # the loader's cross product may contract into fused multiply-adds
    spec = sponza_proxy.generate(n_tris_target=8000)
    b = builder_of(spec)
    for name, mesh in spec.meshes.items():
        gid = next(g for (g, i), inst in zip(b.instances, spec.instances)
                   if inst.mesh == name)
        assert np.allclose(ref_scene.face_normals(mesh.positions()),
                           b._groups[gid].normals, rtol=0, atol=1e-6)


def test_usemtl_groups_hold_every_part_in_world_space():
    parts = sponza_proxy.generate()
    groups = sponza_proxy.generate(objects="usemtl_groups")
    assert len(groups.instances) == 20 and groups.n_tris == 270_114
    pa, _, ma, fa = ref_scene.world_triangles(parts)
    pb, nb, mb, fb = ref_scene.world_triangles(groups)
    off = np.cumsum([0] + [parts.meshes[i.mesh].n_tris
                           for i in parts.instances])
    order = np.concatenate([
        np.arange(off[k], off[k + 1])
        for g in groups.instances
        for k, i in enumerate(parts.instances) if i.group == g.name])
    # the same triangles, to the six decimals of the text, group by group
    assert np.abs(pa[order] - pb).max() < 1e-5
    assert np.array_equal(ma[order], mb) and np.array_equal(fa[order], fb)
    for g in groups.instances:
        assert (g.position, g.rotation_deg, g.scale) == (
            (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    # normals: the world triangles' own face normals
    n = np.cross(pb[:, 1] - pb[:, 0], pb[:, 2] - pb[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    assert np.abs(nb[:, 0] - n).max() < 1e-6


def test_clusters_cover_every_triangle_once():
    spec = sponza_proxy.generate(n_tris_target=8000)
    pos, _, _, _ = ref_scene.world_triangles(spec)
    table = ref_scene.clusters(pos)
    ids = table[table >= 0]
    assert np.array_equal(np.sort(ids), np.arange(pos.shape[0]))
    assert table.shape[1] == ref_scene.CLUSTER
