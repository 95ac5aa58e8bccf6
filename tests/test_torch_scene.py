"""The torch port's host scene compiler against the JAX package's.

The port carries its own copy of ``scene/`` and ``accel/`` (importing the
JAX package would import JAX); for the same builder script both must
produce the same tables, NaN-equal, and the port must import no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.scene import presets as j_presets
from ray_tracer_tpu_torch.scene import presets as t_presets
from ray_tracer_tpu_torch.scene.builder import top_table_or_empty
from ray_tracer_tpu_torch.scene.types import (
    narrow_root_meta,
    page_counts,
    rope_box_rows,
    rope_placeholder,
)

from torch_parity import room_scene, scene_arrays, soup_scene, sponza_builders

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _builders(name, tmp, monkeypatch):
    if name == "sponza_proxy":
        return sponza_builders(tmp, monkeypatch, 8000)
    if name == "room":
        return room_scene(jrt, tmp), room_scene(trt, tmp)
    if name == "soup_leaf8":
        return soup_scene(jrt, tmp), soup_scene(trt, tmp)
    return (getattr(j_presets, name)(), getattr(t_presets, name)())


@pytest.mark.parametrize(
    "name", ["sponza_proxy", "room", "soup_leaf8", "sphere_diffuse"]
)
def test_compiled_arrays_match_jax(name, tmp_path, monkeypatch):
    jb, tb = _builders(name, str(tmp_path), monkeypatch)
    kw = {"max_leaf_tris": 8} if name == "soup_leaf8" else {}
    jarr, jmeta = scene_arrays(jb.compile(**kw))
    tsc = tb.compile(device="cpu", rope_streams=True, **kw)
    if jmeta["rope_rows"]:  # the port keeps only the BOX rows
        jarr["rope_streams"], n_box = rope_box_rows(
            jarr["rope_streams"], jmeta["rope_rows"],
            jarr["tri_packed"].shape[0])
        jmeta = {**jmeta, "rope_rows": n_box}
    else:
        jarr["rope_streams"] = rope_placeholder()
    # the cluster tables' page counts, which the JAX package does not keep:
    # the port's own equal those derived from the JAX range starts
    jarr.update(page_counts(jarr, jmeta))
    # and the TOP walk's table, which it does not keep either: the port's
    # equals the one derived from the JAX tables
    jarr["wide_top"] = top_table_or_empty(jarr["wide_packed"],
                                          jarr["wide_troot"])
    for f in trt.CompiledScene.array_fields():
        got, want = np.asarray(getattr(tsc, f)), jarr[f]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)  # NaN-equal
    # the narrow walk's root and root word, which the JAX package does not
    # keep: the port's own equal those derived from the JAX tables
    jmeta = {**jmeta, **narrow_root_meta(jarr)}
    for k, v in tsc.meta.items():
        assert jmeta[k] == v, k
    if name == "soup_leaf8":
        assert tsc.meta["wide_leaf_recs"] == 8  # merged single-row leaves


def test_from_numpy_round_trip(tmp_path):
    jarr, jmeta = scene_arrays(room_scene(jrt, str(tmp_path)).compile())
    sc = trt.CompiledScene.from_numpy(jarr, jmeta, device="cpu")
    assert sc.device == torch.device("cpu")
    # from_numpy derives the narrow walk's root, which JAX's meta lacks
    assert "bvh_root" not in jmeta
    assert jmeta["rope_rows"] > 0
    box, n_box = rope_box_rows(jarr["rope_streams"], jmeta["rope_rows"],
                               jarr["tri_packed"].shape[0])
    # and the rope streams' BOX rows, where JAX counts BOX and TRI rows
    assert sc.meta == {**jmeta, **narrow_root_meta(jarr), "rope_rows": n_box}
    assert sc.meta is not jmeta
    moved = sc.to("cpu")
    jarr = dict(jarr, rope_streams=box, **page_counts(jarr, jmeta),
                wide_top=top_table_or_empty(jarr["wide_packed"],
                                            jarr["wide_troot"]))
    for f in trt.CompiledScene.array_fields():
        t = getattr(moved, f)
        assert isinstance(t, torch.Tensor), f
        np.testing.assert_array_equal(t.numpy(), jarr[f], err_msg=f)
    # the treelet-root table of two-phase traversal is carried
    assert sc.wide_troot.dtype == torch.int32 and "n_treelets" in sc.meta


def test_compile_defaults_to_the_card(monkeypatch, tmp_path):
    """With no CUDA device, compile() and from_numpy() without a device
    raise (no silent CPU fallback); device="cpu" is the way to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = room_scene(trt, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        b.compile()
    jarr, jmeta = scene_arrays(room_scene(jrt, str(tmp_path)).compile())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.CompiledScene.from_numpy(jarr, jmeta)
    assert b.compile(device="cpu").device == torch.device("cpu")


def test_native_builder_failure_raises(monkeypatch, tmp_path):
    """The port's copy never falls back to the numpy builder silently: a
    compiler that fails surfaces as an error (the numpy builder cannot
    build SBVH trees)."""
    from ray_tracer_tpu_torch import native_build
    from ray_tracer_tpu_torch.accel import bvh, native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "GXX", ("false",))
    tris = np.random.default_rng(0).uniform(-1, 1, (50, 3, 3))
    with pytest.raises(RuntimeError, match="building bvh_builder failed"):
        bvh.build_forest(tris.astype(np.float32), [(0, 50)], 4, spatial=True)


def test_import_and_cpu_render_load_no_jax(tmp_path):
    script = f"""
import os, sys
sys.path.insert(0, {REPO!r})
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch.scene import presets
path = os.path.join({str(tmp_path)!r}, "quad.obj")
with open(path, "w") as f:
    f.write(presets.obj_text(presets.SKYLIGHT_VERTS, presets.SKYLIGHT_FACES))
b = trt.SceneBuilder()
presets.default_materials(b)
b.add_obj(path, material=0, position=(0.0, 0.5, 0.0), scale=6.0)
b.add_sphere((0.0, -0.5, 0.0), 0.5, presets.MIRROR)
b.set_environment(trt.Environment(enabled=True))
img = trt.render(b.compile(device="cpu"),
                 trt.RenderConfig(width=8, height=8, samples_per_pixel=2,
                                  bounce_limit=3))
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
