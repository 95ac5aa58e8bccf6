"""The port's CLI, JSON scene schema, PNG writer and viewer, on CPU.

The schema is held against the JAX package's: a document through either
package gives the same document back, and a scene file written by one
package loads in the other and compiles to equal tables.  The CLI runs as
a subprocess with ``--cpu``; the viewer tests are the JAX package's
(``tests/test_cli.py``) on the port's classes, with the scene compiled for
the CPU.
"""

import io
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.scene import presets as j_presets
from ray_tracer_tpu.scene import schema as j_schema
from ray_tracer_tpu_torch import viewer
from ray_tracer_tpu_torch.integrator import film
from ray_tracer_tpu_torch.parallel.mesh import free_port
from ray_tracer_tpu_torch.scene import presets as t_presets
from ray_tracer_tpu_torch.scene import schema as t_schema

from torch_parity import assert_tables_match, stand_in_assets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE_DOC = {
    "materials": [
        {"name": "white"},
        {"name": "glow", "emission_color": [1, 1, 1], "emission_strength": 2.0,
         "albedo": [0, 0, 0]},
        {"name": "glass", "ior": 1.5},
    ],
    "spheres": [
        {"position": [0, 0, 2], "radius": 0.5, "material": "glass"},
        {"position": [0, -2, 2], "radius": 0.5, "material": 1},
    ],
    "environment": {"enabled": True},
    "camera": {"position": [0, 0, -1], "angles_deg": [0, 0, 0], "fov": 60},
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return stand_in_assets(str(tmp_path_factory.mktemp("assets")))


def _mesh_doc(assets):
    """A document with textures, named materials, TRS'd objects and a
    rect light."""
    return {
        "textures": [os.path.join(assets, "rb_alb.png")],
        "materials": [
            {"name": "white"},
            {"name": "tex", "albedo_tex": 0, "reflectance": 0.3},
            {"name": "light", "emission_color": [1, 1, 1],
             "emission_strength": 3.0, "albedo": [0, 0, 0]},
        ],
        "objects": [
            {"path": os.path.join(assets, "rb.obj"), "material": "tex",
             "position": [0.2, 0.1, 0], "rotation_deg": [0, 30, 0],
             "scale": 0.5, "sampler": 1, "name": "rb"},
            {"path": "plane.obj", "material": 0, "front_only": True},
        ],
        "lights": [{"corner": [-0.3, -1, -0.3], "edge_u": [0.6, 0, 0],
                    "edge_v": [0, 0, 0.6], "normal": [0, 1, 0],
                    "material": "light"}],
        "spheres": [{"position": [0, 0, 1], "radius": 0.3,
                     "material": "white"}],
    }


@pytest.mark.parametrize("which", ["spheres", "meshes"])
def test_schema_dict_round_trip_matches_jax(which, assets):
    doc = SCENE_DOC if which == "spheres" else _mesh_doc(assets)
    got = t_schema.builder_to_dict(t_schema.builder_from_dict(doc, assets))
    want = j_schema.builder_to_dict(j_schema.builder_from_dict(doc, assets))
    assert got == want
    # and once more through the port: a fixed point
    again = t_schema.builder_to_dict(t_schema.builder_from_dict(got))
    assert again == got


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scene_file_moves_between_packages(writer, assets, tmp_path):
    """A file saved by one package loads in the other; both compile it to
    the same tables."""
    path = str(tmp_path / "scene.json")
    src = (j_schema if writer == "jax" else t_schema)
    src.save_scene(src.builder_from_dict(_mesh_doc(assets), assets), path)
    jsc = j_schema.load_scene(path).compile()
    tsc = t_schema.load_scene(path).compile(device="cpu", rope_streams=True)
    assert tsc.meta["n_textures"] == 1 and tsc.n_lights == 1
    assert_tables_match(jsc, tsc)


def test_schema_roundtrip(tmp_path):
    """The JAX test of the same name on the port: name and index
    references resolve to the same material table."""
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE_DOC))
    scene = t_schema.load_scene(str(p)).compile(device="cpu")
    assert scene.n_spheres == 2
    assert scene.meta["n_materials"] == 3
    assert int(scene.sphere_mat[0]) == 2
    assert int(scene.sphere_mat[1]) == 1
    np.testing.assert_allclose(float(scene.mat_ior[2]), 1.5)
    assert scene.meta["camera"][2] == 60.0


def test_schema_save_roundtrip(tmp_path, assets):
    b = t_presets.cornell_spheres(assets=assets)
    p = str(tmp_path / "saved.json")
    t_schema.save_scene(b, p)
    doc = json.loads(open(p).read())
    assert len(doc["materials"]) == 6
    assert len(doc["spheres"]) == 2
    assert len(doc["objects"]) == 7
    assert doc["camera"]["fov"] == 50.0
    s2 = t_schema.builder_from_dict(doc).compile(device="cpu")
    assert s2.n_spheres == 2 and s2.n_lights == 1
    s1 = b.compile(device="cpu")
    assert s2.meta["n_tris"] == s1.meta["n_tris"]
    torch.testing.assert_close(s1.obj_inv_transform, s2.obj_inv_transform)


def test_encode_png_decodes_to_the_srgb_bytes():
    """Pillow reads the writer's PNG back to exactly ``to_uint8_srgb``,
    NaN canary and clamping included."""
    rand = np.random.default_rng(5)
    color = torch.from_numpy(
        rand.uniform(-0.2, 1.4, (13, 7, 3)).astype(np.float32))
    color[0, 0, 1] = float("nan")
    color[3, 2, 0] = float("inf")
    data = film.encode_png(color)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (7, 13)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im),
                                      film.to_uint8_srgb(color))


def test_write_png_matches_jax_bytes_after_decoding(tmp_path):
    """The port's ``write_png`` (no Pillow) and the JAX package's (Pillow)
    write the same pixels for the same image."""
    from ray_tracer_tpu.integrator import film as j_film

    color = np.random.default_rng(6).uniform(0, 1, (9, 11, 3)).astype(
        np.float32)
    film.write_png(str(tmp_path / "t.png"), torch.from_numpy(color))
    j_film.write_png(str(tmp_path / "j.png"), color)
    with Image.open(tmp_path / "t.png") as a, \
            Image.open(tmp_path / "j.png") as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "ray_tracer_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
    )


SMALL = ["--preset", "sphere_diffuse", "--cpu", "--width", "24",
         "--height", "20", "--spp", "2", "--bounces", "2"]
# a frame two ranks do not split evenly
ODD = ["--preset", "sphere_diffuse", "--cpu", "--width", "23", "--height",
       "19", "--spp", "2", "--bounces", "2"]


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return struct.unpack(">II", head[16:24])


def test_cli_render_png(tmp_path):
    out_png = str(tmp_path / "o.png")
    out = _cli("render", *SMALL, "-o", out_png)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["output"] == out_png
    assert report["resolution"] == "24x20" and report["spp"] == 2
    assert set(report) == {"output", "resolution", "spp", "wall_s",
                           "scene_compile_s", "tris", "bvh_nodes"}
    assert _png_size(out_png) == (24, 20)


def test_cli_progressive_checkpoint_resumes(tmp_path):
    """Two runs of ``--progressive 2 --checkpoint``: the second resumes at
    frame 2 and leaves the state of four frames, whose image equals four
    progressive steps of the library."""
    ck, out_png = str(tmp_path / "s.npz"), str(tmp_path / "o.png")
    args = ("render", *SMALL, "--progressive", "2", "--checkpoint", ck,
            "-o", out_png)
    first = _cli(*args)
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stderr
    assert json.loads(first.stdout)["spp"] == 4
    second = _cli(*args)
    assert second.returncode == 0, second.stderr
    assert "resumed at frame 2" in second.stderr
    with np.load(ck) as z:
        assert int(z["frame"]) == 4 and int(z["total_samples"]) == 8
        accum = z["accum"]
    pr = trt.ProgressiveRenderer(
        t_presets.sphere_diffuse().compile(device="cpu"),
        trt.RenderConfig(width=24, height=20, samples_per_pixel=2,
                         bounce_limit=2))
    for _ in range(4):
        pr.step()
    np.testing.assert_array_equal(accum, pr.accum.numpy())
    assert _png_size(out_png) == (24, 20)


def test_cli_orbit(tmp_path):
    out = _cli("render", *SMALL, "--orbit", "2", "-o",
               str(tmp_path / "f.png"))
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["frames"] == 2
    for i in range(2):
        assert _png_size(str(tmp_path / f"f_{i:03d}.png")) == (24, 20)


def test_cli_info_and_bench(tmp_path):
    info = _cli("info", *SMALL)
    assert info.returncode == 0, info.stderr
    meta = json.loads(info.stdout)
    assert meta["n_spheres"] == 2 and meta["bvh_nodes"] >= 1
    bench = _cli("bench", *SMALL, "--profile", str(tmp_path / "prof"))
    assert bench.returncode == 0, bench.stderr
    line = json.loads(bench.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["primary_rays"] == 24 * 20 * 2
    assert set(line) == {"wall_s", "primary_rays", "primary_mrays_per_s",
                         "spp", "resolution", "device"}
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name", "").split(" ")[0]
                 for e in json.load(f)["traceEvents"]}
    # the wavefront loop's host ranges ride in the exported trace
    assert {"rt.first_wave", "rt.live_read", "rt.round",
            "rt.rays"} <= names


def test_cli_scene_file_and_preset_assets(tmp_path, assets):
    """A scene file, and the default preset ``cornell`` read from
    ``RT_ASSETS``."""
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE_DOC))
    out = _cli("info", str(p), "--cpu")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["n_spheres"] == 2
    env = {**os.environ, "RT_ASSETS": assets}
    out = subprocess.run(
        [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "info", "--cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["n_objects"] == 9


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the card is the default")
def test_cli_without_card_or_cpu_raises():
    out = _cli("info", "--preset", "sphere_diffuse")
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_cli_sharded_world_of_one_equals_render(tmp_path):
    """``render --sharded`` without torchrun: a gloo world of one on the
    CPU, whose (1, 1) mesh writes the plain render's PNG byte for byte."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    out = _cli("render", *SMALL, "--sharded", "-o", a)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["output"] == a
    assert _cli("render", *SMALL, "-o", b).returncode == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_cli_sharded_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 ... render --sharded --cpu``: two
    gloo ranks split the pixels of a frame whose size they do not divide;
    rank 0 alone writes the image and the report line, and the PNG is the
    plain render's byte for byte."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(free_port()), "-m",
         "ray_tracer_tpu_torch.cli", "render", *ODD, "--sharded", "-o", a],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["output"] == a
    plain = _cli("render", *ODD, "-o", b)
    assert plain.returncode == 0, plain.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_port_modules_import_no_jax():
    """The CLI, the viewer, the schema and the multi-device modules import
    neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import ray_tracer_tpu_torch, ray_tracer_tpu_torch.cli, "
        "ray_tracer_tpu_torch.viewer, ray_tracer_tpu_torch.scene.schema, "
        "ray_tracer_tpu_torch.scene.presets, "
        "ray_tracer_tpu_torch.parallel.mesh, "
        "ray_tracer_tpu_torch.parallel.entry\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ray_tracer_tpu' or m.startswith('ray_tracer_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr


def test_viewer_http_endpoints():
    """Live viewer serves page/stats/image/scene/debug through the REAL
    handler; camera set resets accumulation; /edit mutates the scene."""
    builder = t_presets.sphere_diffuse()
    cfg = trt.RenderConfig(width=16, height=16, samples_per_pixel=1,
                           bounce_limit=1)
    state = viewer.ViewerState(builder, cfg, device="cpu")

    srv = viewer._make_server(state, "127.0.0.1", 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        u = f"http://127.0.0.1:{port}"
        html = urllib.request.urlopen(f"{u}/", timeout=10).read()
        assert b"ray_tracer_tpu_torch" in html
        png = urllib.request.urlopen(f"{u}/image.png", timeout=10).read()
        assert png[:4] == b"\x89PNG"
        stats = json.loads(urllib.request.urlopen(f"{u}/stats",
                                                  timeout=10).read())
        assert "camera" in stats
        urllib.request.urlopen(f"{u}/set?py=-2.0", timeout=10).read()
        assert state.renderer.camera.position[1] == -2.0
        assert state.renderer.frame == 0  # reset

        doc = json.loads(urllib.request.urlopen(f"{u}/scene",
                                                timeout=10).read())
        assert doc["editable"] and len(doc["spheres"]) >= 1

        # live material edit recompiles the scene and resets accumulation
        old_albedo = float(state.renderer.scene.mat_albedo[0, 0])
        body = json.dumps(
            {"materials": {"0": {"albedo": [0.25, 0.5, 0.75]}}}).encode()
        req = urllib.request.Request(f"{u}/edit", data=body, method="POST")
        out = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert out.get("ok")
        new_albedo = state.renderer.scene.mat_albedo[0].numpy()
        np.testing.assert_allclose(new_albedo, [0.25, 0.5, 0.75], rtol=1e-6)
        assert old_albedo != 0.25
        assert state.renderer.frame == 0
        assert state.renderer.scene.device == torch.device("cpu")

        body = json.dumps({"spheres": {"0": {"radius": 0.123}}}).encode()
        req = urllib.request.Request(f"{u}/edit", data=body, method="POST")
        assert json.loads(urllib.request.urlopen(req,
                                                 timeout=30).read()).get("ok")
        assert 0.123 in state.renderer.scene.sphere_radius.numpy()

        req = urllib.request.Request(
            f"{u}/edit", data=b'{"materials": {"99": {"ior": 1}}}',
            method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400

        dbg = urllib.request.urlopen(f"{u}/debug.png?mode=2",
                                     timeout=60).read()
        assert dbg[:4] == b"\x89PNG"
        with Image.open(io.BytesIO(dbg)) as im:
            assert im.size == (8, 8)
    finally:
        srv.shutdown()


def test_viewer_preview_then_full():
    """After any reset (startup / camera move) the first tick publishes a
    low-res 1-spp preview, the next tick the full-res frame."""
    builder = t_presets.sphere_diffuse()
    cfg = trt.RenderConfig(width=64, height=64, samples_per_pixel=1,
                           bounce_limit=1)
    state = viewer.ViewerState(builder, cfg, preview_scale=4, device="cpu")

    def size():
        with Image.open(io.BytesIO(state.png_bytes())) as im:
            return im.size

    state._tick()  # preview first
    assert state.latest_is_preview and state.renderer.frame == 0
    assert size() == (16, 16)
    state._tick()  # then the full-res frame
    assert not state.latest_is_preview and state.renderer.frame == 1
    assert size() == (64, 64)
    state._tick()
    assert state.renderer.frame == 2
    state.set_camera({"py": ["-2.0"]})
    state._tick()
    assert state.latest_is_preview and state.renderer.frame == 0
    assert size() == (16, 16)


def test_viewer_debug_png_matches_jax():
    """``/debug.png``'s pixels: the JAX viewer's, for the same scene."""
    kw = dict(width=20, height=18, samples_per_pixel=1, bounce_limit=2)
    t_state = viewer.ViewerState(t_presets.spheres_demo(),
                                 trt.RenderConfig(**kw), device="cpu")
    from ray_tracer_tpu import viewer as j_viewer

    j_state = j_viewer.ViewerState(j_presets.spheres_demo(),
                                   jrt.RenderConfig(**kw))
    got = t_state.debug_png(2, 200.0, 50.0)
    want = j_state.debug_png(2, 200.0, 50.0)
    with Image.open(io.BytesIO(got)) as a, Image.open(io.BytesIO(want)) as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
