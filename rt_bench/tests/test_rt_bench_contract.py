"""The benchmark's own rules: ``BENCHMARK.json`` names files that exist,
every per-layer metric has its reader, the readers read a trace, the
traffic's views are fixed and only ordered by the seed, nothing the
harness or the reference loads is JAX or the JAX package, and each
configuration's generator and reference load nothing of the program."""

import json
import os
import re
import subprocess
import sys

import pytest

from rt_bench import harness, trace_view, traffic
from rt_bench.tests.common import CELLS, ROOT

BENCH = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_files_and_readers():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert harness.load_json(ROOT, c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        traffic.load(ROOT, w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "rt_bench", "limits",
                                           w["name"] + ".json"))
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "rt_bench", "metrics",
                                           m["name"] + ".py"))
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "msamples_per_s", "step_p95_ms", "setup_s"}


def _view(device, steps=2, spans=None):
    return trace_view.TraceView(
        steps=steps, window=(0.0, 1000.0), device=device, host=[
            ("aten::item", 400.0, 600.0)],
        step_spans=[("k=0", 0.0, 500.0), ("k=1", 500.0, 1000.0)],
        spans=spans or {"compile": 2.5},
        own=("group_walk_kernel", "shade_kernel"))


def test_readers_on_a_trace():
    import importlib

    tv = _view([("void group_walk_kernel<false>(Args)", 0.0, 300.0),
                ("shade_kernel", 300.0, 400.0),
                ("void at::native::elementwise_kernel<...>", 600.0, 700.0),
                ("Memset (Device)", 650.0, 900.0)])
    read = lambda n: importlib.import_module(
        f"rt_bench.metrics.{n}").read(tv)
    assert read("device_idle_pct") == pytest.approx(30.0)
    assert read("launches_per_step") == 2.0
    assert read("walk_ms_per_step") == pytest.approx(0.15)
    assert read("round_ms_per_step") == pytest.approx(0.05)
    assert read("aten_ms_per_step") == pytest.approx(0.175)
    assert read("scene_compile_s") == 2.5
    assert tv.idle_gaps()[0] == ["k=0: aten::item", pytest.approx(2e-4)]
    empty = _view([], steps=0)
    for m in BENCH["per_layer"]:
        if m["name"] != "scene_compile_s":
            assert importlib.import_module(
                f"rt_bench.metrics.{m['name']}").read(empty) is None


def test_walk_names_only_the_walk_kernels():
    tv = _view([("void group_walk_kernel<false>(Args)", 0.0, 100.0),
                ("void forest_walk_kernel<true, false>(Args)", 100.0, 300.0),
                ("cluster_pairs_kernel", 300.0, 400.0)])
    tv.own = ("cluster_pairs_kernel", "forest_walk_kernel",
              "group_walk_kernel")
    assert [tv.kind(n) for n, _, _ in tv.device] == ["walk", "walk", "own"]
    assert tv.device_us("walk") == 300.0


def test_views_are_fixed_and_ordered_by_the_seed():
    from rt_bench.scenes import sponza_proxy

    spec = sponza_proxy.generate(n_tris_target=8000)
    mix = traffic.load(ROOT, "orbit1080")
    every, a = traffic.camera_plan(mix, spec.meta, spec.camera, 1)
    _, b = traffic.camera_plan(mix, spec.meta, spec.camera, 2**31 + 9)
    assert every == 8 and len(a) == mix["views"]["count"]
    key = lambda v: (v["position"], v["angles_deg"])
    assert sorted(map(key, a)) == sorted(map(key, b)) and a != b
    for v in a:
        assert -15.0 <= v["angles_deg"][0] <= 0.0
        assert abs(v["position"][2]) <= 0.85 * spec.meta["half_length"]
    assert traffic.camera_plan(traffic.load(ROOT, "progressive1080"),
                               spec.meta, spec.camera, 1) == (0, [])


def _python(code: str) -> str:
    """The last line ``code`` prints in a fresh interpreter at the root."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r)\n"
         % ROOT + code], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=""))
    return out.stdout.strip().splitlines()[-1]


def test_the_harness_and_reference_load_no_jax():
    # every configuration's parts, through the resolver, and a small run
    assert _python(
        "import importlib\n"
        "import rt_bench.harness as h, rt_bench.control, rt_bench.trace_view\n"
        "for c in h.load_json(%r, 'BENCHMARK.json')['configs']:\n"
        "    config = h.load_json(%r, c['file'])\n"
        "    h.parts(config).handoff, h.parts(config).reference\n"
        "    importlib.import_module('rt_bench.scenes.'\n"
        "                            + config['generator'])\n"
        "import ray_tracer_tpu_torch\n"
        "from rt_bench.tests.common import run_small\n"
        "run_small(%r, steps=1)\n"
        "print(h.forbidden_modules())\n" % (ROOT, ROOT, CELLS[0])) == "[]"


def test_the_reference_imports_nothing_of_the_program():
    # each configuration's generator module and reference package, with
    # every module of the benchmark that they load: none is loaded with the
    # program or JAX, and none names either in an import, lazy ones too
    for c in BENCH["configs"]:
        found = json.loads(_python(
            "import importlib, json, sys\n"
            "import rt_bench.harness as h\n"
            "config = h.load_json(%r, %r)\n"
            "before = set(sys.modules)\n"
            "gen = 'rt_bench.scenes.' + config['generator']\n"
            "importlib.import_module(gen)\n"
            "ref = h.parts(config).reference.__name__\n"
            "files = sorted(\n"
            "    m.__file__ for n, m in sys.modules.items()\n"
            "    if n.startswith('rt_bench.') and m.__file__ and (\n"
            "        n in (gen, ref) or n.startswith(ref + '.')\n"
            "        or n not in before))\n"
            "print(json.dumps(dict(files=files, loaded=sorted(\n"
            "    n for n in sys.modules if n.split('.')[0] in\n"
            "    h.FORBIDDEN + ('ray_tracer_tpu_torch',)))))\n"
            % (ROOT, c["file"])))
        assert found["loaded"] == [], c["name"]
        assert len(found["files"]) >= 3, c["name"]
        for fn in found["files"]:
            with open(fn) as f:
                text = f.read()
            assert not re.search(r"^\s*(import|from)\s+(ray_tracer_tpu|jax)",
                                 text, re.M), (c["name"], fn)


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["ray_tracer_tpu_torch", "ray_tracer_tpu_torch.api", "jaxtyping",
         "ray_tracer_tpu", "ray_tracer_tpu.api", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "ray_tracer_tpu", "ray_tracer_tpu.api"]


def test_a_traced_run_reads_its_metrics_and_stays_correct(monkeypatch):
    from rt_bench.tests.common import run_small

    monkeypatch.setattr(harness, "TRACED_STEPS", 2)
    res = run_small(CELLS[0], steps=1, trace=True)
    assert res["correct"] and res["attempted"] >= 2  # the traced steps
    assert res["metrics"]["scene_compile_s"]["value"] > 0
    assert set(res["device_info"]) == {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
