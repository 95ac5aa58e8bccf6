"""A configuration names its own scene hand-off, plain reference and small
size (``handoff``, ``reference``, ``small_args``), and what runs a
configuration takes them through ``harness.parts``: the run's check and
the controls are judged by the configuration's reference, and the files
its hand-off writes into the run's work directory are there when the
program compiles and gone after the run.  The fixtures under
``rt_bench/tests/fixtures/`` are configurations' parts, not entries of
``BENCHMARK.json``."""

import os
import tempfile

import pytest
import torch

from rt_bench import control, harness
from rt_bench.tests.common import (BENCH, CELLS, ROOT, SEED, SMALL_ARGS,
                                   run_small, small, small_config)
from rt_bench.tests.fixtures import textured_handoff
from rt_bench.tests.fixtures.scaled_reference import integrator as scaled

SCALED = "tests.fixtures.scaled_reference"
TEXTURED = "tests.fixtures.textured_handoff"


def test_parts_take_what_a_configuration_names_and_the_defaults_else():
    p = harness.parts({})
    assert p.handoff.__name__ == "rt_bench.port_scene"
    assert p.reference.__name__ == "rt_bench.reference"
    p = harness.parts({"handoff": TEXTURED, "reference": SCALED})
    assert p.handoff is textured_handoff
    assert p.reference.integrator is scaled


@pytest.mark.parametrize("file", [c["file"] for c in BENCH["configs"]])
def test_each_configuration_resolves_to_parts_that_run_it(file):
    config = harness.load_json(ROOT, file)
    p = harness.parts(config)
    assert p.handoff.__name__ == "rt_bench." + config.get("handoff",
                                                          harness.HANDOFF)
    assert p.reference.__name__ == "rt_bench." + config.get(
        "reference", harness.REFERENCE)
    assert callable(p.handoff.builder_of)
    assert callable(p.reference.scene.build)
    assert callable(p.reference.integrator.render_pixels)


def test_small_config_overrides_the_generators_arguments():
    config = {"generator_args": {"seed": 7, "n_tris_target": 260_000}}
    assert small_config(config)["generator_args"] == {
        "seed": 7, "n_tris_target": 8000}
    config["small_args"] = {"n_tris_target": 3000}
    assert small_config(config)["generator_args"] == {
        "seed": 7, "n_tris_target": 3000}


@pytest.mark.parametrize("cell", CELLS)
def test_small_reads_small_args(cell):
    config, _ = small(cell)
    assert config["generator_args"].items() >= config.get(
        "small_args", SMALL_ARGS).items()
    config, _ = small(cell, small_args={"n_tris_target": 3000})
    assert config["generator_args"]["n_tris_target"] == 3000


@pytest.mark.parametrize("reference", [None, SCALED])
def test_the_configurations_reference_decides_correct(reference):
    keys = {"reference": reference} if reference else {}
    res = run_small(CELLS[0], steps=2, **keys)
    (name, value, _), = res["rows"]
    if reference is None:
        assert res["correct"], res["rows"]
    else:
        assert not res["correct"]
        # the program's image against 1.01 times the reference's
        assert value == pytest.approx(0.01 / 1.01, rel=0.02)


def test_the_controls_take_the_configurations_reference(monkeypatch):
    config, mix = small(CELLS[0], reference=SCALED)
    plain_config, _ = small(CELLS[0])
    spec = harness.generate(config)
    frames, cpu = 2, torch.device("cpu")
    pix = harness.sample_pixels(SEED, mix["width"], mix["height"], frames,
                                mix["spp"])
    args = (mix, SEED, spec.camera, pix, frames, cpu)
    want = harness.check(spec, config, *args)
    assert torch.equal(want, harness.check(spec, plain_config, *args)
                       * scaled.SCALE)
    colours = []
    real = scaled.render_pixels

    def counted(*a):
        colours.append(a[5] if len(a) > 5 else None)
        return real(*a)

    monkeypatch.setattr(scaled, "render_pixels", counted)
    found = control.control_numbers(spec, config, *args)
    # the float32 image and each control, all the configuration's own
    assert colours == [None] + [c for _, c in control.CONTROLS.values()]
    assert set(found) == set(control.CONTROLS)


@pytest.fixture
def scene_compiles(monkeypatch, tmp_path):
    """Every run's temporary files under ``tmp_path``; each compile records
    the work directory's files and the compiled scene."""
    from ray_tracer_tpu_torch.scene.builder import SceneBuilder

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []
    real = SceneBuilder.compile

    def compile(self, *a, **kw):
        work, = os.listdir(tmp_path)
        files = sorted(os.listdir(tmp_path / work))
        seen.append((files, real(self, *a, **kw)))
        return seen[-1][1]

    monkeypatch.setattr(SceneBuilder, "compile", compile)
    return seen


def test_the_handoffs_files_outlive_the_compile_not_the_run(
        scene_compiles, tmp_path):
    run_small(CELLS[0], steps=1, handoff=TEXTURED)
    (files, scene), = scene_compiles
    assert files == sorted(textured_handoff.FILES)
    assert scene.meta["n_textures"] == 1
    # the PNG decoded, not the 1x1 map the program puts in place of a file
    # it cannot read
    assert scene.tex_size.tolist() == [list(textured_handoff.TEX_SHAPE)]
    assert os.listdir(tmp_path) == []


def test_the_default_handoff_works_in_the_run_directory(scene_compiles,
                                                         tmp_path):
    run_small(CELLS[0], steps=1)
    (files, scene), = scene_compiles
    assert files == []  # its own directory went when the builder had read it
    assert scene.meta["n_textures"] == 0
    assert os.listdir(tmp_path) == []


def test_the_work_directory_goes_when_the_compile_fails(monkeypatch,
                                                        tmp_path):
    from ray_tracer_tpu_torch.scene.builder import SceneBuilder

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def fail(self, *a, **kw):
        assert os.listdir(tmp_path)
        raise RuntimeError("compile failed")

    monkeypatch.setattr(SceneBuilder, "compile", fail)
    with pytest.raises(RuntimeError, match="compile failed"):
        run_small(CELLS[0], steps=1, handoff=TEXTURED)
    assert os.listdir(tmp_path) == []
