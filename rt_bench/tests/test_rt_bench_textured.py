"""The textured cell's two readers: ``maps_ms_per_step`` reads the maps
instance's device time by name, ``cutout_pct`` the ``cut=`` words of the
``rt.round`` spans; both read None where there is nothing to read (an
untextured cell, a program that does not count cutouts, no device), and
a small traced run of the textured cell on the CPU reads its cutouts."""

import pytest

from rt_bench import harness, trace_view
from rt_bench.metrics import cutout_pct, maps_ms_per_step
from rt_bench.tests.common import run_small

TEXTURED = "sponza_textured.progressive1080"


def _view(device=(), host=(), steps=2):
    return trace_view.TraceView(
        steps=steps, window=(0.0, 1000.0), device=list(device),
        host=list(host), step_spans=[("k=0", 0.0, 500.0),
                                     ("k=1", 500.0, 1000.0)],
        spans={}, own=("shade_kernel", "group_walk_kernel"))


def test_maps_ms_reads_the_maps_instance_by_name():
    tv = _view([("void (anonymous namespace)::shade_kernel<true>(ShadeArgs)",
                 0.0, 300.0),
                ("void (anonymous namespace)::shade_kernel<true>(ShadeArgs)",
                 400.0, 500.0),
                ("void (anonymous namespace)::shade_kernel<false>(ShadeArgs)",
                 500.0, 900.0),
                ("void group_walk_kernel<true>(Args)", 900.0, 950.0)])
    assert maps_ms_per_step.read(tv) == pytest.approx(0.2)
    assert tv.kind(tv.device[0][0]) == "round"  # and round_ms counts it
    untextured = _view(tv.device[2:])
    assert maps_ms_per_step.read(untextured) is None
    assert maps_ms_per_step.read(_view(tv.device, steps=0)) is None


def test_cutout_pct_reads_the_cut_words():
    rounds = [("rt.round lanes=100 live=100", 0.0, 10.0),
              ("rt.round lanes=100 live=80 runs=9 cut=6", 20.0, 30.0),
              ("rt.round lanes=100 live=40 runs=5 cut=0", 40.0, 50.0),
              ("rt.live_read", 30.0, 35.0)]
    assert cutout_pct.read(_view(host=rounds)) == pytest.approx(5.0)
    # a program that counts no cutouts, or an untextured cell
    assert cutout_pct.read(_view(host=[
        ("rt.round lanes=100 live=80 runs=9", 0.0, 10.0)])) is None
    assert cutout_pct.read(_view(host=rounds, steps=0)) is None


def test_a_small_traced_run_reads_its_cutouts(monkeypatch):
    monkeypatch.setattr(harness, "TRACED_STEPS", 2)
    res = run_small(TEXTURED, steps=1, trace=True)
    assert res["correct"], res["rows"]
    assert res["metrics"]["cutout_pct"]["value"] > 0
    assert "maps_ms_per_step" not in res["metrics"]  # no device here
