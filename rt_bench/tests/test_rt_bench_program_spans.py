"""The readers of the program's ``rt.*`` ranges (``rt_bench/program_spans.py``
and the five metrics on it): their values worked out by hand on a
synthetic trace, None where the trace holds none of the ranges or no
profiled step, and the small traced CPU run reading the counters."""

import importlib

import pytest

from rt_bench import harness, program_spans, trace_view

NAMES = ("rays_per_sample", "live_lane_pct", "enqueue_ms_per_step",
         "readback_idle_ms_per_step", "enqueue_idle_ms_per_step")
IDLE = ("readback_idle_ms_per_step", "enqueue_idle_ms_per_step")

# two steps of 500 us: the first three rounds wide, the second one
HOST = [
    ("rt.first_wave lanes=100", 0.0, 50.0),
    ("rt.live_read", 50.0, 120.0),
    ("aten::item", 60.0, 110.0),
    ("rt.round lanes=100 live=100", 120.0, 300.0),
    ("rt.live_read", 300.0, 380.0),
    ("rt.round lanes=100 live=40", 380.0, 450.0),
    ("rt.live_read", 450.0, 480.0),
    ("rt.rays samples=100 sem=260 traced=220", 480.0, 480.0),
    ("rt.first_wave lanes=100", 500.0, 560.0),
    ("rt.live_read", 560.0, 600.0),
    ("rt.round lanes=100 live=100", 600.0, 800.0),
    ("rt.live_read", 800.0, 850.0),
    ("rt.rays samples=100 sem=180 traced=160", 850.0, 850.0),
]
# idle: [0,10) opens in a first wave, [105,140) in a read, [330,390) in a
# read, [420,430) in a round, [470,520) in a read, [900,1000) after the
# last range of the window
DEVICE = [
    ("void group_walk_kernel<false>(Args)", 10.0, 70.0),
    ("shade_kernel", 70.0, 100.0),
    ("Memcpy DtoH (Device -> Pageable)", 100.0, 105.0),
    ("void group_walk_kernel<false>(Args)", 140.0, 330.0),
    ("permute_kernel", 390.0, 420.0),
    ("nee_resolve_kernel", 430.0, 470.0),
    ("void group_walk_kernel<true>(Args)", 520.0, 700.0),
    ("void at::native::elementwise_kernel<...>", 650.0, 900.0),
]


def view(host=HOST, device=DEVICE, steps=2):
    return trace_view.TraceView(
        steps=steps, window=(0.0, 1000.0), device=list(device),
        host=list(host), step_spans=[("k=0", 0.0, 500.0),
                                     ("k=1", 500.0, 1000.0)],
        spans={"compile": 1.0},
        own=("group_walk_kernel", "shade_kernel", "permute_kernel",
             "nee_resolve_kernel"))


def read(name, tv):
    return importlib.import_module(f"rt_bench.metrics.{name}").read(tv)


def test_readers_by_hand():
    tv = view()
    assert read("rays_per_sample", tv) == pytest.approx((220 + 160) / 200)
    assert read("live_lane_pct", tv) == pytest.approx(
        100.0 * (100 + 40 + 100) / 300)
    # first waves 50 + 60, rounds 180 + 70 + 200 us, over two steps
    assert read("enqueue_ms_per_step", tv) == pytest.approx(0.28)
    assert read("readback_idle_ms_per_step", tv) == pytest.approx(
        (35 + 60 + 50) / 2 / 1e3)
    assert read("enqueue_idle_ms_per_step", tv) == pytest.approx(
        (10 + 10) / 2 / 1e3)


def test_gaps_are_the_window_less_the_device():
    tv = view()
    gaps = program_spans.gaps(tv)
    assert gaps == [(0.0, 10.0), (105.0, 140.0), (330.0, 390.0),
                    (420.0, 430.0), (470.0, 520.0), (900.0, 1000.0)]
    assert sum(b - a for a, b in gaps) == pytest.approx(
        tv.window_us - tv.busy_us)
    assert sorted(b - a for a, b in gaps)[-1] / 1e6 == pytest.approx(
        tv.idle_gaps()[0][1])


def test_parse():
    assert program_spans.parse("rt.round lanes=8 live=5") == (
        "round", {"lanes": 8, "live": 5})
    assert program_spans.parse("rt.live_read") == ("live_read", {})
    assert program_spans.parse("rt_bench.step k=0") is None
    assert program_spans.parse("aten::item") is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_programs_ranges(name):
    """The parent's trace: the same operations, no ``rt.*`` range."""
    plain = [h for h in HOST if not h[0].startswith("rt.")]
    assert read(name, view(host=plain)) is None
    assert read(name, view(steps=0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_idle_readers_need_device_operations(name):
    """A CPU run's trace has the ranges but no device operation: the idle
    readers read nothing, the counters and the enqueue time read."""
    got = read(name, view(device=[]))
    assert (got is None) == (name in IDLE)


def test_a_small_traced_run_reads_the_counters(monkeypatch):
    from rt_bench.tests.common import run_small

    monkeypatch.setattr(harness, "TRACED_STEPS", 2)
    res = run_small("sponza_flat.progressive1080", steps=1, trace=True)
    m = res["metrics"]
    assert res["correct"]
    assert m["rays_per_sample"]["value"] >= 1.0
    assert 0.0 < m["live_lane_pct"]["value"] <= 100.0
    assert m["enqueue_ms_per_step"]["value"] > 0.0
    assert m["rays_per_sample"]["unit"] == "rays"
    for name in IDLE:  # no device operation on the CPU
        assert name not in m
