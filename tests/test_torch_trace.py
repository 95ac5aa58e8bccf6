"""The wavefront loop's profiler ranges (``utils/trace.py``) on the CPU.

Under ``torch.profiler`` a ``ProgressiveRenderer.step`` of a reduced
``sponza_proxy`` frame records ``rt.first_wave``, one ``rt.live_read`` a
live-count read and one ``rt.round`` a round, each with the counts the loop
read, and one ``rt.rays`` mark a wavefront call whose counts are the ones
``trace_wave(..., with_stats=True)`` returns; with no profiler running no
range is entered; the image is the same bit for bit either way.  On the
fused round (the main path), the torch round, the unbinned loop and the
rope walk's route.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import api
from ray_tracer_tpu_torch.integrator import shading, wavefront
from ray_tracer_tpu_torch.scene import presets
from ray_tracer_tpu_torch.utils import trace

SIZE = dict(width=16, height=8, samples_per_pixel=2, bounce_limit=3,
            seed=2**31 + 7)
ROUTES = {
    "fused": dict(),
    "torch": dict(routing=trt.Routing(bin_mode="leaf")),
    "unbinned": dict(bin_rays=False),
    "rope": dict(routing=trt.Routing(lanewalk="force")),
}


@pytest.fixture(scope="module")
def scene():
    return presets.sponza_proxy(n_tris_target=8000).compile(
        device="cpu", rope_streams=True)


def config(route):
    return trt.RenderConfig(**SIZE, **ROUTES[route])


def program_ranges(prof):
    """``(kind, counts)`` of each ``rt.*`` range the profiler recorded, in
    the order they started.  Read from the profiler's raw events: building
    ``prof.events()`` from the plain walks' tens of thousands of operations
    takes seconds a step."""
    out = []
    events = prof.profiler.kineto_results.events()
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.name().startswith("rt."):
            kind, *words = e.name()[3:].split()
            out.append((kind, {k: int(v) for k, v in
                               (w.split("=") for w in words)}))
    return out


def profiled_step(renderer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        renderer.step()
    return program_ranges(prof)


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_step_records_a_span_a_read_and_a_round(scene, route,
                                                  monkeypatch):
    """One ``rt.live_read`` a read and one ``rt.round`` a round, each
    round's span carrying its width and the live count of the wave it
    takes: the count the read before it returned."""
    cfg = config(route)
    seen = []  # (width, live) of each wave a round takes
    fused = route in ("fused", "rope")
    name = "_fused_round" if fused else "_torch_round"
    real = getattr(wavefront, name)

    def spy(c, w, rope_err=None):
        seen.append((w.alive.shape[0], int(w.alive.sum())))
        return real(c, w, rope_err)

    monkeypatch.setattr(wavefront, name, spy)
    got = profiled_step(trt.ProgressiveRenderer(scene, cfg))
    kinds = [k for k, _ in got]
    assert kinds[0] == "first_wave" and kinds[-1] == "rays"
    assert got[0][1] == {"lanes": 256}  # 128 pixels, a lane a sample
    rounds = [(c["lanes"], c["live"]) for k, c in got if k == "round"]
    assert rounds == seen and len(rounds) >= 3
    # a read before every round, and one that ends the loop: 256 lanes
    # make one width, so no drain step reads again
    assert kinds[1:-1] == ["live_read", "round"] * len(seen) + ["live_read"]
    assert kinds.count("rays") == 1


@pytest.mark.parametrize("route", ["fused", "torch"])
def test_a_round_carries_the_key_runs_of_its_wave(scene, route,
                                                  monkeypatch):
    """On the fused round (and the torch round's morton bins) every round
    but the first carries ``runs``: the distinct live bin keys of the wave
    it takes, which the round before it sorted; the first round takes the
    unsorted first wave and carries none, nor does a round after bins that
    are no morton key's."""
    cfg = config(route)
    if route == "torch":
        cfg = cfg.replace(routing=trt.Routing(nee_prebin="sort"))
    rt = cfg.resolved_routing()
    seen = []  # the distinct live keys of each wave a round takes
    name = "_fused_round" if route == "fused" else "_torch_round"
    real = getattr(wavefront, name)

    def spy(c, w, rope_err=None):
        key = shading.bin_key(scene, w.origin, w.direction, w.alive,
                              rt.bin_bits, rt.bin_dir_bits)
        seen.append(key[key != shading.DEAD_KEY].unique().numel())
        return real(c, w, rope_err)

    monkeypatch.setattr(wavefront, name, spy)
    got = profiled_step(trt.ProgressiveRenderer(scene, cfg))
    rounds = [c for k, c in got if k == "round"]
    assert len(rounds) == len(seen) >= 3
    assert "runs" not in rounds[0]
    assert [c["runs"] for c in rounds[1:]] == seen[1:]
    leaf = profiled_step(trt.ProgressiveRenderer(scene, config("torch")))
    assert not [c for k, c in leaf if k == "round" and "runs" in c]


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_ray_mark_equals_with_stats(scene, route):
    """The ``rt.rays`` counts are ``trace_wave(with_stats=True)``'s for the
    same frame; its samples are the frame's."""
    cfg = config(route)
    got = profiled_step(trt.ProgressiveRenderer(scene, cfg))
    (mark,) = [c for k, c in got if k == "rays"]
    cam = api._camera_arrays(api.scene_camera(scene), cfg, scene.device)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    _, n_rays = wavefront.trace_wave(scene, *cam, ids, 0, 0,
                                     cfg.samples_per_pixel, cfg,
                                     with_stats=True)
    assert mark == {"samples": cfg.n_pixels * cfg.samples_per_pixel,
                    "sem": int(n_rays[0]), "traced": int(n_rays[1])}
    assert mark["sem"] >= mark["traced"] >= mark["samples"]


def test_no_range_without_a_profiler(scene, monkeypatch):
    """With no profiler running, the loop enters no profiler range."""

    def refuse(name):
        raise AssertionError(f"a range was entered: {name}")

    monkeypatch.setattr(trace, "_Range", refuse)
    assert not trace.recording()
    trt.ProgressiveRenderer(scene, config("fused")).step()
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            trt.ProgressiveRenderer(scene, config("fused")).step()


@pytest.mark.parametrize("route", ["fused", "torch"])
def test_the_image_is_the_same_with_the_profiler_on(scene, route):
    """Two steps, one renderer under the profiler and one without: the
    same accumulation bit for bit."""
    cfg = config(route)
    off = trt.ProgressiveRenderer(scene, cfg)
    on = trt.ProgressiveRenderer(scene, cfg)
    for _ in range(2):
        off.step()
        profiled_step(on)
    assert torch.equal(off.accum, on.accum)


def test_spans_build_no_name_when_off(monkeypatch):
    """Off, ``span`` returns one shared no-op context and formats nothing;
    on, it names the range ``name % args``."""

    class Loud:
        def __str__(self):
            raise AssertionError("formatted while off")

    assert trace.span("rt.round lanes=%s", Loud()) is trace.span("x")
    trace.mark("rt.rays samples=%s", Loud())
    names = []
    monkeypatch.setattr(trace, "_Range",
                        lambda name: names.append(name) or trace._OFF)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("rt.round lanes=%d live=%d", 8, 5):
            pass
        trace.mark("rt.rays samples=%d", 3)
    assert names == ["rt.round lanes=8 live=5", "rt.rays samples=3"]
