"""One run of one cell of the benchmark of ``ray_tracer_tpu_torch``.

    python3 rt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``rt_bench/configs/<name>.json``: the
scene generator under ``rt_bench/scenes/`` and its arguments, the compile
options, the render constants) and a traffic mix
(``rt_bench/traffic/<name>.json``, read by ``rt_bench/traffic.py``).

A configuration may also name, each relative to ``rt_bench`` as a dotted
module name, the parts that run it beside its generator (:func:`parts`,
which everything that runs a configuration goes through):
- ``"handoff"``: a module with ``builder_of(spec, workdir)``, which hands
  the generated scene to the program and returns the program's
  ``SceneBuilder``; default ``port_scene``;
- ``"reference"``: the plain reference's package, with
  ``scene.build(spec, device, dtype=torch.float32)`` and
  ``integrator.render_pixels(rs, cfg, cam, pix, n_frames, colour=None)``;
  default ``reference``.  The comparison (``rt_bench/reference/compare.py``)
  is every configuration's;
- ``"small_args"``: the generator arguments the CPU tests' small cells
  override; read by ``rt_bench/tests/common.py`` alone, never by a run.

A generator's result (the spec) is read here and in ``traffic.py`` only
through ``spec.camera`` (the camera's keys, as ``Camera`` takes them) and
``spec.meta`` (the scene's layout, which the ``views`` mixes read).
Everything else goes unchanged to the configuration's hand-off and
reference, so a configuration may bring a spec type of its own in its own
generator module.

Set-up: generate the scene, hand it to the program in a work directory
that the harness makes for the run under ``TMPDIR`` and removes once the
scene is compiled (:func:`build_scene`), compile it on the card, make a
``ProgressiveRenderer`` with ``RenderConfig.seed = --seed``, and run one
warm step at the cell's shapes.  ``setup_s`` runs from the process's start
to the first timed step.

Window: ``ProgressiveRenderer.step`` back to back for ``--seconds``, each
ending in ``torch.cuda.synchronize()`` and timed on the host clock; a mix
with camera moves calls ``move_camera`` before the steps that start a new
view, inside that step's time, and its window runs on to the end of the
pass over its views that is under way at ``--seconds``, so that every
seed renders each view equally often.  ``msamples_per_s`` is width x
height x spp of every step over the window's wall time; ``step_p95_ms``
the 95th percentile of the steps' times.

With ``--trace 1`` the first :data:`TRACED_STEPS` steps of the window run
under ``torch.profiler``; every per-layer metric of ``BENCHMARK.json`` is
read from them by its reader ``rt_bench/metrics/<name>.py``, and the line
carries ``busy_s``, ``window_s`` and ``breakdown``.

Check: once the window has closed and the peak memory is read, the image
the window accumulated is compared at pixels drawn from the seed, one in
each tile of a grid over the frame (:func:`sample_pixels`), with the
configuration's plain reference's, after the program's state is freed
(:func:`check`).

The harness keeps its spans in memory and writes them at exit to
``build/rt_bench/spans/`` in the checkout.  ``TRITON_CACHE_DIR`` is set to
``build/triton`` there: the program builds no Triton kernel today, so
nothing reads it yet.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from . import trace_view, traffic as traffic_mod
from .reference import compare

TRACED_STEPS = 16
PATH_BUDGET = 1 << 20  # reference paths a check traces
MIN_PIXELS = 64
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracer_tpu")
HANDOFF = "port_scene"  # a configuration's parts where it names none
REFERENCE = "reference"


class Spans:
    """Named host-clock intervals, kept in memory."""

    def __init__(self, origin: float):
        self.origin = origin
        self.items = []

    def add(self, name: str, start: float, end: float, **attrs):
        self.items.append(dict(name=name, start=start - self.origin,
                               end=end - self.origin, **attrs))

    def seconds(self, name: str) -> float:
        return sum(s["end"] - s["start"] for s in self.items
                   if s["name"] == name)

    @contextlib.contextmanager
    def timed(self, name: str):
        t = time.perf_counter()
        yield
        self.add(name, t, time.perf_counter())


def process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(root, *parts):
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def generate(config: dict):
    gen = importlib.import_module(f"rt_bench.scenes.{config['generator']}")
    return gen.generate(**config["generator_args"])


@dataclass(frozen=True)
class Parts:
    """The modules that run a configuration beside its generator, named
    relative to ``rt_bench``; each is imported where it is first used."""

    handoff_name: str
    reference_name: str

    @property
    def handoff(self):
        """The module whose ``builder_of(spec, workdir)`` hands the scene to
        the program."""
        return importlib.import_module(f"rt_bench.{self.handoff_name}")

    @property
    def reference(self):
        """The plain reference's package, its ``scene`` and ``integrator``
        loaded."""
        name = f"rt_bench.{self.reference_name}"
        for sub in ("scene", "integrator"):
            importlib.import_module(f"{name}.{sub}")
        return importlib.import_module(name)


def parts(config: dict) -> Parts:
    """The configuration's own ``handoff`` and ``reference``, the defaults
    where it names none."""
    return Parts(config.get("handoff", HANDOFF),
                 config.get("reference", REFERENCE))


def build_scene(handoff, config: dict, spec, dev, spans: Spans):
    """The program's compiled scene.  The configuration's ``handoff``
    (:attr:`Parts.handoff`) builds it (span ``build``) in a work directory
    made for this run under ``TMPDIR``.  The directory stays until the
    ``compile`` span has ended, since the program reads the files written
    there (meshes, materials, images) when it compiles, and goes then, or
    as soon as either step raises."""
    with tempfile.TemporaryDirectory(prefix="rt_bench_work_") as workdir:
        with spans.timed("build"):
            builder = handoff.builder_of(spec, workdir)
        with spans.timed("compile"):
            return builder.compile(device=dev, **config["compile"])


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample_pixels(seed: int, width: int, height: int, n_frames: int,
                  spp: int):
    """The pixels the check compares, drawn from the seed: about as many as
    a budget of reference paths allows at this many samples a pixel, one
    in each tile of a grid over the frame (every pixel where the budget
    covers them all)."""
    per = max(1, n_frames * spp)
    count = max(MIN_PIXELS, PATH_BUDGET // per)
    if count >= width * height:
        return np.arange(width * height)
    gy = min(height, max(1, round(math.sqrt(count * height / width))))
    gx = min(width, max(1, count // gy))
    rng = np.random.default_rng([seed % 2**63, 0xC4EC])
    x0 = np.arange(gx) * width // gx
    y0 = np.arange(gy) * height // gy
    x = x0 + rng.integers(0, np.diff(np.append(x0, width)), (gy, gx))
    y = y0[:, None] + rng.integers(
        0, np.diff(np.append(y0, height))[:, None], (gy, gx))
    return np.sort((y * width + x).ravel())


def run_cell(root: str, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, spans: Spans,
             limits: dict, metric_names=(), min_steps: int = 1):
    """Set-up, window and check of one run -> the result's fields.  The
    window runs at least ``min_steps`` steps (and the traced ones), and
    whole passes over a mix's views."""
    import torch

    with spans.timed("import"):
        import ray_tracer_tpu_torch as trt
        handoff = parts(config).handoff

    dev = torch.device(device)
    with spans.timed("generate"):
        spec = generate(config)
    scene = build_scene(handoff, config, spec, dev, spans)
    cfg = trt.RenderConfig(width=mix["width"], height=mix["height"],
                           samples_per_pixel=mix["spp"],
                           bounce_limit=mix["bounce_limit"], seed=seed,
                           **config["render"])
    move_every, views = traffic_mod.camera_plan(mix, spec.meta, spec.camera,
                                                seed)
    renderer = trt.ProgressiveRenderer(scene, cfg)
    prof = None
    if trace:
        # on before the warm step, which takes the profiler's own start-up
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    with spans.timed("warm"):
        renderer.step()
        sync(dev)

    # ---- the window
    times = []
    samples_per_step = mix["width"] * mix["height"] * mix["spp"]
    view = 0
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    t_end = w0 + seconds
    cycle = move_every * len(views) or 1  # steps a pass over the views
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end and k >= max(min_steps, TRACED_STEPS * trace) \
                and k % cycle == 0:
            break
        with torch.profiler.record_function(f"{trace_view.STEP_SPAN} k={k}") \
                if prof is not None and k < TRACED_STEPS \
                else contextlib.nullcontext():
            if move_every and k % move_every == 0:
                view = (k // move_every) % len(views)
                renderer.move_camera(trt.Camera(**views[view]))
            renderer.step()
            sync(dev)
        t1 = time.perf_counter()
        if prof is not None and k + 1 == TRACED_STEPS:
            prof.__exit__(None, None, None)
        times.append(t1 - t0)
        spans.add("step", t0, t1, k=k, view=view)
        k += 1
    window_s = t1 - w0

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_frames = renderer.frame
    cam = views[view] if move_every else spec.camera
    pix = sample_pixels(seed, mix["width"], mix["height"], n_frames,
                        mix["spp"])
    got = renderer.accum.reshape(-1, 3)[torch.as_tensor(pix, device=dev)]
    got = got.float().cpu()
    del renderer, scene
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tv = None
    if prof is not None:
        own = trace_view.own_kernel_names(os.path.dirname(trt.__file__))
        tv = trace_view.from_profiler(
            prof, {"compile": spans.seconds("compile")}, own)
        del prof

    with spans.timed("check"):
        want = check(spec, config, mix, seed, cam, pix, n_frames, dev)
    found = compare.numbers(got, want)
    correct, rows = compare.judge(found, limits)

    metrics = {}
    device_info = {}
    if tv is None:
        metrics["msamples_per_s"] = dict(
            value=len(times) * samples_per_step / window_s / 1e6,
            unit="Msamples/s")
        metrics["step_p95_ms"] = dict(
            value=float(np.percentile(np.asarray(times), 95)) * 1e3,
            unit="ms")
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    else:
        for name, unit in metric_names:
            reader = importlib.import_module(f"rt_bench.metrics.{name}")
            value = reader.read(tv)
            if value is not None:
                metrics[name] = dict(value=float(value), unit=unit)
        device_info = dict(busy_s=tv.busy_us / 1e6, window_s=tv.window_us / 1e6)
    return dict(
        correct=bool(correct), attempted=len(times), failed=0,
        metrics=metrics, peak=peak, device_info=device_info,
        breakdown=(dict(device_ops=tv.top_ops(), idle_gaps=tv.idle_gaps())
                   if tv is not None else None),
        rows=rows, frames=n_frames, pixels=int(pix.size),
        step_median_ms=statistics.median(times) * 1e3,
        check_s=spans.seconds("check"),
    )


def check(spec, config, mix, seed, cam, pix, n_frames, dev):
    """The configuration's plain reference's image at the sampled pixels,
    on ``dev``."""
    import torch

    ref = parts(config).reference
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rs = ref.scene.build(spec, dev)
    cfg = dict(width=mix["width"], height=mix["height"], spp=mix["spp"],
               bounce_limit=mix["bounce_limit"], seed=seed, **config["render"])
    img = ref.integrator.render_pixels(rs, cfg, cam, torch.as_tensor(
        pix, device=dev), n_frames)
    return img.float().cpu()


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    age = process_age()
    t_start = time.perf_counter() - age
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = load_json(root, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"rt_bench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    config = load_json(root, "rt_bench", "configs", f"{cell['config']}.json")
    mix = traffic_mod.load(root, cell["traffic"])
    names = [(m["name"], m["unit"]) for m in bench["per_layer"]]
    spans = Spans(t_start)
    res = run_cell(root, config, mix, args.seed, args.seconds,
                   bool(args.trace), "cuda", t_start, spans,
                   compare.limits(root, args.workload), names)
    write_spans(build, args, spans)

    bad = forbidden_modules()
    if bad:
        print("rt_bench: loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"], memory_peak_bytes=int(res["peak"]),
                  **res["device_info"])
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"], device=device)
    if res["breakdown"] is not None:
        line["breakdown"] = res["breakdown"]
    line["run"] = dict(frames=res["frames"], pixels=res["pixels"],
                       step_median_ms=res["step_median_ms"],
                       check_s=res["check_s"])
    line["compared"] = {name: dict(value=v, limit=lim)
                        for name, v, lim in res["rows"]}
    for name, v, lim in res["rows"]:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def write_spans(build: str, args, spans: Spans) -> None:
    out = os.path.join(build, "rt_bench", "spans")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{args.workload}.seed{args.seed}."
                             f"trace{args.trace}.json")
    with open(path, "w") as f:
        json.dump(spans.items, f)
