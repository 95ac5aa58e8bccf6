"""Small cells for the CPU tests: the benchmark's own configurations and
mixes with the scene at each configuration's ``small_args`` (8,000 target
triangles where it names none), a 24x16 frame, and a camera that moves
every 2 steps over 2 views."""

import os
import time

from rt_bench import harness, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are
BENCH = harness.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL_ARGS = {"n_tris_target": 8000}  # where a configuration names none


def small_config(config: dict) -> dict:
    """``config`` with its generator's arguments at its ``small_args``."""
    return dict(config, generator_args=dict(
        config["generator_args"], **config.get("small_args", SMALL_ARGS)))


def small(cell: str, **config_keys):
    """The cell's configuration and mix at the small size; ``config_keys``
    replace keys of the configuration first (a test's own ``handoff``,
    ``reference`` or ``small_args``)."""
    w = harness.find_cell(BENCH, cell)
    config = small_config(dict(harness.load_json(
        ROOT, "rt_bench", "configs", f"{w['config']}.json"), **config_keys))
    mix = traffic.load(ROOT, w["traffic"])
    mix.update(width=24, height=16)
    if mix["camera"] == "views":
        mix.update(move_every=2, views=dict(mix["views"], count=2))
    return config, mix


def run_small(cell: str, steps: int = 3, trace: bool = False,
              seed: int = SEED, **config_keys):
    """A run of ``steps`` window steps (a window of no seconds)."""
    config, mix = small(cell, **config_keys)
    names = [(m["name"], m["unit"]) for m in BENCH["per_layer"]]
    t = time.perf_counter()
    from rt_bench.reference import compare
    return harness.run_cell(ROOT, config, mix, seed, 0.0, trace, "cpu",
                            t, harness.Spans(t), compare.limits(ROOT, cell),
                            names, min_steps=steps)
