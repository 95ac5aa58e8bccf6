"""Small cells for the CPU tests: the benchmark's own configurations and
mixes with the scene at 8,000 target triangles, a 24x16 frame, and a
camera that moves every 2 steps over 2 views."""

import os
import time

from rt_bench import harness, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def small(cell: str):
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    w = harness.find_cell(bench, cell)
    config = harness.load_json(ROOT, "rt_bench", "configs",
                               f"{w['config']}.json")
    config["generator_args"] = dict(config["generator_args"],
                                    n_tris_target=8000)
    mix = traffic.load(ROOT, w["traffic"])
    mix.update(width=24, height=16)
    if mix["camera"] == "views":
        mix.update(move_every=2, views=dict(mix["views"], count=2))
    return config, mix


def run_small(cell: str, steps: int = 3, trace: bool = False,
              seed: int = SEED):
    """A run of ``steps`` window steps (a window of no seconds)."""
    config, mix = small(cell)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    names = [(m["name"], m["unit"]) for m in bench["per_layer"]]
    t = time.perf_counter()
    from rt_bench.reference import compare
    return harness.run_cell(ROOT, config, mix, seed, 0.0, trace, "cpu",
                            t, harness.Spans(t), compare.limits(ROOT, cell),
                            names, min_steps=steps)
