"""Faults planted under the harness, to show that a run's check catches
what the timed path could get wrong.  Each fault is ``fault(patch)``,
where ``patch(obj, name, value)`` replaces an attribute of the program
(``pytest``'s ``monkeypatch.setattr``, or :class:`Patches`):
- ``unchanged_state``: every step after the first returns the image
  unchanged;
- ``half_the_samples``: a step renders half of its samples and takes the
  mean over them;
- ``altered_answer``: every colour the wavefront produces is 1% off.
No cell spans chips, so there is no exchange between chips to leave out.

Read at a cell's own size on the card, each fault in turn in one process:

    python3 rt_bench/faults.py --workload sponza_flat.progressive1080 \\
        --seeds 1,2,3 --seconds 5

One JSON line a seed and fault, with ``correct`` and the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def unchanged_state(patch):
    from ray_tracer_tpu_torch.integrator import film

    real = film.progressive_blend
    patch(film, "progressive_blend",
          lambda accum, color, frame: real(accum, color, frame)
          if frame == 0 else accum)


def half_the_samples(patch):
    from ray_tracer_tpu_torch import api

    real = api.render_frame

    def half(scene, cfg, camera=None, frame=0, n_samples=None,
             sample_base=0):
        n = cfg.samples_per_pixel if n_samples is None else n_samples
        return real(scene, cfg, camera, frame, max(1, n // 2), sample_base)

    patch(api, "render_frame", half)


def altered_answer(patch):
    from ray_tracer_tpu_torch.integrator import wavefront

    real = wavefront.trace_wave
    patch(wavefront, "trace_wave", lambda *a, **kw: real(*a, **kw) * 1.01)


FAULTS = {f.__name__: f for f in (unchanged_state, half_the_samples,
                                  altered_answer)}


class Patches:
    """``patch(obj, name, value)`` that :meth:`undo` takes back."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def main() -> int:
    import torch

    from rt_bench import harness, traffic as traffic_mod
    from rt_bench.reference import compare

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("rt_bench faults: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = harness.load_json(root, "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json(root, "rt_bench", "configs",
                               f"{cell['config']}.json")
    mix = traffic_mod.load(root, cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, fault in FAULTS.items():
            patches = Patches()
            fault(patches)
            t = time.perf_counter()
            try:
                res = harness.run_cell(
                    root, config, mix, seed, args.seconds, False, "cuda", t,
                    harness.Spans(t), compare.limits(root, args.workload))
            finally:
                patches.undo()
            print(json.dumps(dict(
                workload=args.workload, seed=seed, fault=name,
                correct=res["correct"], frames=res["frames"],
                pixels=res["pixels"],
                compared={n: dict(value=v, limit=lim)
                          for n, v, lim in res["rows"]})), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
