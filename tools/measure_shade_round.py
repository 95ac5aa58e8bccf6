"""Time the wavefront round's shade kernel against the design it replaced
and with each of its design elements switched, on one card.

    python3 tools/measure_shade_round.py

Builds ``csrc/shade_round.cu`` (the library as it ships) and
``tools/shade_round_variants.cu`` (the old kernel, and shade_kernel with
each element switched, the split layout of 34 f32 and 6 i32 words a lane
among them; see tools/shade_round_variants.py) in parallel,
compiles the benchmark frame's scene (sponza_proxy) and renders
chip_smoke's main frame once with the shade kernel's arguments captured.
On rounds 0 and 6 of that frame it holds the shipped kernel against the
plain version and every variant against the shipped kernel, bit for bit,
on the whole wave and on its first 1, 255, 4,410 and 32,769 lanes (ragged
last blocks), then times every variant in turns (CUDA events over 20
launches on arguments packed once: in order, then reversed), each beside
its share of chip_smoke's bound for the wave.

Prints the card's name and power limit, the ptxas lines of the shipped
kernel and of the variants, each variant's registers and blocks per SM as
the runtime reports them, then one JSON line per round.  Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import shade_round_variants as variants  # noqa: E402
import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.integrator import wavefront  # noqa: E402
from ray_tracer_tpu_torch.kernels import shade  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

NAMES = ("shipped", *variants.VARIANTS)
RAGGED = (1, 255, 4410, 32769)


def timed(runs) -> dict:
    """Every run of ``runs`` timed in turns: in order, then reversed."""
    ms, times = chip_smoke.turns(runs)
    return dict(ms=ms, vs_shipped={k: m / ms["shipped"]
                                   for k, m in ms.items()},
                ms_runs=times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_shade_round.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda build: build(),
                             (shade.build, variants.build)))
    for lib, name in ((libs[0], "shade_kernel"), (libs[1], "_kernel")):
        for k in chip_smoke.ptxas_of(lib, name):
            print(json.dumps({"ptxas": k["entry"], "lines": [
                ln for ln in k["lines"] if "registers" in ln or "spill" in ln
            ]}), flush=True)
    print(json.dumps({"info": {v: variants.info(v) for v in NAMES}}),
          flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    with chip_smoke.captured(shade, "shade_round") as shades:
        trt.render(sc, chip_smoke.frame_cfg())
        torch.cuda.synchronize()
    for r in chip_smoke.CHECK_ROUNDS:
        (c, w), _ = shades[r]
        n = w.origin.shape[0]
        variants.compare(f"round {r}: shipped against the plain version",
                         variants.run("shipped", c, w),
                         shade.shade_round_reference(c, w))
        for m in (*RAGGED, n):
            part = wavefront._slice_wave(w, min(m, n))
            want = variants.run("shipped", c, part)
            if m != n:
                variants.compare(f"round {r}, {m} lanes: shipped against "
                                 "the plain version", want,
                                 shade.shade_round_reference(c, part))
            for name in variants.VARIANTS:
                variants.compare(f"round {r}, {m} lanes: {name}",
                                 variants.run(name, c, part), want)
        runs = {name: variants.launcher(name, c, w)[0] for name in NAMES}
        rec = timed(runs)
        cost = chip_smoke.shade_cost(c, w)
        rec["share_of_bound"] = {k: cost["bound_ms"] / m
                                 for k, m in rec["ms"].items()}
        print(json.dumps({"round": r, "n": n, "equal": True,
                          "ragged_checked": RAGGED, **cost, **rec}),
              flush=True)


if __name__ == "__main__":
    main()
