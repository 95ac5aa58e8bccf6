"""What a traced run hands its per-layer metric readers: the device
operations of the profiled steps, the host's operations beside them, and
the harness's spans.

The pattern is ``tools/profile_torch_frame.py``'s: ``torch.profiler`` over
a few steps, device time by kernel name and the union of the device
intervals.  The window is from the first profiled step's start to the last
one's end, as the harness's ``record_function`` spans mark them; busy time
is the union of the device operations' intervals inside it.
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field

STEP_SPAN = "rt_bench.step"
ROUND_KERNELS = ("shade_kernel", "permute_kernel", "nee_resolve_kernel")
WALK_SUFFIX = "_walk_kernel"  # the traversal kernels' names end so
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def own_kernel_names(package_dir: str) -> tuple:
    """The names of the ``__global__`` functions in the program's CUDA
    sources (``csrc/*.cu``)."""
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return tuple(sorted(names))


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@dataclass
class TraceView:
    steps: int  # profiled steps
    window: tuple  # (start, end) in the profiler's microseconds
    device: list  # (name, start, end) of each device operation inside it
    host: list  # (name, start, end) of each host operation inside it
    step_spans: list  # (label, start, end) of the profiled steps
    spans: dict  # harness span name -> seconds (set-up phases)
    own: tuple  # the program's kernel names
    _kind: dict = field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return union_us([(a, b) for _, a, b in self.device])

    def kind(self, name: str) -> str:
        """``round`` (the round's kernels), ``walk`` (the program's
        traversal kernels, ``*_walk_kernel``), ``own`` (the program's other
        kernels) or ``other`` (torch's kernels, copies and fills)."""
        if name not in self._kind:
            words = set(re.findall(r"\w+", name))
            own = words & set(self.own)
            if words & set(ROUND_KERNELS):
                self._kind[name] = "round"
            elif any(w.endswith(WALK_SUFFIX) for w in own):
                self._kind[name] = "walk"
            elif own:
                self._kind[name] = "own"
            else:
                self._kind[name] = "other"
        return self._kind[name]

    def device_us(self, kind: str) -> float:
        return sum(b - a for n, a, b in self.device if self.kind(n) == kind)

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, a, b in self.device:
            by[name] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches of the window with no device
        operation running, each named by the profiled step it falls in and
        the innermost host operation running as it starts."""
        merged = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [self.window[0]] + [x for m in merged for x in m] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            step = next((lab for lab, s, e in self.step_spans if s <= a < e),
                        "between steps")
            inner = [(e - s, name) for name, s, e in self.host
                     if s <= a < e and name != STEP_SPAN]
            op = min(inner)[1] if inner else "no host op"
            out.append([f"{step}: {op}"[:160], (b - a) / 1e6])
        return out


def from_profiler(prof, spans: dict, own: tuple) -> TraceView:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, steps = [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(STEP_SPAN):
            # the device timeline's copy of the span is no operation
            if e.device_type != cuda:
                steps.append((e.name[len(STEP_SPAN) + 1:] or "step", a, b))
        elif e.device_type == cuda:
            dev.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    steps.sort(key=lambda s: s[1])
    window = (steps[0][1], steps[-1][2]) if steps else (0.0, 0.0)
    inside = lambda evs: [(n, max(a, window[0]), min(b, window[1]))
                          for n, a, b in evs
                          if b > window[0] and a < window[1]]
    return TraceView(steps=len(steps), window=window, device=inside(dev),
                     host=inside(host), step_spans=steps, spans=spans,
                     own=own)
