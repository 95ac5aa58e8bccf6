"""Device milliseconds a step of the shade kernel's maps instance,
``shade_kernel<true>``, by name: the round's shading with the albedo,
bump and alpha maps.  A trace without it (an untextured scene, or no
device) reads None."""

import re

MAPS = re.compile(r"\bshade_kernel\s*<\s*true\s*>")


def read(tv):
    times = [b - a for n, a, b in tv.device if MAPS.search(n)]
    if tv.steps == 0 or not times:
        return None
    return sum(times) / 1e3 / tv.steps
