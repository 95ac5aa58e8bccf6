"""Device milliseconds a step of the wavefront round's kernels:
``shade_kernel``, ``permute_kernel`` and ``nee_resolve_kernel``."""


def read(tv):
    if tv.steps == 0 or not any(tv.kind(n) == "round" for n, _, _ in tv.device):
        return None
    return tv.device_us("round") / 1e3 / tv.steps
