"""Device milliseconds a step of every operation that is not one of the
program's own kernels: torch's sorts, fills, gathers, copies and
arithmetic."""


def read(tv):
    if tv.steps == 0:
        return None
    return tv.device_us("other") / 1e3 / tv.steps
