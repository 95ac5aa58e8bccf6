"""Device-idle milliseconds a step in the gaps that open while the host is
inside an ``rt.first_wave`` or ``rt.round`` span: the device ran dry
because the host enqueued the work more slowly than it ran."""

from rt_bench import program_spans


def read(tv):
    if not program_spans.readable(tv, idle=True):
        return None
    return program_spans.idle_us_opening_in(tv, "first_wave", "round") \
        / 1e3 / tv.steps
