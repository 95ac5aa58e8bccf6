"""Host milliseconds a step inside the program's ``rt.first_wave`` and
``rt.round`` spans: the time the host takes to enqueue the first wave
and the rounds (the live-count reads between them excluded)."""

from rt_bench import program_spans


def read(tv):
    if not program_spans.readable(tv):
        return None
    return program_spans.host_us_in(tv, "first_wave", "round") / 1e3 \
        / tv.steps
