"""Device-idle milliseconds a step in the gaps that open while the host is
inside an ``rt.live_read`` span: the round trip of the round's live-count
read, which the device waits out until the next round's first launch."""

from rt_bench import program_spans


def read(tv):
    if not program_spans.readable(tv, idle=True):
        return None
    return program_spans.idle_us_opening_in(tv, "live_read") / 1e3 \
        / tv.steps
