"""Share of the lanes a round launched that were live: the program's
``rt.round`` spans (each its width and the live count the read before it
returned) summed over the window."""

from rt_bench import program_spans


def read(tv):
    rounds = program_spans.of_kind(tv, "round")
    if tv.steps == 0 or not rounds:
        return None
    lanes = sum(c["lanes"] for _, c, _, _ in rounds)
    return 100.0 * sum(c["live"] for _, c, _, _ in rounds) / lanes
