"""Live lanes a run of equal bin keys: the program's ``rt.round`` spans
that carry ``runs=<n>`` (the runs of equal keys among the live lanes of
the round's sorted wave, counted by the round kernels, carried with the
live count of the read before the round) summed over the window, live
lanes over runs.  A trace without the word (a program that does not count
them) reads None."""

from rt_bench import program_spans


def read(tv):
    rounds = [c for _, c, _, _ in program_spans.of_kind(tv, "round")
              if c.get("runs", 0) > 0]
    if tv.steps == 0 or not rounds:
        return None
    return sum(c["live"] for c in rounds) / sum(c["runs"] for c in rounds)
