"""Share of the live lanes whose surface an alpha map cut out: the
program's ``rt.round`` spans that carry ``cut=<n>`` (the cutout lanes the
round before counted, carried with the live count of the same read)
summed over the window, cutouts over live lanes.  An engagement counter,
read beside ``rays_per_sample``: each cutout is one more closest-hit
walk.  A trace without the word (no maps in use, or a program that does
not count them) reads None."""

from rt_bench import program_spans


def read(tv):
    rounds = [c for _, c, _, _ in program_spans.of_kind(tv, "round")
              if "cut" in c]
    if tv.steps == 0 or not rounds:
        return None
    return 100.0 * sum(c["cut"] for c in rounds) / sum(
        c["live"] for c in rounds)
