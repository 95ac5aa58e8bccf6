"""Traced rays a sample: the program's ``rt.rays`` marks (one a wavefront
call: its samples and the rays its rounds traced, bounce and camera rays
with the NEE shadow rays) summed over the window, traced over samples."""

from rt_bench import program_spans


def read(tv):
    marks = program_spans.of_kind(tv, "rays")
    if tv.steps == 0 or not marks:
        return None
    samples = sum(c["samples"] for _, c, _, _ in marks)
    return sum(c["traced"] for _, c, _, _ in marks) / samples
