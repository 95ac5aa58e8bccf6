"""The reader of the round's key runs (``rt_bench/metrics/
lanes_per_key_run.py``): the ``runs=<n>`` word parsed, the value worked out
by hand on the synthetic trace of ``test_rt_bench_program_spans.py``, None
where no round carries the word (a trace of a program that does not count
them) or the trace holds no profiled step, and the small traced CPU run
reading it."""

import pytest

from rt_bench import harness, program_spans
from rt_bench.tests.test_rt_bench_program_spans import HOST, read, view

NAME = "lanes_per_key_run"
# the synthetic trace with its second round carrying the key runs of its
# wave, as a round after the first of its call does
RUNS = [(n + " runs=8" if n == "rt.round lanes=100 live=40" else n, a, b)
        for n, a, b in HOST]


def test_parse_runs():
    assert program_spans.parse("rt.round lanes=8 live=5 runs=2") == (
        "round", {"lanes": 8, "live": 5, "runs": 2})


def test_read_by_hand():
    # the one round with its runs: 40 live lanes in 8 runs
    assert read(NAME, view(host=RUNS)) == pytest.approx(5.0)
    more = RUNS + [("rt.live_read", 900.0, 910.0),
                   ("rt.round lanes=100 live=60 runs=2", 910.0, 950.0)]
    assert read(NAME, view(host=more)) == pytest.approx((40 + 60) / (8 + 2))
    # a count of the live lanes alone, no device operation needed
    assert read(NAME, view(host=RUNS, device=[])) == pytest.approx(5.0)


def test_none_without_the_runs_word():
    """A trace of a program whose rounds carry no ``runs`` word: the other
    counters read, this one reads None."""
    tv = view()
    assert read("live_lane_pct", tv) == pytest.approx(
        read("live_lane_pct", view(host=RUNS)))
    assert read(NAME, tv) is None


@pytest.mark.parametrize("host", [
    [h for h in RUNS if not h[0].startswith("rt.")], RUNS],
    ids=["no_ranges", "no_steps"])
def test_none_without_ranges_or_steps(host):
    steps = 2 if host is not RUNS else 0
    assert read(NAME, view(host=host, steps=steps)) is None


def test_a_small_traced_run_reads_the_key_runs(monkeypatch):
    from rt_bench.tests.common import run_small

    monkeypatch.setattr(harness, "TRACED_STEPS", 2)
    res = run_small("sponza_flat.progressive1080", steps=1, trace=True)
    m = res["metrics"]
    assert res["correct"]
    # morton-keyed rounds: a run holds at least one live lane, and far
    # fewer than a round's live lanes over the 8 octants
    assert 1.0 <= m[NAME]["value"] < 24 * 16 * 0.6 / 8
    assert m[NAME]["unit"] == "lanes"
