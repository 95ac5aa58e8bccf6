"""A configuration's own plain reference, for the tests of
``harness.parts``: the benchmark's reference with its image scaled by
1.01, so a run judged by it cannot be correct."""
