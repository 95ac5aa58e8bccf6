"""The benchmark's reference scene, unchanged."""

from rt_bench.reference.scene import build  # noqa: F401
