"""The benchmark of ray_tracer_tpu_torch: harness, scenes, traffic, metric
readers and the plain reference.  See ``rt_bench/harness.py``."""
