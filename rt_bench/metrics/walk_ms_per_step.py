"""Device milliseconds a step of the program's traversal kernels, by name:
its own CUDA kernels (``csrc/*.cu``) named ``*_walk_kernel`` (the BVH8
group walk, the forest walk, and the other routes' walks)."""


def read(tv):
    if tv.steps == 0 or not any(tv.kind(n) == "walk" for n, _, _ in tv.device):
        return None
    return tv.device_us("walk") / 1e3 / tv.steps
