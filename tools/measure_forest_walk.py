"""Time the forest walk against its design variants and the composition
it replaced, on one card.

    python3 tools/measure_forest_walk.py

Compiles ``sponza_proxy`` as a forest (``flatten_instances=False``: one
tree per instance) and builds ``csrc/bvh2_walk.cu`` and
``tools/forest_walk_variants.cu`` in parallel.  On chip_smoke's camera,
bounce and shadow sets of the forest frame at 2^18 lanes, each ordered by
the integrator's bin key, holds every variant of
tools/forest_walk_variants.py (the kernel before the cull, "old"; the
flat cull in the instance loop with and without its test on the best t
and at six blocks an SM; the flat cull into a mask; the chunk trees
staged in shared memory; the shipped kernel's copy at eight and six
blocks an SM)
against the shipped kernel
(``packet.forest_traverse``, closest hit on the camera and bounce sets,
occlusion on the shadow set; every output bit for bit) and times them all
in turns (CUDA events over 10 launches: in order, then reversed).  Then
holds the shipped kernel against "old composition"
(:func:`old_forest`: the per-instance composition the port ran before
any forest kernel, a cuBLAS product taking the rays to each instance's
object space, one narrow-walk launch and five ``torch.where`` merges per
instance) and times both in turns (old, new, new, old).  The two take
the rays to object space in different orders, so they agree within the
tolerances of :func:`compare_old`.

Prints the card's name and power limit, the forest kernels' and the
narrow walk's ptxas lines, then JSON lines per ray set.  Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ray_tracer_tpu_torch.kernels import packet  # noqa: E402
from ray_tracer_tpu_torch.ops.intersect import BIG  # noqa: E402

SETS = {"camera": False, "bounce": False, "shadow": True}  # -> anyhit


def old_forest(scene, origin, direction, tmax0, anyhit=False):
    """The per-instance forest walk as the port ran it before
    ``forest_walk_kernel``: for each instance, the rays stacked as (2N,4)
    homogeneous rows times the instance's inverse transform (one cuBLAS
    product), one narrow-walk launch (``packet.packet_traverse``) bounded
    by the best t so far, and the merges.  Returns what
    ``packet.forest_traverse`` returns: ``(dst, prim, obj, u, v, front)``,
    or under ``anyhit`` the mask of rays hit."""
    n = origin.shape[0]
    dev = origin.device
    h = torch.zeros((2 * n, 4), dtype=origin.dtype, device=dev)
    h[:n, :3] = origin
    h[:n, 3] = 1.0
    h[n:, :3] = direction
    t = tmax0.contiguous()
    tri = torch.zeros(n, dtype=torch.bool, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    obj = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    for k, (root, word) in enumerate(zip(scene.meta["obj_roots"],
                                         scene.meta["obj_root_words"])):
        od = h @ scene.obj_inv_transform[k, :3].T
        t_k, p_k, u_k, v_k, f_k = packet.packet_traverse(
            scene.bvh_packed, scene.bvh_axis, scene.tri_packed, od[:n],
            od[n:], t, root, word)
        hit = p_k >= 0
        tri = tri | hit
        if anyhit:
            t = torch.where(hit, -BIG, t_k)
            continue
        t = t_k
        prim = torch.where(hit, p_k, prim)
        obj = torch.where(hit, k, obj).to(torch.int32)
        u = torch.where(hit, u_k, u)
        v = torch.where(hit, v_k, v)
        front = torch.where(hit, f_k, front)
    return tri if anyhit else (t, prim, obj, u, v, front)


def compare_old(what, new, old, anyhit) -> dict:
    """Raise unless the forest walk and the old composition agree: the hit
    masks and, where both hit, the instances in all but 0.1% of the rays;
    ``dst`` within rtol 1e-5, atol 1e-6 in all but 1% of the rays both
    hit.  The two round the object-space ray apart by an ulp or two, and t
    moves by that rounding over the cosine of the hit's angle: grazing
    hits, and hits near a ray's origin (a bounce ray's next surface), move
    beyond the tolerance.  Returns the shares of rays apart."""
    if anyhit:
        rec = {"hits_apart": float((new != old).float().mean())}
    else:
        hit_n, hit_o = new[1] >= 0, old[1] >= 0
        both = hit_n & hit_o
        far = (new[0] - old[0]).abs() > 1e-6 + 1e-5 * old[0].abs()
        n_both = max(int(both.sum()), 1)
        rec = {"hits_apart": float((hit_n != hit_o).float().mean()),
               "obj_apart": float((both & (new[2] != old[2])).float()
                                  .mean()),
               "prim_apart": float((both & (new[1] != old[1])).float()
                                   .mean()),
               "dst_apart_of_both": int((both & far).sum()) / n_both}
    if max(rec["hits_apart"], rec.get("obj_apart", 0.0)) > 1e-3 \
            or rec.get("dst_apart_of_both", 0.0) > 1e-2:
        raise AssertionError(f"{what}: the forest walk and the old "
                             f"composition differ: {rec}")
    return rec


def forest_args(sc, rays):
    """``packet.forest_traverse``'s arguments for one ray set."""
    roots, words = sc.forest_roots
    return (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform,
            roots, words, sc.forest_cull, *rays)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_forest_walk.py needs a CUDA device")
    import chip_smoke
    import forest_walk_variants as variants
    from ray_tracer_tpu_torch.scene import presets

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(2) as pool:
        lib, path = pool.map(lambda build: build(),
                             (packet.build_narrow, variants.build))
    print(json.dumps({"ptxas": [
        [w["entry"], *w["lines"][-2:]]
        for found, name in ((lib, "forest_walk_kernel"),
                            (lib, "bvh2_walk_kernel"),
                            (path, "forest_walk_kernel"),
                            (path, "flat_forest_kernel"),
                            (path, "tree_forest_kernel"),
                            (path, "old_forest_kernel"))
        for w in chip_smoke.ptxas_of(found, name)]}), flush=True)
    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile(
        flatten_instances=False)
    t0 = time.perf_counter()
    trees = sc.forest_cull
    torch.cuda.synchronize()
    print(json.dumps({"instances": sc.meta["n_objects"],
                      "tree_rows": int(trees.shape[0]),
                      "forest_cull_s": time.perf_counter() - t0}), flush=True)
    rows = variants.scene_rows(sc)
    rays = chip_smoke.check_rays(sc, sc.device)
    names = ("shipped", *variants.VARIANTS)
    for name, anyhit in SETS.items():
        args = forest_args(sc, rays[name])
        runs = {"shipped": lambda args=args, anyhit=anyhit:
                packet.forest_traverse(*args, anyhit=anyhit)}
        for v in variants.VARIANTS:
            runs[v] = lambda v=v, args=args, anyhit=anyhit: variants.run(
                v, *args, anyhit=anyhit, rows=rows)
        want = runs["shipped"]()
        for v in variants.VARIANTS:
            variants.compare(f"{v} on {name} rays", runs[v](), want)
        times = {v: [] for v in names}
        for v in names + names[::-1]:
            times[v].append(chip_smoke.cuda_ms(runs[v], 10))
        ms = {v: statistics.mean(t) for v, t in times.items()}
        print(json.dumps({
            "rays": name, "n": chip_smoke.N_CHECK, "anyhit": anyhit,
            "device": smi, "equal": True,
            "active": int((rays[name][2] > -BIG).sum()), "ms": ms,
            "vs_shipped": {k: m / ms["shipped"] for k, m in ms.items()},
            "ms_runs": times}), flush=True)

        def old(rays=rays[name], anyhit=anyhit):
            return old_forest(sc, *rays, anyhit=anyhit)

        rec = compare_old(f"{name} rays", want, old(), anyhit)
        print(json.dumps({
            "rays": name, "against": "old composition",
            "n": chip_smoke.N_CHECK, "anyhit": anyhit,
            "instances": sc.meta["n_objects"], **rec,
            **chip_smoke.in_turns(runs["shipped"], old)}), flush=True)


if __name__ == "__main__":
    main()
