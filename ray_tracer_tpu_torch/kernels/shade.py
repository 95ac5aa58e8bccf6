"""The wavefront round's kernels: shade, state permute and NEE resolve.

``csrc/shade_round.cu`` holds three hand-written kernels for the round of
``integrator/wavefront.py::_fused_round``, each behind a wrapper here that
launches it on CUDA tensors and runs its plain torch version on CPU
tensors (nothing falls back: a CUDA call that cannot launch raises):

* ``shade_kernel`` (:func:`shade_round`; plain: :func:`shade_round_reference`):
  one thread per lane from its pending hit to its next state: the shade
  fetch, the pending-light resolve, the sky, the RNG draws, the BSDF
  lobes and the rect-light sample, russian roulette, sample completion
  and regeneration, written as the packed row the permute moves (40 words,
  160 B: the f32 state, then the i32 words' bits), with the lane's morton
  bin key and the round's ray counts; where textures are in
  use (:func:`maps_on`) its maps instance, ``shade_kernel<true>``, adds
  the albedo, metalness and alpha maps and the bump maps, its sRGB decode
  a lookup in the round's table (:func:`srgb_table`), and counts the
  lanes its alpha maps cut out into a fifth word of the tally;
* ``permute_kernel`` (:func:`permute_rows`; plain:
  :func:`permute_rows_reference`): each lane's packed row gathered by the
  sorted order into the next wave's columns, each warp's 32 rows gathered
  into shared memory by the TMA engine first, and the runs of the sorted
  keys among the live lanes added to the round's tally;
* ``nee_resolve_kernel`` (:func:`nee_resolve`; plain:
  :func:`nee_resolve_reference`): the occlusion NEE's light side and the
  MIS resolve into the next ``direct``, each lane loading only what its
  flags say it needs.

They replace no Pallas kernel: the JAX package's round
(``ray_tracer_tpu/integrator/wavefront.py:1003-1400``) runs inside
``jax.lax.while_loop`` under ``jit``, where XLA fuses it into a few
kernels; the torch round runs it as some 800 launches.  The plain versions
are that torch round's own code (``integrator/shading.py``), so the CPU
path is today's arithmetic.  The kernels are built with ``--fmad=false``
and no fast math, and mirror torch's CUDA kernels op for op (see the
source), so on the card each equals its plain version.

Each wrapper counts its launches in ``launches``, the shade kernel's
two instances apart (the CPU path adds nothing).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from ..integrator import shading
from ..native_build import build_shared, nvcc_path
from .bvh8 import CSRC, NVCC_FLAGS, check_tensors

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool
_SRC = os.path.join(CSRC, "shade_round.cu")
# frame_constants: rotation 9 | position 3 | plane w, h, -w/2, -h/2 | the
# bin key's box: minimum 3, extent 3
N_CONSTS = 22

launches = {"shade_round": 0, "shade_round_maps": 0, "permute_rows": 0,
            "nee_resolve": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Round(NamedTuple):
    """What every round of one wavefront call reads: the scene, its
    configuration and resolved routing, the id space of triangle hits
    (``traverse.prim_space``), the camera ``(rotation, position, fov,
    aspect, near)``, the frame index, the samples per lane, the shade
    kernel's per-frame constants (:func:`frame_constants`; None where the
    torch round runs) and, where its maps instance runs, the sRGB table
    (:func:`srgb_table`)."""

    scene: object
    cfg: object
    rt: object
    space: str
    cam: tuple
    frame: int
    n_spp: int
    consts: Optional[torch.Tensor]
    srgb: Optional[torch.Tensor] = None


def _flat(scene) -> bool:
    return bool(scene.meta.get("flattened", False))


maps_on = shading.maps_on  # does the maps instance run


def srgb_table(device) -> torch.Tensor:
    """(256,) f32 on ``device``: ``shading.srgb_to_linear`` of every byte,
    by the plain version's own ops there, so that the maps instance's
    decode (a lookup) equals the plain version's on that device."""
    return shading.srgb_to_linear(
        torch.arange(256, dtype=torch.uint8, device=device))


def frame_constants(scene, cam) -> torch.Tensor:
    """(N_CONSTS,) f32 on the scene's device: the camera's rotation and
    position, the view plane's size and corner as ``shading.raygen``
    computes them, and the bin key's box (``shading.bin_box``: minimum and
    clamped extent; zeros where the key has no morton bits), each by the
    same torch ops."""
    rot, pos, fov, aspect, near = cam
    plane_h = near * torch.tan(torch.deg2rad(fov * 0.5)) * 2.0
    plane_w = plane_h * aspect
    plane = torch.stack([plane_w, plane_h, -plane_w / 2.0, -plane_h / 2.0])
    box = shading.bin_box(scene)
    if box is not None:
        box = torch.cat(box)
    else:
        box = torch.zeros(6, dtype=F32, device=rot.device)
    return torch.cat([rot.reshape(9), pos.reshape(3), plane.reshape(4),
                      box]).to(F32).contiguous()


# ---- plain versions -------------------------------------------------------


def shade_round_reference(c: Round, w):
    """The shade kernel's function in torch: ``(packed, key, tally)``: the
    round's next lane state as (N,40) f32 rows (``shading.pack_lanes``:
    the i32 words as their bits), the lanes' morton bin key (N,) i32, and
    (4,) i64: the wave's ray counts after the round (semantic, traced:
    ``w.n_rays`` plus the live lanes plus the shadow rays counted and
    traced; no shadow rays without rect lights), the live count, and 0,
    the word the permute adds the key runs to (:func:`permute_rows`);
    where textures are in use (:func:`maps_on`), (5,): and the shaded
    lanes that an alpha map cut out."""
    scene = c.scene
    lanes, _, nee_sem, _, cut = shading.shade_lanes(
        scene, c.cfg, c.space, w, c.frame, c.n_spp, c.cam)
    packed = shading.pack_lanes(lanes)
    key = shading.bin_key(scene, lanes.origin, lanes.direction, lanes.alive,
                          c.rt.bin_bits, c.rt.bin_dir_bits)
    n_alive = lanes.alive.sum()
    if scene.n_lights == 0:
        n_nee = torch.zeros(2, dtype=I64, device=n_alive.device)
    else:
        n_nee = torch.stack([nee_sem.sum(), lanes.nee_active.sum()])
    words = [w.n_rays + n_alive + n_nee, n_alive.view(1),
             torch.zeros_like(n_alive).view(1)]
    if cut is not None:
        words.append(cut.sum().view(1))
    return packed, key, torch.cat(words)


def permute_rows_reference(packed, order, skey, runs) -> shading.Lanes:
    """The permute kernel's function in torch: row ``order[i]`` of the
    packed state as lane ``i`` of the next wave's columns, and
    ``shading.key_runs(skey)`` of the sorted keys ``skey`` added to the
    (1,) i64 ``runs`` (the round's tally's fourth word)."""
    runs += shading.key_runs(skey)
    return shading.unpack_lanes(packed[order])


def nee_resolve_reference(scene, lanes: shading.Lanes, occluded):
    """The NEE kernel's function in torch: the next ``direct`` (N,3) from
    the permuted lanes and the occlusion of their shadow rays (None
    without rect lights, whose NEE adds nothing)."""
    if scene.n_lights == 0:
        l_emit = torch.zeros_like(lanes.nee_k)
        real_l_pdf = torch.zeros_like(lanes.l_dist)
    else:
        l_emit, real_l_pdf = shading.analytic_nee(
            scene, lanes.li, lanes.l_dir, lanes.l_dist,
            lanes.nee_active & ~occluded)
    return shading.resolve_direct(
        real_l_pdf, float(scene.n_lights), lanes.cos_pdf_at_l, l_emit,
        lanes.nee_k, lanes.is_diff, lanes.fresh_direct, lanes.direct_base)


# ---- the kernels ----------------------------------------------------------


def build() -> str:
    """Compile the round's kernel library (once per source hash)."""
    return build_shared(_SRC, "shade_round", (nvcc_path(), *NVCC_FLAGS))


_P = ctypes.c_void_p


class _ShadeArgs(ctypes.Structure):
    """``ShadeArgs`` of ``csrc/shade_round.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "origin", "direction", "dst", "kind", "prim", "obj", "hit_u", "hit_v",
        "front", "atten", "total", "direct", "acc", "bad", "alive", "j", "s",
        "sb", "pix", "slot", "table", "obj_transform", "obj_mat",
        "sphere_pos", "sphere_mat", "mat_albedo", "mat_emission",
        "mat_emission_strength", "mat_reflectance", "mat_ior",
        "light_corner", "light_edge_u", "light_edge_v", "env_horizon",
        "env_zenith", "env_ground", "env_light_dir", "consts", "prev_rays",
        "packed", "key", "tally")] + [
        (name, ctypes.c_int) for name in (
            "n", "n_spheres", "n_lights", "n_spp", "bounce_limit",
            "rr_start", "width", "height", "aa_jitter", "tint", "mb", "db",
            "morton", "flat")] + [
        ("seed", ctypes.c_uint), ("frame", ctypes.c_uint),
        ("rr_clamp", ctypes.c_float)] + [
        (name, _P) for name in (
            "tex_data", "tex_size", "srgb", "obj_sampler", "mat_albedo_tex",
            "mat_metalness_tex", "mat_alpha_tex")] + [
        (name, ctypes.c_int) for name in (
            "maps", "enable_normal_maps", "tex_h", "tex_w")] + [
        ("bump_scale", ctypes.c_float)]


class _NeeArgs(ctypes.Structure):
    """``NeeArgs`` of ``csrc/shade_round.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "li", "l_dir", "l_dist", "nee_active", "occluded", "cos_pdf_at_l",
        "nee_k", "is_diff", "fresh_direct", "direct_base", "light_normal",
        "light_area", "light_mat", "mat_emission", "mat_emission_strength",
        "direct")] + [("n", ctypes.c_int), ("n_lights", ctypes.c_int)]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.rt_shade_round.restype = ctypes.c_int
        lib.rt_shade_round.argtypes = [ctypes.POINTER(_ShadeArgs), _P]
        lib.rt_permute_rows.restype = ctypes.c_int
        lib.rt_permute_rows.argtypes = [_P] * 8 + [ctypes.c_int, _P]
        lib.rt_nee_resolve.restype = ctypes.c_int
        lib.rt_nee_resolve.argtypes = [ctypes.POINTER(_NeeArgs), _P]
        _lib = lib
    return _lib


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no round kernel for device {t.device}")
    return t.device


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _scene_tables(scene, dev, srgb=None):
    """The scene arrays the shade kernel reads, checked; given the sRGB
    table ``srgb``, those of its maps instance too."""
    s = scene
    check_tensors(dev, F32,
                  mat_albedo=(s.mat_albedo, (s.mat_albedo.shape[0], 3)),
                  mat_emission=(s.mat_emission, s.mat_albedo.shape),
                  mat_emission_strength=(s.mat_emission_strength,
                                         s.mat_albedo.shape[:1]),
                  mat_reflectance=(s.mat_reflectance, s.mat_albedo.shape[:1]),
                  mat_ior=(s.mat_ior, s.mat_albedo.shape[:1]),
                  light_corner=(s.light_corner, (s.light_corner.shape[0], 3)),
                  light_edge_u=(s.light_edge_u, s.light_corner.shape),
                  light_edge_v=(s.light_edge_v, s.light_corner.shape),
                  obj_transform=(s.obj_transform,
                                 (s.obj_transform.shape[0], 4, 4)),
                  env_horizon=(s.env_horizon, (4,)),
                  env_zenith=(s.env_zenith, (4,)),
                  env_ground=(s.env_ground, (3,)),
                  env_light_dir=(s.env_light_dir, (4,)))
    check_tensors(dev, I32, obj_mat=(s.obj_mat, s.obj_transform.shape[:1]))
    if s.light_corner.shape[0] < max(s.n_lights, 1):
        raise ValueError("the light table has fewer rows than lights")
    if s.n_spheres:
        check_tensors(dev, F32, sphere_pos=(s.sphere_pos, (s.n_spheres, 3)))
        check_tensors(dev, I32, sphere_mat=(s.sphere_mat, (s.n_spheres,)))
    if srgb is not None:
        n_mat = s.mat_albedo.shape[:1]
        n_tex = s.tex_size.shape[0]
        check_tensors(dev, torch.uint8, tex_data=(
            s.tex_data, (n_tex, *s.tex_data.shape[1:3], 3)))
        check_tensors(dev, I32, tex_size=(s.tex_size, (n_tex, 2)),
                      obj_sampler=(s.obj_sampler, s.obj_transform.shape[:1]),
                      mat_albedo_tex=(s.mat_albedo_tex, n_mat),
                      mat_metalness_tex=(s.mat_metalness_tex, n_mat),
                      mat_alpha_tex=(s.mat_alpha_tex, n_mat))
        check_tensors(dev, F32, srgb=(srgb, (256,)))


def shade_args(c: Round, w):
    """The shade kernel's arguments for the wave ``w`` on the card,
    checked, and its outputs ``(packed, key, tally)``, allocated
    (``tally`` zeroed, (4,) or (5,) as :func:`shade_round_reference`'s):
    ``(args, outputs)``.  ``args`` holds the tensors'
    addresses only: the caller keeps ``c``, ``w`` and the outputs alive
    while a launch may read them."""
    dev = _device(w.origin)
    scene, cfg, rt = c.scene, c.cfg, c.rt
    n = w.origin.shape[0]
    table = scene.shade_tri if c.space == "tri" else scene.shade_slot
    hit = w.hit
    check_tensors(dev, F32, origin=(w.origin, (n, 3)),
                  direction=(w.direction, (n, 3)), dst=(hit.dst, (n,)),
                  hit_u=(hit.u, (n,)), hit_v=(hit.v, (n,)),
                  atten=(w.atten, (n, 3)), total=(w.total, (n, 3)),
                  direct=(w.direct, (n, 3)), acc=(w.acc, (n, 3)),
                  table=(table, (table.shape[0], 48)),
                  consts=(c.consts, (N_CONSTS,)))
    check_tensors(dev, I32, kind=(hit.kind, (n,)), prim=(hit.prim, (n,)),
                  obj=(hit.obj, (n,)), j=(w.j, (n,)), s=(w.s, (n,)),
                  sb=(w.sb, (n,)), pix=(w.pix, (n,)), slot=(w.slot, (n,)))
    check_tensors(dev, BOOL, front=(hit.front, (n,)), bad=(w.bad, (n,)),
                  alive=(w.alive, (n,)))
    check_tensors(dev, I64, prev_rays=(w.n_rays, (2,)))
    maps = maps_on(scene, cfg)
    if maps and c.srgb is None:
        raise ValueError("textures are in use: the round needs its sRGB "
                         "table (Round.srgb)")
    _scene_tables(scene, dev, c.srgb if maps else None)
    if table.shape[0] == 0 or n >= 2**31 // shading.ROW:
        raise ValueError("an empty shade table, or too many lanes")
    packed = torch.empty((n, shading.ROW), dtype=F32, device=dev)
    key = torch.empty(n, dtype=I32, device=dev)
    tally = torch.zeros(5 if maps else 4, dtype=I64, device=dev)
    ptr = lambda t: t.data_ptr()
    # the maps' fields, left zero where the untextured instance runs
    maps_args = () if not maps else (
        *(ptr(t) for t in (
            scene.tex_data, scene.tex_size, c.srgb, scene.obj_sampler,
            scene.mat_albedo_tex, scene.mat_metalness_tex,
            scene.mat_alpha_tex)),
        1, int(cfg.enable_normal_maps), *scene.tex_data.shape[1:3],
        cfg.bump_scale)
    args = _ShadeArgs(
        *(ptr(t) for t in (
            w.origin, w.direction, hit.dst, hit.kind, hit.prim, hit.obj,
            hit.u, hit.v, hit.front, w.atten, w.total, w.direct, w.acc,
            w.bad, w.alive, w.j, w.s, w.sb, w.pix, w.slot, table,
            scene.obj_transform, scene.obj_mat, scene.sphere_pos,
            scene.sphere_mat, scene.mat_albedo, scene.mat_emission,
            scene.mat_emission_strength, scene.mat_reflectance,
            scene.mat_ior, scene.light_corner, scene.light_edge_u,
            scene.light_edge_v, scene.env_horizon, scene.env_zenith,
            scene.env_ground, scene.env_light_dir, c.consts, w.n_rays,
            packed, key, tally)),
        n, scene.n_spheres, scene.n_lights, c.n_spp, cfg.bounce_limit,
        cfg.rr_start_bounce, cfg.width, cfg.height, int(cfg.aa_jitter),
        int(cfg.tint_spec_diel), rt.bin_bits, rt.bin_dir_bits,
        int(shading.morton_bits(scene)), int(_flat(scene)),
        cfg.seed & 0xFFFFFFFF, c.frame & 0xFFFFFFFF, cfg.rr_clamp,
        *maps_args)
    return args, (packed, key, tally)


def shade_round(c: Round, w):
    """One round's shading of the wave ``w`` -> ``(packed, key, tally)``
    as :func:`shade_round_reference` returns them; on CUDA
    tensors one launch of ``shade_kernel``, its maps instance where
    :func:`maps_on` (the arguments' ``maps``)."""
    dev = _device(w.origin)
    if dev.type == "cpu":
        return shade_round_reference(c, w)
    args, out = shade_args(c, w)
    if w.origin.shape[0] == 0:
        out[2][:2] = w.n_rays
        return out
    _raise_on(_load().rt_shade_round(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream),
        "shade_kernel")
    launches["shade_round_maps" if args.maps else "shade_round"] += 1
    return out


def permute_rows(packed, order, skey, runs) -> shading.Lanes:
    """The packed rows gathered by ``order`` (N,) i64 into the next
    wave's columns, as :func:`permute_rows_reference` returns them (on
    CUDA tensors contiguous columns), and the runs of the sorted keys
    ``skey`` (N,) i32 added to ``runs`` (1,) i64; one launch of
    ``permute_kernel``."""
    dev = _device(packed)
    if dev.type == "cpu":
        return permute_rows_reference(packed, order, skey, runs)
    n = packed.shape[0]
    check_tensors(dev, F32, packed=(packed, (n, shading.ROW)))
    check_tensors(dev, I64, order=(order, (n,)))
    check_tensors(dev, I32, skey=(skey, (n,)))
    check_tensors(dev, I64, runs=(runs, (1,)))
    if packed.data_ptr() % 16:
        raise ValueError("the packed rows must be 16-byte aligned")
    vec, cols, flags, ints = permute_outputs(n, dev)
    if n:
        _raise_on(_load().rt_permute_rows(
            packed.data_ptr(), order.data_ptr(), vec.data_ptr(),
            cols.data_ptr(), flags.data_ptr(), ints.data_ptr(),
            skey.data_ptr(), runs.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream), "permute_kernel")
        launches["permute_rows"] += 1
    return permute_lanes(vec, cols, flags, ints)


def permute_outputs(n: int, dev):
    """The permute kernel's outputs for ``n`` lanes, allocated: nine (N,3)
    f32 vectors, two f32 columns, five bool flags, six i32 columns."""
    return (torch.empty((shading.N_VEC, n, 3), dtype=F32, device=dev),
            torch.empty((2, n), dtype=F32, device=dev),
            torch.empty((5, n), dtype=BOOL, device=dev),
            torch.empty((shading.PACKED_I, n), dtype=I32, device=dev))


def permute_lanes(vec, cols, flags, ints) -> shading.Lanes:
    """The :class:`shading.Lanes` the permute kernel's outputs hold."""
    alive, bad, fresh_direct, is_diff, nee_active = flags
    return shading.Lanes(
        *vec, alive, bad, fresh_direct, is_diff, cols[0], cols[1],
        nee_active, *ints)


def nee_args(scene, lanes: shading.Lanes, occluded):
    """The NEE kernel's arguments on the card, checked, and its output
    ``direct`` (N,3), allocated: ``(args, direct)``; ``args`` holds the
    tensors' addresses only (the caller keeps them alive)."""
    dev = _device(lanes.l_dir)
    n = lanes.l_dir.shape[0]
    if scene.n_lights and occluded is None:
        raise ValueError("rect lights need the shadow rays' occlusion")
    check_tensors(dev, F32, l_dir=(lanes.l_dir, (n, 3)),
                  l_dist=(lanes.l_dist, (n,)),
                  cos_pdf_at_l=(lanes.cos_pdf_at_l, (n,)),
                  nee_k=(lanes.nee_k, (n, 3)),
                  direct_base=(lanes.direct_base, (n, 3)),
                  light_normal=(scene.light_normal,
                                (scene.light_corner.shape[0], 3)),
                  light_area=(scene.light_area, scene.light_corner.shape[:1]),
                  mat_emission=(scene.mat_emission,
                                (scene.mat_emission.shape[0], 3)),
                  mat_emission_strength=(scene.mat_emission_strength,
                                         scene.mat_emission.shape[:1]))
    check_tensors(dev, I32, li=(lanes.li, (n,)),
                  light_mat=(scene.light_mat, scene.light_corner.shape[:1]))
    flags = dict(nee_active=(lanes.nee_active, (n,)),
                 is_diff=(lanes.is_diff, (n,)),
                 fresh_direct=(lanes.fresh_direct, (n,)))
    if occluded is not None:
        flags["occluded"] = (occluded, (n,))
    check_tensors(dev, BOOL, **flags)
    direct = torch.empty((n, 3), dtype=F32, device=dev)
    args = _NeeArgs(
        *(None if t is None else t.data_ptr() for t in (
            lanes.li, lanes.l_dir, lanes.l_dist, lanes.nee_active,
            occluded, lanes.cos_pdf_at_l, lanes.nee_k, lanes.is_diff,
            lanes.fresh_direct, lanes.direct_base, scene.light_normal,
            scene.light_area, scene.light_mat, scene.mat_emission,
            scene.mat_emission_strength, direct)),
        n, scene.n_lights)
    return args, direct


def nee_resolve(scene, lanes: shading.Lanes, occluded):
    """The next ``direct`` (N,3) as :func:`nee_resolve_reference` returns
    it; one launch of ``nee_resolve_kernel``."""
    dev = _device(lanes.l_dir)
    if dev.type == "cpu":
        return nee_resolve_reference(scene, lanes, occluded)
    args, direct = nee_args(scene, lanes, occluded)
    if args.n:
        _raise_on(_load().rt_nee_resolve(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream),
            "nee_resolve_kernel")
        launches["nee_resolve"] += 1
    return direct
