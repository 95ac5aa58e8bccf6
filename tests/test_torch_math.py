"""Math leaves of the torch port against the JAX package, on CPU.

Same numpy inputs through both; RNG bits and the bin key must be equal,
float results agree within rtol=atol=1e-6: the two frameworks' sin, cos,
tan and pow differ in the last bit, and XLA contracts the multiply-adds of
a jitted function (``jnp.cross`` is one) into FMAs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.api import _camera_arrays as j_camera_arrays
from ray_tracer_tpu.integrator import film as j_film
from ray_tracer_tpu.integrator import wavefront as j_wave
from ray_tracer_tpu.ops import env as j_env
from ray_tracer_tpu.ops import intersect as j_isect
from ray_tracer_tpu.sampling import bsdf as j_bsdf
from ray_tracer_tpu.sampling import lights as j_lights
from ray_tracer_tpu.sampling import rng as j_rng
from ray_tracer_tpu_torch.api import _camera_arrays as t_camera_arrays
from ray_tracer_tpu_torch.integrator import film as t_film
from ray_tracer_tpu_torch.integrator import wavefront as t_wave
from ray_tracer_tpu_torch.ops import env as t_env
from ray_tracer_tpu_torch.ops import intersect as t_isect
from ray_tracer_tpu_torch.sampling import bsdf as t_bsdf
from ray_tracer_tpu_torch.sampling import lights as t_lights
from ray_tracer_tpu_torch.sampling import rng as t_rng

from torch_parity import room_scene

TOL = dict(rtol=1e-6, atol=1e-6)
N = 4096


def close(got, want, **kw):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), **(kw or TOL)
    )


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def unit(rand, n):
    v = rand.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The room scene compiled by each package (two rect lights, so the
    multi-light sampling path runs too)."""
    tmp = str(tmp_path_factory.mktemp("room"))
    out = []
    for pkg in (jrt, trt):
        b = room_scene(pkg, tmp)
        b.add_rect_light(corner=(1.0, -1.2, 0.5), edge_u=(0.0, 0.0, 0.3),
                         edge_v=(0.3, 0.0, 0.0), normal=(0, -1, 0),
                         material=3)
        out.append(b)
    jb, tb = out
    return jb.compile().device_put(), tb.compile(device="cpu")


@pytest.mark.parametrize("frame,seed", [(0, 0), (7, 12345), (2**31 + 5, 99)])
def test_rng_bit_exact(rand, frame, seed):
    pix = rand.integers(0, 2**31 - 1, N).astype(np.int32)
    sample = rand.integers(0, 2**20, N).astype(np.int32)
    bounce = rand.integers(0, 9, N).astype(np.int32)
    want = j_rng.uniforms(seed, jnp.asarray(pix), frame, jnp.asarray(sample),
                          jnp.asarray(bounce), 7)
    got = t_rng.uniforms(seed, torch.from_numpy(pix), frame,
                         torch.from_numpy(sample), torch.from_numpy(bounce), 7)
    assert got.dtype == torch.float32
    equal(got, want)


def test_intersect_spheres(rand):
    o = rand.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = unit(rand, N)
    pos = rand.uniform(-2, 2, (5, 3)).astype(np.float32)
    rad = np.array([0.5, 1.0, 0.0, 2.0, 0.3], np.float32)
    want = j_isect.intersect_spheres(*map(jnp.asarray, (o, d, pos, rad)))
    got = t_isect.intersect_spheres(*map(torch.from_numpy, (o, d, pos, rad)))
    close(got[0], want[0])
    equal(got[1], want[1])
    equal(got[2], want[2])


def test_intersect_tris(rand):
    o = rand.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = unit(rand, N)
    v0 = rand.uniform(-1, 1, (N, 3)).astype(np.float32)
    e1 = rand.uniform(-1, 1, (N, 3)).astype(np.float32)
    e2 = rand.uniform(-1, 1, (N, 3)).astype(np.float32)
    n = np.cross(e1, e2).astype(np.float32)
    fo = rand.uniform(size=N) < 0.5
    want = j_isect.intersect_tris(*map(jnp.asarray, (o, d, v0, e1, e2, n, fo)))
    got = t_isect.intersect_tris(
        *map(torch.from_numpy, (o, d, v0, e1, e2, n, fo))
    )
    # dst, u, v, w: a last-bit difference of jnp.cross's FMA is amplified
    # by 1/det on near-degenerate random triangles (9 of 4096 lanes beyond
    # 1e-6, the worst 5e-5 relative)
    for k in range(4):
        close(got[k], want[k], rtol=1e-4, atol=1e-5)
    equal(got[4], want[4])
    equal(got[5], want[5])


def test_slab_test(rand):
    o = rand.uniform(-3, 3, (N, 3)).astype(np.float32)
    inv = 1.0 / unit(rand, N)
    lo = rand.uniform(-2, 0, (N, 3)).astype(np.float32)
    hi = lo + rand.uniform(0, 2, (N, 3)).astype(np.float32)
    want = j_isect.slab_test(*map(jnp.asarray, (o, inv, lo, hi)))
    got = t_isect.slab_test(*map(torch.from_numpy, (o, inv, lo, hi)))
    close(got, want)


def test_reflect_refract(rand):
    i, n = unit(rand, N), unit(rand, N)
    eta = rand.uniform(0.4, 2.5, N).astype(np.float32)
    close(t_isect.reflect(*map(torch.from_numpy, (i, n))),
          j_isect.reflect(*map(jnp.asarray, (i, n))))
    close(t_isect.refract(*map(torch.from_numpy, (i, n, eta))),
          j_isect.refract(*map(jnp.asarray, (i, n, eta))))


def test_environment_light(rand, scenes):
    jsc, tsc = scenes
    d = unit(rand, N)
    d[:8] = -np.asarray(jsc.env_light_dir[:3])  # straight into the sun
    close(t_env.environment_light(tsc, torch.from_numpy(d)),
          j_env.environment_light(jsc, jnp.asarray(d)))


def test_cosine_hemisphere(rand):
    n = unit(rand, N)
    n[:4] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1]]
    r1, r2 = rand.uniform(size=(2, N)).astype(np.float32)
    jd = j_bsdf.cosine_hemisphere_dir(*map(jnp.asarray, (n, r1, r2)))
    td = t_bsdf.cosine_hemisphere_dir(*map(torch.from_numpy, (n, r1, r2)))
    close(td, jd)
    close(t_bsdf.cosine_hemisphere_pdf(torch.from_numpy(n), td),
          j_bsdf.cosine_hemisphere_pdf(jnp.asarray(n), jd))


def test_schlick(rand):
    c = rand.uniform(-1, 1, N).astype(np.float32)
    ior = rand.uniform(0.3, 3, N).astype(np.float32)
    close(t_bsdf.schlick(*map(torch.from_numpy, (c, ior))),
          j_bsdf.schlick(*map(jnp.asarray, (c, ior))))


@pytest.mark.parametrize("n_lights", [1, 2])
def test_rect_lights(rand, scenes, n_lights):
    jsc, tsc = scenes
    if n_lights == 1:
        jsc = jsc.tree_unflatten(dict(jsc.meta, n_lights=1), jsc.tree_flatten()[0])
        tsc = trt.CompiledScene(**{
            **{f: getattr(tsc, f) for f in tsc.array_fields()},
            "meta": dict(tsc.meta, n_lights=1),
        })
    o = rand.uniform(-1, 0.4, (N, 3)).astype(np.float32)
    r = rand.uniform(size=(3, N)).astype(np.float32)
    jd, jli, jw, jdist = j_lights.sample_rect_light(
        jsc, jnp.asarray(o), *map(jnp.asarray, r)
    )
    td, tli, tw, tdist = t_lights.sample_rect_light(
        tsc, torch.from_numpy(o), *map(torch.from_numpy, r)
    )
    close(td, jd)
    equal(tli, jli)
    assert tw == float(jw)
    close(tdist, jdist)
    close(t_lights.rect_light_pdf_analytic(tsc, tli.long(), td, tdist),
          j_lights.rect_light_pdf_analytic(jsc, jli, jd, jdist))
    equal(t_lights.rect_light_emission(tsc, tli.long()),
          j_lights.rect_light_emission(jsc, jli))


@pytest.mark.parametrize("size,fov,angles", [
    ((40, 40), 50.0, (4.0, 0.0, 0.0)),
    ((64, 36), 60.0, (2.0, -14.0, 0.0)),
])
def test_raygen(rand, size, fov, angles):
    w, h = size
    cam = jrt.Camera(position=(0.3, -1.0, -2.0), angles_deg=angles, fov=fov)
    jcam = j_camera_arrays(cam, jrt.RenderConfig(width=w, height=h))
    tcam = t_camera_arrays(cam, trt.RenderConfig(width=w, height=h), "cpu")
    ids = np.arange(w * h, dtype=np.int32)
    jitter = rand.uniform(-0.5, 0.5, (w * h, 2)).astype(np.float32)
    for jit in (None, jitter):
        jr = j_wave.raygen(*jcam, jnp.asarray(ids), w, h,
                           None if jit is None else jnp.asarray(jit))
        tr = t_wave.raygen(*tcam, torch.from_numpy(ids), w, h,
                           None if jit is None else torch.from_numpy(jit))
        close(tr.origin, jr.origin)
        close(tr.direction, jr.direction)


@pytest.mark.parametrize("mb,db", [(6, 0), (5, 2)])
def test_bin_key_exact(rand, scenes, mb, db):
    jsc, tsc = scenes
    o = rand.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    d = unit(rand, N)
    d[:6] = [[0, 0, 0], [-0.0, 1, 0], [1, -0.0, 0], [0, 0, -1], [1, 0, 0],
             [-1, -1, -1]]
    alive = rand.uniform(size=N) < 0.8
    want = j_wave._bin_key(jsc, *map(jnp.asarray, (o, d, alive)), mb, db)
    got = t_wave._bin_key(tsc, *map(torch.from_numpy, (o, d, alive)), mb, db)
    assert got.dtype == torch.int32
    equal(got, want)


def test_resolve_direct(rand):
    pdf = rand.uniform(-1, 5, N).astype(np.float32)
    pdf[::5] = 0.0
    cos_pdf = rand.uniform(0, 1, N).astype(np.float32)
    cos_pdf[::7] = 0.0
    l_emit = rand.uniform(0, 3, (N, 3)).astype(np.float32)
    nee_k = rand.uniform(0, 1, (N, 3)).astype(np.float32)
    is_diff, fresh = rand.uniform(size=(2, N)) < 0.6
    base = rand.uniform(-1, 1, (N, 3)).astype(np.float32)
    args = (pdf, 2.0, cos_pdf, l_emit, nee_k, is_diff, fresh, base)
    conv = lambda f: [a if isinstance(a, float) else f(a) for a in args]
    close(t_wave._resolve_direct(*conv(torch.from_numpy)),
          j_wave._resolve_direct(*conv(jnp.asarray)))


def test_film(rand):
    c = rand.uniform(-0.5, 2.0, (16, 16, 3)).astype(np.float32)
    c[0, 0, 1] = np.nan
    c[1, 1, 0] = np.inf
    acc = rand.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    jc, tc = both(c)
    close(t_film.finalize(tc), j_film.finalize(jc))
    close(t_film.linear_to_srgb(tc), j_film.linear_to_srgb(jc))
    equal(t_film.to_uint8_srgb(tc), j_film.to_uint8_srgb(jc))
    close(t_film.progressive_blend(torch.from_numpy(acc), tc.nan_to_num(), 3),
          j_film.progressive_blend(jnp.asarray(acc), jnp.nan_to_num(jc),
                                   jnp.int32(3)))
