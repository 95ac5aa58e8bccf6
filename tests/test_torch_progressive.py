"""The port's ``ProgressiveRenderer`` against the JAX package's, on CPU.

``sphere_diffuse`` at 21x19 (odd sizes: no camera ray has an exactly zero
x or y direction), spp 2, bounce 3.  Each step's accumulation agrees with
the JAX class's, run op by op (``jax.disable_jit()``), on every pixel at
``atol=2e-3``: jitted, XLA's contracted arithmetic on the radius-100
ground sphere sends a few paths the other way (3 of the 399 pixels after
the camera move below; ROADMAP Queue C).  A state file moves between the
packages both ways and between the port's renderers exactly.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.scene import presets as j_presets
from ray_tracer_tpu_torch.scene import presets as t_presets

KW = dict(width=21, height=19, samples_per_pixel=2, bounce_limit=3, seed=7)
MOVED = dict(position=(0.3, -0.8, -2.6), angles_deg=(6.0, -8.0, 0.0))


@pytest.fixture(scope="module")
def scenes():
    return (j_presets.sphere_diffuse().compile().device_put(),
            t_presets.sphere_diffuse().compile(device="cpu"))


def _pair(scenes, **kw):
    jsc, tsc = scenes
    return (jrt.ProgressiveRenderer(jsc, jrt.RenderConfig(**{**KW, **kw})),
            trt.ProgressiveRenderer(tsc, trt.RenderConfig(**{**KW, **kw})))


def _step(j, t, n_samples=None):
    """One step of each; the JAX class's op by op."""
    out = t.step(n_samples)
    with jax.disable_jit():
        j.step(n_samples)
    return out


def _match(t, j):
    assert (t.frame, t.total_samples) == (j.frame, j.total_samples)
    np.testing.assert_allclose(t.accum.numpy(), np.asarray(j.accum),
                               atol=2e-3)


def test_steps_match_jax(scenes):
    j, t = _pair(scenes)
    assert t.accum.device == torch.device("cpu")
    assert float(t.accum.abs().sum()) == 0.0
    for _ in range(3):
        out = _step(j, t)
        assert out is t.accum
        _match(t, j)
    assert t.frame == 3 and t.total_samples == 6
    _step(j, t, n_samples=3)  # a step of another sample count
    _match(t, j)
    assert t.total_samples == 9


def test_progressive_converges_to_one_render(scenes):
    """Two steps of spp 2 are the mean of samples 0-3: one render at spp 4
    traces the same samples (the sample index runs on across steps)."""
    _, tsc = scenes
    _, t = _pair(scenes)
    t.step()
    t.step()
    one = trt.render(tsc, trt.RenderConfig(**{**KW, "samples_per_pixel": 4}))
    # frame 1's samples are keyed by frame too, so compare the mean level
    assert abs(float(t.accum.mean()) - float(one.mean())) < 0.02


def test_move_camera_matches_jax(scenes):
    j, t = _pair(scenes)
    _step(j, t)
    t.move_camera(trt.Camera(**MOVED))
    j.move_camera(jrt.Camera(**MOVED))
    assert t.frame == 0 and t.total_samples == 0
    assert float(t.accum.abs().sum()) == 0.0
    for _ in range(2):
        _step(j, t)
        _match(t, j)


def test_set_scene_matches_jax(scenes):
    j, t = _pair(scenes)
    _step(j, t)
    t.set_scene(t_presets.spheres_demo().compile(device="cpu"))
    j.set_scene(j_presets.spheres_demo().compile().device_put())
    assert t.frame == 0 and float(t.accum.abs().sum()) == 0.0
    _step(j, t)
    _match(t, j)


def test_save_load_round_trip(scenes, tmp_path):
    """A renderer resumed from the state file after step 2 gives the
    uninterrupted renderer's step 3 exactly."""
    _, t = _pair(scenes)
    t.step()
    t.step()
    path = str(tmp_path / "state.npz")
    t.save_state(path)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "frame", "seed", "total_samples"]
        assert int(z["frame"]) == 2 and int(z["seed"]) == KW["seed"]
    t.step()
    _, r = _pair(scenes)
    r.load_state(path)
    assert (r.frame, r.total_samples) == (2, 4)
    assert r.accum.device == torch.device("cpu")
    r.step()
    assert torch.equal(r.accum, t.accum)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_state_moves_between_packages(scenes, tmp_path, saver):
    """A state saved by either package loads into the other; both go on
    to the same next step."""
    j, t = _pair(scenes)
    path = str(tmp_path / "state.npz")
    src, dst = (j, t) if saver == "jax" else (t, j)
    _step(j, t)
    _step(j, t)
    src.save_state(path)
    dst.load_state(path)
    assert (dst.frame, dst.total_samples) == (2, 4)
    np.testing.assert_array_equal(np.asarray(dst.accum),
                                  np.asarray(src.accum))
    _step(j, t)
    _match(t, j)


def test_seed_mismatch_raises(scenes, tmp_path):
    j, t = _pair(scenes)
    path = str(tmp_path / "state.npz")
    t.step()
    t.save_state(path)
    j2, t2 = _pair(scenes, seed=8)
    with pytest.raises(ValueError, match="seed"):
        t2.load_state(path)
    with pytest.raises(AssertionError, match="seed"):
        j2.load_state(path)  # the JAX class raises too
    _, small = _pair(scenes, width=9)
    with pytest.raises(ValueError, match="image"):
        small.load_state(path)
