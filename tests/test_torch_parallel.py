"""Sharded rendering over ``torch.distributed`` (``parallel/mesh.py``),
on the CPU: four gloo ranks, spawned with a file store under the test's
temporary directory and one torch thread each, render the room scene on
the (4, 1), (2, 2) and (1, 4) meshes in one spawn.

Against the single-process ``render_frame``: the data axis splits the
pixels only, so its image is equal bit for bit; the sample axis averages
slices of the samples, so its image is within atol 1e-5.  Against the
JAX package's ``render_frame_sharded`` on the same mesh shape (over the
virtual CPU devices of ``tests/conftest.py``): the image tolerance of
``torch_parity.assert_images_match``.  Each spawn has its own timeout,
after which its processes are killed, so a hung rendezvous fails one test
and does not hold up the run.
"""

import os
import time

import numpy as np
import pytest

import jax

import ray_tracer_tpu as jrt
from ray_tracer_tpu.parallel import mesh as j_mesh
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch.parallel import entry

from torch_parity import (
    SHARD_MESHES,
    assert_images_match,
    room_scene,
    sharded_room_rank,
)

# 437 pixels: the data axis pads them to a multiple of 4 with pixel 0
FRAME = dict(width=23, height=19, samples_per_pixel=4, bounce_limit=3)
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The images of the four-rank spawn, by mesh shape."""
    out = str(tmp_path_factory.mktemp("sharded"))
    entry.spawn(sharded_room_rank, 4,
                (os.path.join(out, "store"), out, FRAME), TIMEOUT)
    imgs = {m: np.load(os.path.join(out, f"mesh_{m[0]}x{m[1]}.npy"))
            for m in SHARD_MESHES}
    return imgs, os.path.exists(os.path.join(out, "bad_mesh_raised.npy"))


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("room"))
    return (room_scene(jrt, tmp).compile(),
            room_scene(trt, tmp).compile(device="cpu"))


@pytest.mark.parametrize("shape", SHARD_MESHES)
def test_sharded_matches_single_process(sharded, room, shape):
    imgs, _ = sharded
    want = trt.render_frame(room[1], trt.RenderConfig(**FRAME)).numpy()
    got = imgs[shape]
    assert got.shape == (19, 23, 3) and got.mean() > 0.05
    if shape[1] == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", SHARD_MESHES)
def test_sharded_matches_jax_sharded(sharded, room, shape):
    imgs, _ = sharded
    n_data, n_sample = shape
    m = j_mesh.make_mesh(n_data=n_data, n_sample=n_sample,
                         devices=jax.devices()[:4])
    want = np.asarray(j_mesh.render_frame_sharded(
        room[0], jrt.RenderConfig(**FRAME), m))
    assert_images_match(imgs[shape], want)


def test_mesh_must_use_the_world(sharded):
    assert sharded[1]


def _sleeper(rank, n, seconds):
    time.sleep(seconds)


def _failer(rank, n):
    if rank == 1:
        raise SystemExit(3)


def test_spawn_kills_ranks_past_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish"):
        entry.spawn(_sleeper, 2, (600,), timeout=3.0)
    assert time.monotonic() - t0 < 60


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match=r"\(1, 3\)"):
        entry.spawn(_failer, 2, (), timeout=60.0)
