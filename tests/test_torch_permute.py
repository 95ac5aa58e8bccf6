"""The round's packed lane row and the plain versions of the state permute
and the NEE resolve, on the CPU.

A lane's state travels between the shade kernel and the permute as one
40-word row (``integrator/shading.py::pack_lanes``): 34 f32 words, then
six i32 words stored as their bits.  Here: packing and unpacking keep
every bit (NaN payloads, -0.0, negative integers); ``permute_rows`` on CPU
tensors gathers each field by the order, and so does the torch round's own
gather of the two arrays of words; the NEE resolve's output on a
lane does not depend on the values its flags say it does not need, which
is what lets ``nee_resolve_kernel`` skip their loads; and the packed
round's plain resolve equals the JAX package's on those lanes.  The
kernels themselves are held against these plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_tpu.integrator import wavefront as j_wavefront
from ray_tracer_tpu_torch.integrator import shading, wavefront
from ray_tracer_tpu_torch.kernels import shade
from ray_tracer_tpu_torch.scene import presets

from torch_parity import (random_lanes, random_rows, same_bits, sorted_keys,
                          with_lights)

SIZES = (1, 31, 257, 4096)
BOOL_WORDS = (27, 28, 29, 30, 33)  # alive, bad, fresh_direct, is_diff,
# nee_active


def orders(n, seed=0):
    rand = np.random.default_rng(seed)
    return {"identity": torch.arange(n),
            "reversed": torch.arange(n - 1, -1, -1),
            "random": torch.from_numpy(rand.permutation(n))}


@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_keeps_every_bit(n):
    """Lanes packed into rows and unpacked again equal the lanes bit for
    bit, NaN payloads, infinities, -0.0 and negative integers included;
    the i32 words sit after the f32 words as their own bits."""
    lanes = random_lanes(n, seed=n)
    packed = shading.pack_lanes(lanes)
    assert packed.shape == (n, shading.ROW) == (n, 40)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    for name, a, b in zip(shading.Lanes._fields, shading.unpack_lanes(packed),
                          lanes):
        assert same_bits(a, b), name
    ints = torch.stack(list(lanes[-shading.PACKED_I:]), 1)
    assert torch.equal(packed[:, shading.PACKED_F:].view(torch.int32), ints)


@pytest.mark.parametrize("n", SIZES)
def test_unpack_pack_keeps_every_word(n):
    """Rows of random bits unpacked and packed again keep every word but
    the five flags, which become 0.0 or 1.0 by ``> 0.5``."""
    rows = random_rows(n, seed=n)
    back = shading.pack_lanes(shading.unpack_lanes(rows))
    words = [k for k in range(shading.ROW) if k not in BOOL_WORDS]
    assert same_bits(back[:, words], rows[:, words])
    assert same_bits(back[:, list(BOOL_WORDS)],
                     (rows[:, list(BOOL_WORDS)] > 0.5).float())


@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
@pytest.mark.parametrize("n", SIZES)
def test_permute_rows_gathers_each_field(n, kind):
    """``permute_rows`` on CPU tensors (the plain version) is each lane
    field gathered by the order, bit for bit, and adds the sorted keys'
    runs among the live lanes to the word it is given."""
    lanes = random_lanes(n, seed=n + 1)
    order = orders(n, seed=n)[kind]
    skey = sorted_keys(n, seed=n)
    runs = torch.full((1,), 5, dtype=torch.int64)
    got = shade.permute_rows(shading.pack_lanes(lanes), order, skey, runs)
    for name, a, b in zip(shading.Lanes._fields, got, lanes):
        assert same_bits(a, b[order]), name
    live = skey[skey != shading.DEAD_KEY]
    assert int(runs) == 5 + live.unique().numel()


@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
@pytest.mark.parametrize("n", SIZES)
def test_torch_round_gather_equals_the_rows(n, kind):
    """The torch round's gather (``wavefront._gather_lanes``: the f32 and
    i32 words as two arrays, ``shading.pack_split``) gives the lanes that
    the 40-word rows' plain permute gives, bit for bit."""
    lanes = random_lanes(n, seed=n + 2)
    order = orders(n, seed=n + 1)[kind]
    got = wavefront._gather_lanes(lanes, order)
    want = shade.permute_rows_reference(shading.pack_lanes(lanes), order,
                                        sorted_keys(n, seed=n),
                                        torch.zeros(1, dtype=torch.int64))
    for name, a, b in zip(shading.Lanes._fields, got, want):
        assert same_bits(a, b), name


@pytest.fixture(scope="module")
def spheres():
    return presets.sphere_diffuse().compile(device="cpu")


def poisoned(lanes, occluded, n_lights):
    """``lanes`` and ``occluded`` with every value the NEE resolve's
    flags say a lane does not need replaced: direct_base where
    fresh_direct, is_diff where not fresh_direct, the light sample, its
    flags and the occlusion where the lane is not a fresh diffuse one,
    the occlusion where its shadow ray was not traced, and the direction,
    distance and cos_pdf_at_l where it did not reach the light."""
    nan = torch.tensor(float("nan"))
    fresh = lanes.fresh_direct
    diff = fresh & lanes.is_diff
    traced = diff & lanes.nee_active
    reached = traced & ~occluded if occluded is not None else traced
    v = lambda keep, x: torch.where(keep[:, None], x, nan)
    s = lambda keep, x: torch.where(keep, x, nan)
    last = max(n_lights, 1) - 1
    lanes = lanes._replace(
        direct_base=v(~fresh, lanes.direct_base),
        is_diff=torch.where(fresh, lanes.is_diff, ~lanes.is_diff),
        l_dir=v(reached, lanes.l_dir), l_dist=s(reached, lanes.l_dist),
        cos_pdf_at_l=s(reached, lanes.cos_pdf_at_l),
        nee_k=v(diff, lanes.nee_k),
        nee_active=torch.where(diff, lanes.nee_active, ~lanes.nee_active),
        li=torch.where(diff, lanes.li, last - lanes.li))
    if occluded is not None:
        occluded = torch.where(traced, occluded, ~occluded)
    return lanes, occluded


@pytest.mark.parametrize("fresh", ["all", "none", "mixed"])
@pytest.mark.parametrize("n_lights", [0, 1, 2])
def test_nee_resolve_reads_only_what_a_lane_needs(spheres, n_lights, fresh):
    """The plain NEE resolve gives every lane the same bits when the
    values its flags say it does not need are replaced (by NaN, flipped
    flags, another light), with 0, 1 and 2 rect lights: the loads that
    nee_resolve_kernel skips cannot reach its output."""
    sc = with_lights(spheres, n_lights)
    n = 2048
    lanes = random_lanes(n, n_lights, fresh, seed=7 * n_lights + len(fresh))
    rand = np.random.default_rng(n_lights)
    occluded = None if n_lights == 0 else torch.from_numpy(
        rand.uniform(size=n) < 0.4)
    want = shade.nee_resolve(sc, lanes, occluded)
    got = shade.nee_resolve(sc, *poisoned(lanes, occluded, n_lights))
    assert same_bits(got, want)
    if fresh == "none":
        assert same_bits(want, lanes.direct_base)
    else:
        assert bool(torch.isfinite(want[lanes.fresh_direct]).any())


@pytest.mark.parametrize("n_lights", [1.0, 2.0])
def test_packed_resolve_matches_jax(n_lights):
    """The resolve on lanes that went through the packed row (its plain
    version, ``shading.resolve_direct``, on the unpacked columns) against
    the JAX package's on the same values.  XLA on the CPU flushes
    subnormal inputs to zero, so they are flushed here first, on both
    sides."""
    lanes = shading.unpack_lanes(shading.pack_lanes(
        random_lanes(4096, 2, "mixed", seed=5)))
    rand = np.random.default_rng(5)
    pdf = torch.from_numpy(rand.normal(size=4096).astype(np.float32))
    l_emit = torch.from_numpy(rand.uniform(0, 4, (4096, 3)).astype(np.float32))
    ftz = lambda t: torch.where(t.abs() < torch.finfo(t.dtype).tiny, 0 * t, t)
    args = (pdf, n_lights, ftz(lanes.cos_pdf_at_l), l_emit, ftz(lanes.nee_k),
            lanes.is_diff, lanes.fresh_direct, ftz(lanes.direct_base))
    got = shading.resolve_direct(*args)
    want = j_wavefront._resolve_direct(*(
        jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
        for a in args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
