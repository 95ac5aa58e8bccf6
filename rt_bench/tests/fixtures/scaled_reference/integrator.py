"""The benchmark's reference image, scaled by :data:`SCALE`."""

from rt_bench.reference import integrator

SCALE = 1.01


def render_pixels(rs, cfg, cam, pix, n_frames, colour=None):
    return integrator.render_pixels(rs, cfg, cam, pix, n_frames,
                                    colour) * SCALE
