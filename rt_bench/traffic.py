"""The general traffic generator: a mix's data file -> the frame, the
render settings and the camera of every step of the window.

A mix (``rt_bench/traffic/<name>.json``) states the frame (``width``,
``height``), the samples a step (``spp``), the ``bounce_limit``, and its
camera:
- ``"camera": "preset"``: the configuration's own camera, never moved, so
  accumulation is never reset;
- ``"camera": "views"``: the camera moves every ``move_every`` steps, and
  each move restarts accumulation.  ``views`` draws a fixed set of
  ``count`` views from its own ``seed``, over the courtyard that the
  scene's layout (``SceneSpec.meta``) describes: the position uniform
  along the long axis within ``along`` of the half-length, across it
  between the inner colonnade rows less ``margin``, at the eye height;
  the yaw uniform over ``yaw_deg``; the pitch uniform over
  ``pitch_up_deg`` upwards (y points down, so an upward pitch is a
  negative angle).  The run's ``--seed`` only orders the set, so every
  seed does the same work in another order.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "rt_bench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def view_set(mix: dict, layout: dict, camera: dict) -> list:
    """The mix's fixed set of camera views (dicts of the scene camera's
    keys)."""
    v = mix["views"]
    rng = np.random.default_rng(v["seed"])
    out = []
    for _ in range(v["count"]):
        z = rng.uniform(-1.0, 1.0) * v["along"] * layout["half_length"]
        half_x = layout["inner_row_x"] - v["margin"]
        x = rng.uniform(-half_x, half_x)
        yaw = rng.uniform(*v["yaw_deg"])
        pitch = -rng.uniform(*v["pitch_up_deg"])
        out.append({**camera, "position": (float(x), layout["eye_height"],
                                           float(z)),
                    "angles_deg": (float(pitch), float(yaw), 0.0)})
    return out


def camera_plan(mix: dict, layout: dict, camera: dict, seed: int):
    """``(move_every, views)``: the views in this seed's order, taken in
    turn every ``move_every`` steps from the window's first step; ``(0,
    [])`` for a fixed camera."""
    if mix["camera"] == "preset":
        return 0, []
    views = view_set(mix, layout, camera)
    order = np.random.default_rng([seed % 2**63, 0x0B17]).permutation(
        len(views))
    return int(mix["move_every"]), [views[i] for i in order]
