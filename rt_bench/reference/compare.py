"""The comparison that decides ``correct``: the program's accumulated image
against the plain reference's, at the same sampled pixels.

``rel_l1``: the sum over the sampled pixels and channels of the absolute
difference, over the sum of the reference's absolute values.  A pixel that
is not finite in either image makes it infinite.  Its limit for each cell
is in ``rt_bench/limits/<cell>.json``, set between the readings of sound
runs and of the control (``PERF.md`` gives both).
"""

from __future__ import annotations

import json
import os

import torch


def numbers(program, reference) -> dict:
    program = program.double()
    reference = reference.double()
    if not (torch.isfinite(program).all() and torch.isfinite(reference).all()):
        return {"rel_l1": float("inf")}
    den = float(reference.abs().sum())
    num = float((program - reference).abs().sum())
    return {"rel_l1": num / den if den > 0 else float("inf")}


def limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, "rt_bench", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def judge(found: dict, limit: dict):
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit."""
    rows = [(k, found[k], limit[k]) for k in sorted(limit)]
    return all(v <= lim for _, v, lim in rows), rows
