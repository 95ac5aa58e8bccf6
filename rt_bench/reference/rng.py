"""Counter-based random numbers: the pcg4d hash of Jarzynski and Olano,
"Hash Functions for GPU Rendering" (JCGT 2020), as the path tracer under
test draws them.

Every draw is a pure function of ``(seed, pixel, frame, sample, bounce,
draw)``, so a sample's path does not depend on which lane, tile or batch
traced it.  The 32-bit words live in int64 tensors masked to 32 bits, and
products are split at 16 bits so that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
INV_U32 = 1.0 / 4294967296.0


def mul32(a, b):
    """(a * b) mod 2**32 for int64 tensors holding 32-bit words."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(a, b, c, d):
    v = [(x * 1664525 + 1013904223) & MASK for x in (a, b, c, d)]
    for _ in range(2):
        v[0] = (v[0] + mul32(v[1], v[3])) & MASK
        v[1] = (v[1] + mul32(v[2], v[0])) & MASK
        v[2] = (v[2] + mul32(v[0], v[1])) & MASK
        v[3] = (v[3] + mul32(v[1], v[2])) & MASK
        if _ == 0:
            v = [x ^ (x >> 16) for x in v]
    return v


def uniforms(seed, pixel, frame, sample, bounce, n_draws: int):
    """(N,) pixel ids (and ``frame``, ``sample``, ``bounce`` as ints or
    (N,) tensors) -> (N, n_draws) float32 uniforms in [0, 1)."""
    dev = pixel.device
    u32 = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev) & MASK
    a = u32(pixel)
    b = (u32(seed) ^ mul32(u32(frame), u32(0x9E3779B9))).expand_as(a)
    c = ((mul32(u32(sample), u32(0x85EBCA6B)) + u32(bounce)) & MASK)
    c = c.expand_as(a)
    out = []
    for blk in range((n_draws + 3) // 4):
        out.extend(pcg4d(a, b, c, torch.full_like(a, blk)))
    bits = torch.stack(out[:n_draws], dim=-1)
    return bits.to(torch.float32) * INV_U32
