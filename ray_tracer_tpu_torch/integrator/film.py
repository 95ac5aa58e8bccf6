"""Film: float32 accumulation, progressive blending, display transform.

The accumulator is float32 and quantization happens only at export; the
progressive blend weight is ``1/(frame+1)`` (a running mean over frames).
NaN/Inf pixels are painted magenta like the reference's canary
(``raytrace.comp:579-581``).  PNGs are written with the standard library
(``zlib``, ``struct``) alone.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

MAGENTA = (1.0, 0.0, 1.0)


def progressive_blend(accum, frame_color, frame_index: int):
    """accum' = accum*(1-w) + color*w with w = 1/(frame+1), in float32."""
    w = torch.tensor(1.0, dtype=torch.float32) / (float(frame_index) + 1.0)
    return accum * (1.0 - w) + frame_color * w


def finalize(color):
    """NaN/Inf canary (magenta) + clamp to [0,1] (rgba8 store semantics)."""
    bad = torch.any(~torch.isfinite(color), dim=-1, keepdim=True)
    color = torch.where(bad, color.new_tensor(MAGENTA), color)
    return torch.clamp(color, 0.0, 1.0)


def linear_to_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308, x * 12.92, 1.055 * x ** (1.0 / 2.4) - 0.055
    )


def to_uint8_srgb(color) -> np.ndarray:
    """(H,W,3) linear float -> uint8 sRGB (round half to even, as
    ``jnp.round``)."""
    srgb = linear_to_srgb(finalize(color))
    return torch.round(srgb * 255.0).to(torch.uint8).cpu().numpy()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(color, level: int = 6) -> bytes:
    """(H,W,3) linear float -> the bytes of an 8-bit RGB PNG of
    :func:`to_uint8_srgb`, deflated at zlib ``level``."""
    return encode_png_uint8(to_uint8_srgb(color), level)


def encode_png_uint8(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H,W,3) uint8 -> the bytes of an 8-bit RGB PNG (every row filter 0,
    one IDAT chunk deflated at zlib ``level``; 6 is Pillow's default)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, color) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(color))
