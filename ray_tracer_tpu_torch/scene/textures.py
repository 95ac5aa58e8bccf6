"""Texture loading: image files -> one padded uint8 sRGB stack.

Replaces the reference's stb_image -> VkImage path
(``src/vk_textures.cpp:8-293``).  All textures are stacked into a single
``(K, Hmax, Wmax, 3)`` array, so a texture fetch is one gather instead of
64 separate bindings; the integrator linearizes each sample as the
reference's ``VK_FORMAT_R8G8B8A8_SRGB`` views do in hardware
(``vk_engine.cpp:1158``).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to (H,W,3) uint8 sRGB: with Pillow where it is installed,
    else PNG files only (:func:`decode_png`)."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            return decode_png(f.read())
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced 8-bit gray, gray+alpha, RGB or RGBA PNG ->
    (H,W,3) uint8 RGB (alpha dropped).  Raises ``ValueError`` on any
    other PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG of depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} is not decoded here")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 2:
            row = row + prev
        elif f in (1, 3, 4):  # these read the pixel to the left
            cur = np.zeros(w * c + c, np.int32)
            up = np.concatenate([np.zeros(c, np.int32), prev])
            for x in range(w * c):
                a, b, ul = cur[x], up[x + c], up[x]
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - ul), abs(a - ul), abs(a + b - 2 * ul)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else ul)
                cur[x + c] = (row[x] + pred) & 255
            row = cur[c:]
        elif f != 0:
            raise ValueError(f"PNG row filter {f}")
        out[y] = prev = row & 255
    img = out.astype(np.uint8).reshape(h, w, c)
    if c < 3:
        img = np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def stack_textures(paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Load + zero-pad to a common (K,Hmax,Wmax,3) uint8 sRGB stack.

    Stored as uint8 (the reference's VK_FORMAT_R8G8B8A8_SRGB images are 8-bit
    too); linearization happens per sample in the shader, exactly like the
    reference's SRGB-view hardware decode.  A float32 stack would cost 4x
    the device memory, and Sponza-class texture sets run to hundreds of MB.
    """
    if not paths:
        return (
            np.zeros((1, 1, 1, 3), np.uint8),
            np.ones((1, 2), np.int32),
        )
    images: List[np.ndarray] = []
    for p in paths:
        try:
            images.append(load_image_rgb(p))
        except Exception:
            # Missing texture: magenta 1x1, mirroring the reference's loud
            # failure (vk_textures.cpp:114) without aborting the build.
            images.append(np.array([[[255, 0, 255]]], np.uint8))
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    stack = np.zeros((len(images), hmax, wmax, 3), np.uint8)
    sizes = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        stack[i, : im.shape[0], : im.shape[1]] = im
        sizes[i] = (im.shape[0], im.shape[1])
    return stack, sizes
