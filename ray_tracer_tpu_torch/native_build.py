"""Build-at-first-use for the port's native sources.

Every shared library (the C++ scene compiler helpers and the CUDA kernels)
is compiled from the checkout's own sources into
``<checkout>/build/ray_tracer_tpu_torch/``, keyed by a hash of the source
text, of the local headers it includes and of the compiler command, so an
edited source, header or flag rebuilds and a warm checkout reuses the
library.  A failed build raises with the
compiler's output: the port never falls back to another implementation
because a toolchain is missing.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from typing import Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build",
    "ray_tracer_tpu_torch",
)

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

GXX = ("g++", "-O3", "-march=native", "-shared", "-fPIC")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _source_text(path: str, seen: set = None) -> bytes:
    """The text of ``path`` followed by that of every file it includes
    with ``#include "..."``, recursively, each once."""
    seen = set() if seen is None else seen
    path = os.path.realpath(path)
    if path in seen:
        return b""
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    for name in _LOCAL_INCLUDE.findall(text):
        text += _source_text(
            os.path.join(os.path.dirname(path), name.decode()), seen)
    return text


def build_shared(src: str, stem: str, command: Sequence[str]) -> str:
    """Compile ``src`` with ``command`` into a shared library; return its path.

    The compiler's messages (``-Xptxas -v`` register reports included) are
    kept beside the library as ``<name>.log``.
    """
    key = _source_text(src) + "\0".join(command).encode()
    tag = hashlib.sha256(key).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{stem}_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    proc = subprocess.run(
        [*command, src, "-o", tmp], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {stem} failed ({' '.join(command)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(so_path[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so_path)
    return so_path
