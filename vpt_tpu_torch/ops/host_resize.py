"""The native cv2-exact host resize (csrc/host_resize.cpp) through ctypes.

The library needs only a C++ compiler: at first use ``g++`` compiles it into
``vpt_tpu_torch/build/libvpt_resize-<digest>.so`` (the digest covers the
source and the flags), each process through its own temp file that is then
renamed into place, so concurrent first uses never load a half-written file.
A ctypes call releases the GIL, so threads resize frames in parallel.

Where the library cannot be built or loaded, ``native_resize_u8`` falls back
to the numpy ``resize_uint8_exact`` (bit-equal), as the JAX package's does;
``backend()`` says which of the two runs, so the fallback is never silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vpt_tpu_torch.ops.resize import resize_uint8_exact

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "host_resize.cpp"
BUILD = PACKAGE / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library is not in use, once a load failed
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"libvpt_resize-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless its current build exists; raises on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
            else:
                u8p, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
                lib.vpt_resize_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32]
                lib.vpt_resize_u8.restype = None
                _lib = lib
    return _lib


def backend() -> str:
    """"native" where the C++ library runs the resize, else "numpy"."""
    return "native" if _load() is not None else "numpy"


def load_error() -> Optional[str]:
    """Why the native library is not in use (None where it is)."""
    _load()
    return _error


def native_resize_u8(img: np.ndarray, target_resolution: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of an (H, W) or
    (H, W, C) uint8 image, bit-equal to ``resize_uint8_exact``; in the
    native library where it loads, else that numpy version."""
    lib = _load()
    if lib is None:
        return resize_uint8_exact(img, target_resolution)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"native_resize_u8 takes (H, W) or (H, W, C) uint8 images, got {img.dtype} {img.shape}")
    dst_w, dst_h = target_resolution
    if dst_w < 1 or dst_h < 1:
        raise ValueError(f"target_resolution must be positive (w, h), got {target_resolution}")
    img = np.ascontiguousarray(img)
    ch = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((dst_h, dst_w) + img.shape[2:], np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vpt_resize_u8(img.ctypes.data_as(u8p), img.shape[0], img.shape[1], ch, out.ctypes.data_as(u8p),
                      dst_h, dst_w)
    return out
