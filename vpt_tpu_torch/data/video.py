"""Video IO through the native host data plane (counterpart of
vpt_tpu/data/video.py), with the port's own ctypes binding.

The library is the port's own C++ source ``vpt_tpu_torch/csrc/vpt_host.cpp``
(a copy of the JAX package's host library: libavformat / libavcodec decode
and encode, the cv2-exact fixed-point resize and cursor compositing, behind
a plain C interface).  At first use it is compiled with ``g++`` against the
libav libraries that ``pkg-config`` finds, into
``vpt_tpu_torch/build/libvpt_host-<digest>.so``; nothing is written beside
the source.  Where libav or a compiler is missing the video classes raise:
there is no other decoder to fall back to.  ``native_composite_alpha`` takes
the numpy composite (data/cursor.py) instead, byte for byte the same.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "vpt_host.cpp"
BUILD = PACKAGE / "build"
LIBAV = ("libavcodec", "libavformat", "libavutil", "libswscale")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def _libav_flags() -> list:
    try:
        res = subprocess.run(["pkg-config", "--cflags", "--libs", *LIBAV],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        raise RuntimeError("the native video library needs pkg-config and libav (not found)") from None
    if res.returncode != 0:
        raise RuntimeError(f"the native video library needs libav, which pkg-config cannot find: "
                           f"{res.stderr.strip()}")
    return res.stdout.split()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"libvpt_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native library unless its current build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), *_libav_flags(), "-lm"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError:
        os.unlink(tmp)
        raise RuntimeError("the native video library needs g++ (not found)") from None
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native video library failed:\n{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent build processes each write their own temp file
    return out


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    ptr, i32, u8p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)
    lib.vpt_video_open.restype = ptr
    lib.vpt_video_open.argtypes = [ctypes.c_char_p]
    lib.vpt_video_info.restype = i32
    lib.vpt_video_info.argtypes = [ptr, ctypes.POINTER(i32), ctypes.POINTER(i32),
                                   ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.vpt_video_read.restype = i32
    lib.vpt_video_read.argtypes = [ptr, u8p]
    lib.vpt_video_close.restype = None
    lib.vpt_video_close.argtypes = [ptr]
    # handle, n, emit mask, cursor xy, cursor rgb, cursor alpha, cursor h, w, dst h, w, out
    lib.vpt_video_read_batch.restype = i32
    lib.vpt_video_read_batch.argtypes = [ptr, i32, u8p, ctypes.POINTER(ctypes.c_int32), u8p, u8p,
                                         i32, i32, i32, i32, u8p]
    lib.vpt_video_writer_open.restype = ptr
    lib.vpt_video_writer_open.argtypes = [ctypes.c_char_p, i32, i32, i32]
    lib.vpt_video_writer_write.restype = i32
    lib.vpt_video_writer_write.argtypes = [ptr, u8p]
    lib.vpt_video_writer_close.restype = i32
    lib.vpt_video_writer_close.argtypes = [ptr]
    # image, h, w, sprite rgb, sprite alpha, sprite h, w, x, y
    lib.vpt_composite_alpha.restype = None
    lib.vpt_composite_alpha.argtypes = [u8p, i32, i32, u8p, u8p, i32, i32, i32, i32]
    _lib = lib
    return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def native_composite_alpha(img: np.ndarray, overlay_rgb: np.ndarray, overlay_alpha: np.ndarray,
                           x: int, y: int) -> None:
    """Composite the cursor sprite (rgb (h, w, 3), alpha (h, w) uint8) onto
    the (H, W, 3) uint8 ``img`` at (x, y), in place, in the native library;
    where it cannot load, ``composite_images_with_alpha`` (data/cursor.py)
    does it with the same bytes."""
    try:
        lib = _load_library()
    except (RuntimeError, OSError):
        from vpt_tpu_torch.data.cursor import composite_images_with_alpha

        composite_images_with_alpha(img, overlay_rgb, overlay_alpha[..., None] / 255.0, x, y)
        return
    img_c = np.ascontiguousarray(img)
    lib.vpt_composite_alpha(
        _u8ptr(img_c), img.shape[0], img.shape[1],
        _u8ptr(np.ascontiguousarray(overlay_rgb)), _u8ptr(np.ascontiguousarray(overlay_alpha)),
        overlay_rgb.shape[0], overlay_rgb.shape[1], x, y,
    )
    img[...] = img_c


class VideoReader:
    """Sequential RGB frame reader for mp4/mkv files."""

    CURSOR_NONE = np.int32(np.iinfo(np.int32).min)  # "no cursor" sentinel of read_batch

    def __init__(self, path: str):
        self._lib = _load_library()
        self._h = self._lib.vpt_video_open(path.encode())
        if not self._h:
            raise IOError(f"could not open video {path}")
        w, h, fps, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_double(), ctypes.c_int64()
        self._lib.vpt_video_info(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps), ctypes.byref(n))
        self.width, self.height, self.fps, self.nframes = w.value, h.value, fps.value, n.value

    def read(self) -> Optional[np.ndarray]:
        """Next frame as (H, W, 3) RGB uint8, or None at the end."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        ret = self._lib.vpt_video_read(self._h, _u8ptr(out))
        if ret == 1:
            return out
        if ret == 0:
            return None
        raise IOError("video decode error")

    def read_batch(
        self,
        n: int,
        resolution: Tuple[int, int],
        emit: Optional[np.ndarray] = None,
        cursor_xy: Optional[np.ndarray] = None,
        cursor: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[int, np.ndarray]:
        """Decode up to ``n`` frames, composite the cursor and resize them
        (cv2-exact) in one native call.

        :param resolution: (width, height) to resize to
        :param emit: (n,) bool; False frames are decoded (keeping video and
            jsonl in step) but not composited or resized, their slots undefined
        :param cursor_xy: (n, 2) int32 mouse positions, ``CURSOR_NONE`` in x
            for frames without a cursor
        :param cursor: (rgb (h, w, 3), alpha (h, w)) sprite, needed with cursor_xy
        :returns: (frames decoded, (n, H, W, 3) uint8); fewer than n means the end
        """
        dst_w, dst_h = resolution
        out = np.empty((n, dst_h, dst_w, 3), np.uint8)
        emit_p = xy_p = crgb_p = calpha_p = None
        ch = cw = 0
        if emit is not None:
            emit = np.ascontiguousarray(np.asarray(emit, np.uint8))
            if emit.shape != (n,):
                raise ValueError(f"emit must be ({n},), got {emit.shape}")
            emit_p = _u8ptr(emit)
        if cursor_xy is not None:
            cursor_xy = np.ascontiguousarray(np.asarray(cursor_xy, np.int32))
            if cursor_xy.shape != (n, 2) or cursor is None:
                raise ValueError(f"cursor_xy must be ({n}, 2) and come with a cursor sprite")
            xy_p = cursor_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            crgb, calpha = np.ascontiguousarray(cursor[0]), np.ascontiguousarray(cursor[1])
            ch, cw = calpha.shape
            crgb_p, calpha_p = _u8ptr(crgb), _u8ptr(calpha)
        got = self._lib.vpt_video_read_batch(self._h, n, emit_p, xy_p, crgb_p, calpha_p, ch, cw,
                                             dst_h, dst_w, _u8ptr(out))
        if got < 0:
            raise IOError("video decode error")
        return got, out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vpt_video_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class VideoWriter:
    """RGB frame writer (h264 where available, else mpeg4) for test fixtures."""

    def __init__(self, path: str, width: int, height: int, fps: int = 20):
        self._lib = _load_library()
        self._h = self._lib.vpt_video_writer_open(path.encode(), width, height, fps)
        if not self._h:
            raise IOError(f"could not open video writer {path}")
        self.width, self.height = width, height

    def write(self, frame_rgb: np.ndarray):
        if frame_rgb.shape != (self.height, self.width, 3) or frame_rgb.dtype != np.uint8:
            raise ValueError(f"frame must be uint8 {(self.height, self.width, 3)}, "
                             f"got {frame_rgb.dtype} {frame_rgb.shape}")
        frame_rgb = np.ascontiguousarray(frame_rgb)
        if self._lib.vpt_video_writer_write(self._h, _u8ptr(frame_rgb)) != 0:
            raise IOError("video encode error")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vpt_video_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
