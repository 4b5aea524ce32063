"""Mouse-cursor sprite for GUI frames and its alpha composite (counterpart
of vpt_tpu/data/cursor.py; the loader's native library composites it,
data/video.py, and ``composite_images_with_alpha`` is the numpy version).

The reference composites a 16×16 RGBA cursor PNG onto frames whenever the
GUI is open (reference data_loader.py:19, 52-56, 113-117): the recorder does
not bake the cursor into the video, but the model was trained seeing it.
The published asset is not in the repo; the classic white arrow with a black
border is drawn procedurally unless a PNG is found (the ``CURSOR_FILE``
variable, or ``cursors/mouse_cursor_white_16x16.png`` at the repo root).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# 16×16 arrow: '#' black border, 'W' white fill, '.' transparent
_ARROW = [
    "#...............",
    "##..............",
    "#W#.............",
    "#WW#............",
    "#WWW#...........",
    "#WWWW#..........",
    "#WWWWW#.........",
    "#WWWWWW#........",
    "#WWWWWWW#.......",
    "#WWWWWWWW#......",
    "#WWWWW#####.....",
    "#WW#WW#.........",
    "#W#.#WW#........",
    "##..#WW#........",
    "#....#WW#.......",
    ".....####.......",
]


def _procedural_cursor() -> Tuple[np.ndarray, np.ndarray]:
    rgb = np.zeros((16, 16, 3), np.uint8)
    alpha = np.zeros((16, 16), np.uint8)
    for y, row in enumerate(_ARROW):
        for x, c in enumerate(row[:16]):
            if c == "#":
                rgb[y, x] = 0
                alpha[y, x] = 255
            elif c == "W":
                rgb[y, x] = 255
                alpha[y, x] = 255
    return rgb, alpha


def load_cursor_png(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a 16×16 RGBA cursor PNG (e.g. the reference's asset) via PIL."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGBA"))[:16, :16]
    return img[:, :, :3].copy(), img[:, :, 3].copy()


def default_cursor() -> Tuple[np.ndarray, np.ndarray]:
    """(rgb (16, 16, 3), alpha (16, 16)) from the first PNG found, else the
    procedural arrow."""
    repo_root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    candidates = [os.environ.get("CURSOR_FILE"), os.path.join(repo_root, "cursors", "mouse_cursor_white_16x16.png")]
    for path in candidates:
        if path and os.path.exists(path):
            return load_cursor_png(path)
    return _procedural_cursor()


def composite_images_with_alpha(image1: np.ndarray, image2: np.ndarray, alpha: np.ndarray, x: int, y: int) -> None:
    """Draw image2 over image1 at (x, y) with opacity ``alpha``, in place
    (reference: data_loader.py:34-45).  ``alpha`` is float in [0, 1] with a
    trailing channel axis; the blend truncates to uint8 as the reference's
    ``astype`` does."""
    ch = max(0, min(image1.shape[0] - y, image2.shape[0]))
    cw = max(0, min(image1.shape[1] - x, image2.shape[1]))
    if ch == 0 or cw == 0:
        return
    a = alpha[:ch, :cw]
    image1[y:y + ch, x:x + cw, :] = (image1[y:y + ch, x:x + cw, :] * (1 - a) + image2[:ch, :cw, :] * a).astype(np.uint8)
