"""Plain reference of the action spaces (openai/Video-Pre-Training
lib/actions.py, lib/action_mapping.py): the 20 factored buttons, the
hierarchical joint space the policy samples from (8641 button
combinations, 121 camera bins gated by a camera meta button) and the
mu-law camera quantizer, as lookup tables built from their definitions.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

BUTTONS = ["attack", "back", "forward", "jump", "left", "right", "sneak", "sprint", "use", "drop",
           "inventory"] + [f"hotbar.{i}" for i in range(1, 10)]
GROUPS = [
    ["none"] + [f"hotbar.{i}" for i in range(1, 10)],
    ["none", "forward", "back"],
    ["none", "left", "right"],
    ["none", "sprint", "sneak"],
    ["none", "use"],
    ["none", "drop"],
    ["none", "attack"],
    ["none", "jump"],
    ["none", "camera"],  # the camera meta button: "none" means the camera does not move
]
N_BINS = 11
NULL_BIN = N_BINS // 2
CAMERA_MAXVAL, CAMERA_BINSIZE, CAMERA_MU = 10, 2, 10.0


def camera_degrees(bins: np.ndarray) -> np.ndarray:
    """Camera bins → degrees: the inverse of the linear binning, then the
    mu-law expansion."""
    xy = np.asarray(bins, np.float64) * CAMERA_BINSIZE - CAMERA_MAXVAL
    v = xy / CAMERA_MAXVAL
    return np.sign(v) * (1.0 / CAMERA_MU) * ((1.0 + CAMERA_MU) ** np.abs(v) - 1.0) * CAMERA_MAXVAL


def camera_bins(degrees: np.ndarray) -> np.ndarray:
    """Degrees → the nearest camera bin."""
    table = camera_degrees(np.arange(N_BINS))
    return np.abs(np.asarray(degrees, np.float64)[..., None] - table).argmin(-1)


def joint_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(8641, 20) pressed buttons of each joint button index, and (8641,)
    whether its camera meta button is off.  The last index is "inventory",
    alone, with the camera on."""
    combos: List = list(itertools.product(*GROUPS)) + ["inventory"]
    pressed = np.zeros((len(combos), len(BUTTONS)), np.int64)
    camera_off = np.zeros(len(combos), bool)
    for i, combo in enumerate(combos):
        if combo == "inventory":
            pressed[i, BUTTONS.index("inventory")] = 1
            continue
        for name in combo[:-1]:
            if name != "none":
                pressed[i, BUTTONS.index(name)] = 1
        camera_off[i] = combo[-1] == "none"
    return pressed, camera_off


def decode_joint(buttons: np.ndarray, camera: np.ndarray, tables=None) -> Dict[str, np.ndarray]:
    """Joint (buttons, camera) indices (N,) → the env action: each button
    0/1 and "camera" (N, 2) degrees (pitch, yaw)."""
    pressed, camera_off = tables if tables is not None else joint_tables()
    bins = np.stack([camera // N_BINS, camera % N_BINS], axis=-1)
    bins[camera_off[buttons]] = NULL_BIN
    out = {name: pressed[buttons, i] for i, name in enumerate(BUTTONS)}
    out["camera"] = camera_degrees(bins)
    return out
