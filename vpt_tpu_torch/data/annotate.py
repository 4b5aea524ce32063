"""Frame annotation for visualization videos (counterpart of
vpt_tpu/data/annotate.py).

The reference shows predictions in an interactive cv2 window with putText
overlays (run_inverse_dynamics_model.py:165-190); here the same
"name: prediction (true)" rows are rendered onto the frames with PIL, for a
video written through data/video.py's ``VideoWriter``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def annotate_frame(frame_rgb: np.ndarray, lines: List[str]) -> np.ndarray:
    """Return a copy of the frame with text rows rendered top-left."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame_rgb)
    draw = ImageDraw.Draw(img)
    y = 4
    for line in lines:
        draw.text((6, y), line, fill=(255, 255, 255))
        y += 12
    return np.asarray(img)


def action_rows(
    predicted: Dict[str, np.ndarray],
    recorded: Optional[Dict] = None,
) -> List[str]:
    """Format "name: prediction (true)" rows for one frame's actions."""
    rows = ["name: prediction (true)"]
    for name, value in predicted.items():
        value = np.asarray(value)
        shown = value.tolist() if value.ndim else int(value)
        if recorded is not None and name in recorded:
            rec = np.asarray(recorded[name])
            rec_shown = np.round(rec, 2).tolist() if rec.ndim else int(rec)
            rows.append(f"{name}: {shown} ({rec_shown})")
        else:
            rows.append(f"{name}: {shown}")
    return rows
