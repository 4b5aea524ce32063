"""Structured metrics (counterpart of vpt_tpu/utils/metrics.py): one JSON
line per log call (``MetricsLogger``), and the IDM's agreement with recorded
actions (``AgreementMeter``)."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import numpy as np


class MetricsLogger:
    """Writes one JSON object per log call to stdout and optionally a file."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._file = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stdout
        self._t0 = time.time()

    def log(self, **fields):
        fields.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(fields, default=float)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class AgreementMeter:
    """Predicted-against-recorded action agreement, for IDM labeling
    quality: per-button accuracy, the exact-match rate over the whole button
    vector, and the camera's mean absolute error in degrees (the reference
    only shows the two side by side, run_inverse_dynamics_model.py:165-190)."""

    def __init__(self):
        self.n = 0
        self.exact = 0
        self._keys = None
        self._hits = None
        self._cam_abs = 0.0
        self._cam_n = 0

    @staticmethod
    def _scalar(v) -> int:
        return int(np.asarray(v).ravel()[0])

    def add(self, predicted: dict, recorded: dict) -> None:
        keys = sorted(k for k in predicted if k != "camera")
        if self._keys is None:
            self._keys = keys
            self._hits = np.zeros(len(keys), np.int64)
        p = np.array([self._scalar(predicted[k]) for k in self._keys])
        r = np.array([self._scalar(recorded.get(k, 0)) for k in self._keys])
        same = p == r
        self._hits += same
        self.exact += int(same.all())
        cam_p = np.asarray(predicted["camera"], np.float64).ravel()
        cam_r = np.asarray(recorded.get("camera", np.zeros_like(cam_p)), np.float64).ravel()
        self._cam_abs += float(np.abs(cam_p - cam_r).sum())
        self._cam_n += cam_p.size
        self.n += 1

    def summary(self) -> dict:
        if not self.n:
            return {"frames": 0}
        per_button = {k: round(float(h) / self.n, 4) for k, h in zip(self._keys, self._hits)}
        return {
            "frames": self.n,
            "button_accuracy_mean": round(float(self._hits.sum()) / (self.n * len(self._keys)), 4),
            "button_exact_match": round(self.exact / self.n, 4),
            "camera_mae_degrees": round(self._cam_abs / max(self._cam_n, 1), 4),
            "per_button_accuracy": per_button,
        }
