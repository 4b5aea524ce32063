"""Camera quantization: clip → (optional mu-law companding) → linear binning.

Semantics match the reference CameraQuantizer (reference: lib/actions.py:48-102):
  discretize:  clip to ±maxval; mu-law encode sign(x)·log(1+mu|x/maxval|)/log(1+mu)·maxval;
               then round((x+maxval)/binsize).
  undiscretize: exact inverse of the linear step + mu-law expansion.

Host-side numpy.  The device decode (actions/device_decode.py) gathers from a
table of ``undiscretize`` over every bin instead of redoing this math.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class QuantizationScheme:
    LINEAR = "linear"
    MU_LAW = "mu_law"

    ALL = (LINEAR, MU_LAW)


@dataclasses.dataclass(frozen=True)
class CameraQuantizer:
    """Discretize / undiscretize continuous camera (pitch, yaw) deltas.

    :param camera_maxval: clip limit in degrees (bins span [-maxval, +maxval])
    :param camera_binsize: linear bin width (average width under mu-law)
    :param quantization_scheme: "linear" or "mu_law"
    :param mu: mu-law curvature (higher = finer bins near zero)
    """

    camera_maxval: int
    camera_binsize: int
    quantization_scheme: str = QuantizationScheme.LINEAR
    mu: float = 5.0

    def __post_init__(self):
        if self.quantization_scheme not in QuantizationScheme.ALL:
            raise ValueError(f"unknown quantization scheme {self.quantization_scheme}")

    @property
    def n_bins(self) -> int:
        return 2 * self.camera_maxval // self.camera_binsize + 1

    @property
    def null_bin(self) -> int:
        return self.camera_maxval // self.camera_binsize

    def discretize(self, xy):
        xy = np.clip(xy, -self.camera_maxval, self.camera_maxval)
        if self.quantization_scheme == QuantizationScheme.MU_LAW:
            v = xy / self.camera_maxval
            v = np.sign(v) * (np.log(1.0 + self.mu * np.abs(v)) / np.log(1.0 + self.mu))
            xy = v * self.camera_maxval
        return np.round((xy + self.camera_maxval) / self.camera_binsize).astype(np.int64)

    def undiscretize(self, pq):
        xy = pq * self.camera_binsize - self.camera_maxval
        if self.quantization_scheme == QuantizationScheme.MU_LAW:
            v = xy / self.camera_maxval
            v = np.sign(v) * (1.0 / self.mu) * ((1.0 + self.mu) ** np.abs(v) - 1.0)
            xy = v * self.camera_maxval
        return xy
