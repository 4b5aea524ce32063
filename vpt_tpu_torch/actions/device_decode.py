"""Device-side decode of sampled joint actions to the factored env space
(counterpart of vpt_tpu/actions/device_decode.py).

The host decode (CameraHierarchicalMapping.to_factored →
ActionTransformer.policy2env) is table lookups plus the mu-law expansion of
11 possible bins, so on the device it is three gathers: joint buttons → the
20-button vector, joint buttons → camera-meta-off, joint camera → the two
per-axis degrees (the expansion is tabulated once per bin on the host).  The
step then copies ONE packed array to the host.

Output layout: (B, 22) float32 — columns [0:20] the Buttons.ALL binary
vector, columns [20:22] the camera (pitch, yaw) in degrees.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vpt_tpu_torch.actions.buttons import Buttons
from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.actions.quantizer import CameraQuantizer


class DeviceActionDecoder:
    """Holds the joint→factored tables on ``device``."""

    def __init__(self, mapper: CameraHierarchicalMapping, quantizer: CameraQuantizer,
                 device: torch.device):
        self._buttons_table = torch.as_tensor(
            mapper.BUTTON_IDX_TO_FACTORED, dtype=torch.float32, device=device)
        self._camera_off = torch.as_tensor(mapper.BUTTON_IDX_TO_CAMERA_META_OFF, device=device)
        self._camera_table = torch.as_tensor(mapper.CAMERA_IDX_TO_FACTORED, device=device)
        self._null_bin = mapper.camera_null_bin
        bins = np.arange(mapper.n_camera_bins, dtype=np.float64)
        self._bin_degrees = torch.as_tensor(
            quantizer.undiscretize(bins), dtype=torch.float32, device=device)

    def decode(self, buttons_joint: torch.Tensor, camera_joint: torch.Tensor) -> torch.Tensor:
        """(B,) joint indices → (B, 22) [20 buttons, camera pitch, camera yaw]°."""
        buttons = self._buttons_table[buttons_joint]  # (B, 20)
        cam_bins = self._camera_table[camera_joint]  # (B, 2)
        off = self._camera_off[buttons_joint][:, None]
        cam_bins = torch.where(off, self._null_bin, cam_bins)
        return torch.cat([buttons, self._bin_degrees[cam_bins]], dim=1)


def env_action_from_decoded(decoded: np.ndarray) -> Dict[str, np.ndarray]:
    """(B, ≥22) host array → the env-format dict (host-side assembly only)."""
    out = {name: decoded[:, i].astype(np.int64) for i, name in enumerate(Buttons.ALL)}
    out["camera"] = decoded[:, 20:22].astype(np.float64)
    return out
