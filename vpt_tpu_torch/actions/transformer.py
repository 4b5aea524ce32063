"""ActionTransformer: bijection between the MineRL env action dict
(named binary buttons + continuous camera) and the factored numpy action
(buttons (B, 20) int, camera (B, 2) quantized bins).

Reference: lib/actions.py:105-178.  Pure numpy; no device code.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.actions.buttons import Buttons
from vpt_tpu_torch.actions.quantizer import CameraQuantizer


class ActionTransformer:
    def __init__(
        self,
        camera_maxval: int = 10,
        camera_binsize: int = 2,
        camera_quantization_scheme: str = "linear",
        camera_mu: float = 5.0,
    ):
        self.camera_maxval = camera_maxval
        self.camera_binsize = camera_binsize
        self.quantizer = CameraQuantizer(
            camera_maxval=camera_maxval,
            camera_binsize=camera_binsize,
            quantization_scheme=camera_quantization_scheme,
            mu=camera_mu,
        )

    def camera_zero_bin(self) -> int:
        return self.camera_maxval // self.camera_binsize

    def discretize_camera(self, xy):
        return self.quantizer.discretize(xy)

    def undiscretize_camera(self, pq):
        return self.quantizer.undiscretize(pq)

    def numpy_to_dict(self, acs):
        """Factored numpy action → env-format dict of named buttons + camera degrees."""
        assert acs["buttons"].shape[-1] == len(Buttons.ALL), (
            f"Mismatched actions: {acs}; expected {len(Buttons.ALL)}:\n({Buttons.ALL})"
        )
        out = {name: acs["buttons"][..., i] for i, name in enumerate(Buttons.ALL)}
        out["camera"] = self.undiscretize_camera(acs["camera"])
        return out

    def dict_to_numpy(self, acs):
        """Env-format dict → factored numpy action."""
        return {
            "buttons": np.stack([acs.get(k, 0) for k in Buttons.ALL], axis=-1),
            "camera": self.discretize_camera(acs["camera"]),
        }

    def policy2env(self, acs):
        return self.numpy_to_dict(acs)

    def env2policy(self, acs):
        nbatch = acs["camera"].shape[0]
        dummy = np.zeros((nbatch,))
        return {
            "camera": self.discretize_camera(acs["camera"]),
            "buttons": np.stack([acs.get(k, dummy) for k in Buttons.ALL], axis=-1),
        }
