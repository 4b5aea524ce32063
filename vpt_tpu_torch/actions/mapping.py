"""Hierarchical action mapping: factored env space ⇄ joint categorical space.

Re-implements the reference semantics (reference: lib/action_mapping.py) with
fully vectorized numpy table lookups instead of per-row Python loops — the
per-sample dict/loop code in the reference's ``from_factored``
(action_mapping.py:179-213) is O(B · groups) Python; here both directions are
O(1) numpy gathers over precomputed tables, suitable for feeding device-side
pipelines at TPU throughput.

Semantics preserved exactly:
  * 9 mutually-exclusive button groups (incl. the camera on/off meta button),
    jointly enumerated (8640 combos) plus the exclusive "inventory" action
    → 8641-way categorical (action_mapping.py:127-132).
  * camera: 11×11 joint bins → 121-way categorical (action_mapping.py:136-145).
  * group choice priority: the *later* button in a group wins when several are
    pressed in one step (action_mapping.py:95-99); forward+back or left+right
    together cancel to "none" (action_mapping.py:89-92).
  * inventory excludes everything, forces camera to the null bin
    (action_mapping.py:196-205); camera meta "off" decodes to null camera bins
    (action_mapping.py:221-223).
"""

from __future__ import annotations

import abc
import itertools
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from vpt_tpu_torch.actions.buttons import Buttons
from vpt_tpu_torch.spaces import DictType, Discrete, TensorType


class ActionMapping(abc.ABC):
    """Maps between the standard factored MC action space and a derived one.

    :param n_camera_bins: bins per camera axis in the factored space (odd).
    """

    # Mutually-exclusive button groups; "none" is always the first option.
    BUTTONS_GROUPS = OrderedDict(
        hotbar=["none"] + [f"hotbar.{i}" for i in range(1, 10)],
        fore_back=["none", "forward", "back"],
        left_right=["none", "left", "right"],
        sprint_sneak=["none", "sprint", "sneak"],
        use=["none", "use"],
        drop=["none", "drop"],
        attack=["none", "attack"],
        jump=["none", "jump"],
    )

    def __init__(self, n_camera_bins: int = 11):
        assert n_camera_bins % 2 == 1, "n_camera_bins should be odd"
        self.n_camera_bins = n_camera_bins
        self.camera_null_bin = n_camera_bins // 2
        self.stats_ac_space = DictType(
            buttons=TensorType(shape=(len(Buttons.ALL),), eltype=Discrete(2)),
            camera=TensorType(shape=(2,), eltype=Discrete(n_camera_bins)),
        )

    @abc.abstractmethod
    def from_factored(self, ac: Dict) -> Dict:
        """Factored action (with batch dim) → this space."""

    @abc.abstractmethod
    def to_factored(self, ac: Dict) -> Dict:
        """Action in this space (with batch dim) → factored action."""

    @abc.abstractmethod
    def get_action_space_update(self):
        """Action space of this mapping (DictType)."""

    @abc.abstractmethod
    def get_zero_action(self):
        """The null action in this space."""

    @staticmethod
    def _group_choices(ac_buttons: np.ndarray, button_group: List[str]) -> np.ndarray:
        """Vectorized choice index per sample for one mutually-exclusive group.

        Returns int array (B,) with 0 = "none", i = button_group[i].
        Later buttons in the group win ties; forward/back and left/right
        simultaneous presses cancel to "none".
        """
        assert ac_buttons.shape[1] == len(Buttons.ALL), (
            f"There should be {len(Buttons.ALL)} buttons in the factored buttons space"
        )
        assert button_group[0] == "none", "'none' must be the group's first option"
        group_indices = [Buttons.ALL.index(b) for b in button_group if b != "none"]
        pressed = ac_buttons[:, group_indices] != 0  # (B, k)
        if "forward" in button_group and "back" in button_group:
            pressed[np.all(pressed, axis=-1)] = False
        if "left" in button_group and "right" in button_group:
            pressed[np.all(pressed, axis=-1)] = False
        k = pressed.shape[1]
        any_pressed = pressed.any(axis=1)
        # index of the last pressed button, scanning right-to-left
        last = (k - 1) - np.argmax(pressed[:, ::-1], axis=1)
        return np.where(any_pressed, last + 1, 0).astype(np.int64)


class IDMActionMapping(ActionMapping):
    """For the IDM: identity mapping; the IDM predicts the factored space directly."""

    def from_factored(self, ac: Dict) -> Dict:
        return ac

    def to_factored(self, ac: Dict) -> Dict:
        return ac

    def get_action_space_update(self):
        return {
            "buttons": TensorType(shape=(len(Buttons.ALL),), eltype=Discrete(2)),
            "camera": TensorType(shape=(2,), eltype=Discrete(self.n_camera_bins)),
        }

    def get_zero_action(self):
        raise NotImplementedError()


class CameraHierarchicalMapping(ActionMapping):
    """Joint button space with a camera on/off meta action gating a joint camera head."""

    BUTTONS_GROUPS = ActionMapping.BUTTONS_GROUPS.copy()
    BUTTONS_GROUPS["camera"] = ["none", "camera"]
    BUTTONS_COMBINATIONS = list(itertools.product(*BUTTONS_GROUPS.values())) + ["inventory"]
    BUTTONS_COMBINATION_TO_IDX = {comb: i for i, comb in enumerate(BUTTONS_COMBINATIONS)}
    BUTTONS_IDX_TO_COMBINATION = {i: comb for i, comb in enumerate(BUTTONS_COMBINATIONS)}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        n = self.n_camera_bins
        self.camera_groups = OrderedDict(
            camera_x=[f"camera_x{i}" for i in range(n)],
            camera_y=[f"camera_y{i}" for i in range(n)],
        )
        self.n_camera_combinations = n * n
        # joint camera index = x_bin * n + y_bin (itertools.product order:
        # camera_y varies fastest)
        self.camera_null_idx = self.camera_null_bin * n + self.camera_null_bin
        self.inventory_idx = len(self.BUTTONS_COMBINATIONS) - 1
        self._inventory_button_col = Buttons.ALL.index("inventory")
        self._null_action = {"buttons": 0}  # all-"none" combo is index 0 in product order
        self._precompute_tables()

    # ---- table construction -------------------------------------------------

    def _precompute_tables(self):
        groups = list(self.BUTTONS_GROUPS.values())
        sizes = [len(g) for g in groups]
        # mixed-radix strides, last group varies fastest (itertools.product order)
        strides = np.ones(len(sizes), dtype=np.int64)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        self._group_strides = strides
        self._n_joint = int(strides[0] * sizes[0])  # 8640 for defaults

        n_buttons_idx = self._n_joint + 1  # + "inventory"
        # joint buttons index → factored 20-button vector
        self.BUTTON_IDX_TO_FACTORED = np.zeros((n_buttons_idx, len(Buttons.ALL)), dtype=np.int64)
        # joint buttons index → True when the camera meta button is OFF
        self.BUTTON_IDX_TO_CAMERA_META_OFF = np.zeros((n_buttons_idx,), dtype=bool)

        joint = np.arange(self._n_joint, dtype=np.int64)
        for gi, group in enumerate(groups):
            choice = (joint // strides[gi]) % sizes[gi]  # (n_joint,)
            if gi == len(groups) - 1:  # camera meta group
                self.BUTTON_IDX_TO_CAMERA_META_OFF[:-1] = choice == 0
                continue
            for ci, bname in enumerate(group):
                if bname == "none":
                    continue
                col = Buttons.ALL.index(bname)
                self.BUTTON_IDX_TO_FACTORED[:-1, col] |= (choice == ci).astype(np.int64)
        # inventory row: only the inventory button, camera meta treated as ON
        # (reference leaves CAMERA_META_OFF False for "inventory",
        #  action_mapping.py:161-169)
        self.BUTTON_IDX_TO_FACTORED[self.inventory_idx, self._inventory_button_col] = 1

        # joint camera index → (x_bin, y_bin)
        cam = np.arange(self.n_camera_combinations, dtype=np.int64)
        self.CAMERA_IDX_TO_FACTORED = np.stack(
            [cam // self.n_camera_bins, cam % self.n_camera_bins], axis=-1
        )

    # ---- conversions --------------------------------------------------------

    def from_factored(self, ac: Dict) -> Dict:
        assert ac["camera"].ndim == 2, f"bad camera label, {ac['camera']}"
        assert ac["buttons"].ndim == 2, f"bad buttons label, {ac['buttons']}"
        buttons = np.asarray(ac["buttons"])
        camera = np.asarray(ac["camera"])

        groups = list(self.BUTTONS_GROUPS.items())
        joint = np.zeros(buttons.shape[0], dtype=np.int64)
        for gi, (gname, group) in enumerate(groups):
            if gname == "camera":
                choice = (~np.all(camera == self.camera_null_bin, axis=1)).astype(np.int64)
            else:
                choice = self._group_choices(buttons, group)
            joint += choice * self._group_strides[gi]

        inventory = buttons[:, self._inventory_button_col] == 1
        new_buttons = np.where(inventory, self.inventory_idx, joint)

        cam_joint = camera[:, 0] * self.n_camera_bins + camera[:, 1]
        new_camera = np.where(inventory, self.camera_null_idx, cam_joint)

        return dict(buttons=new_buttons[:, None], camera=new_camera[:, None])

    def to_factored(self, ac: Dict) -> Dict:
        assert ac["camera"].shape[-1] == 1
        assert ac["buttons"].shape[-1] == 1
        bidx = np.squeeze(np.asarray(ac["buttons"]), -1)
        cidx = np.squeeze(np.asarray(ac["camera"]), -1)

        new_button_ac = self.BUTTON_IDX_TO_FACTORED[bidx]
        camera_off = self.BUTTON_IDX_TO_CAMERA_META_OFF[bidx]
        new_camera_ac = self.CAMERA_IDX_TO_FACTORED[cidx].copy()
        new_camera_ac[camera_off] = self.camera_null_bin
        return dict(buttons=new_button_ac, camera=new_camera_ac)

    def get_action_space_update(self):
        return {
            "camera": TensorType(shape=(1,), eltype=Discrete(self.n_camera_combinations)),
            "buttons": TensorType(shape=(1,), eltype=Discrete(len(self.BUTTONS_COMBINATIONS))),
        }

    def get_zero_action(self):
        return self._null_action
