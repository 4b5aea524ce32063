"""Recorder jsonl steps ↔ MineRL env actions (counterpart of
vpt_tpu/actions/json_actions.py).  The reader (reference
run_inverse_dynamics_model.py:17-125: keyboard mapping, noop template,
camera sensitivity scaler, null-action detection) and the writer
(``RecorderJsonlWriter``, ``env_action_to_json_action``), which produces
the recorder's format from env actions, so that recorded agent play loads
through the same BC data pipeline as contractor data."""

from __future__ import annotations

import numpy as np

KEYBOARD_BUTTON_MAPPING = {
    "key.keyboard.escape": "ESC",
    "key.keyboard.s": "back",
    "key.keyboard.q": "drop",
    "key.keyboard.w": "forward",
    "key.keyboard.1": "hotbar.1",
    "key.keyboard.2": "hotbar.2",
    "key.keyboard.3": "hotbar.3",
    "key.keyboard.4": "hotbar.4",
    "key.keyboard.5": "hotbar.5",
    "key.keyboard.6": "hotbar.6",
    "key.keyboard.7": "hotbar.7",
    "key.keyboard.8": "hotbar.8",
    "key.keyboard.9": "hotbar.9",
    "key.keyboard.e": "inventory",
    "key.keyboard.space": "jump",
    "key.keyboard.a": "left",
    "key.keyboard.d": "right",
    "key.keyboard.left.shift": "sneak",
    "key.keyboard.left.control": "sprint",
    "key.keyboard.f": "swapHands",
}

# all buttons up, no camera motion
NOOP_ACTION = {
    "ESC": 0,
    "back": 0,
    "drop": 0,
    "forward": 0,
    "hotbar.1": 0,
    "hotbar.2": 0,
    "hotbar.3": 0,
    "hotbar.4": 0,
    "hotbar.5": 0,
    "hotbar.6": 0,
    "hotbar.7": 0,
    "hotbar.8": 0,
    "hotbar.9": 0,
    "inventory": 0,
    "jump": 0,
    "left": 0,
    "right": 0,
    "sneak": 0,
    "sprint": 0,
    "swapHands": 0,
    "camera": np.array([0, 0]),
    "attack": 0,
    "use": 0,
    "pickItem": 0,
}

# recorder mouse sensitivity → model camera degrees (the MineRL constant)
CAMERA_SCALER = 360.0 / 2400.0

# recorder mouse button index → env button name
MOUSE_BUTTON_NAMES = {0: "attack", 1: "use", 2: "pickItem"}


def parse_recorder_step(json_action):
    """Structured view of one recorder jsonl step.

    :returns: (held_buttons, (pitch, yaw), mouse_moved): the set of env
        button names down on this step (keyboard and mouse; unmapped keys are
        ignored and ESC is kept as it is), and the camera delta in degrees.
    """
    mouse = json_action["mouse"]
    held = {KEYBOARD_BUTTON_MAPPING[k] for k in json_action["keyboard"]["keys"] if k in KEYBOARD_BUTTON_MAPPING}
    held.update(name for idx, name in MOUSE_BUTTON_NAMES.items() if idx in mouse["buttons"])
    moved = mouse["dx"] != 0 or mouse["dy"] != 0
    return held, (mouse["dy"] * CAMERA_SCALER, mouse["dx"] * CAMERA_SCALER), moved


def json_action_to_env_action(json_action):
    """One recorder jsonl step → (MineRL action dict, is_null_action).

    A step is null when no button is held and the mouse did not move; the BC
    data pipeline drops those.  Quirk kept from the reference: the camera
    slot is an integer array, so the scaled deltas truncate toward zero to
    whole degrees on assignment.
    """
    held, (pitch, yaw), moved = parse_recorder_step(json_action)
    env_action = dict(NOOP_ACTION, camera=np.array([0, 0]))
    for name in held:
        env_action[name] = 1
    if moved:
        camera = env_action["camera"]
        camera[0] = pitch  # int array: truncates toward zero
        camera[1] = yaw
    return env_action, not (held or moved)


def json_actions_to_env_actions(json_actions):
    """Batch form: list of steps → (list of env actions, bool null mask)."""
    parsed = [json_action_to_env_action(step) for step in json_actions]
    return [a for a, _ in parsed], np.array([null for _, null in parsed], bool)


_INV_KEYBOARD = {v: k for k, v in KEYBOARD_BUTTON_MAPPING.items()}
_INV_MOUSE = {name: idx for idx, name in MOUSE_BUTTON_NAMES.items()}


def _scalar(v) -> int:
    return int(np.asarray(v).reshape(-1)[0])


class RecorderJsonlWriter:
    """Env action → recorder jsonl step, with the per-step state the env
    action lacks: ``newButtons`` (mouse buttons down now and up the step
    before), the selected ``hotbar`` slot (from hotbar.N presses) and
    ``isGuiOpen`` (toggled by a fresh ``inventory`` press, closed by a fresh
    ``ESC``).  The GUI flag is exact for scripted rollouts; in a real game a
    GUI also opens in ways the actions do not show (a chest, a death
    screen).  Re-parsing a written step returns the action with its camera
    truncated to whole degrees, as real recordings lose sub-degree motion.
    """

    def __init__(self, gui_open: bool = False, hotbar_slot: int = 0):
        self._prev_mouse: set = set()
        self._prev_inventory = False
        self._prev_esc = False
        self._gui = bool(gui_open)
        self._hotbar = int(hotbar_slot)

    def step(self, env_action, mouse_xy=(640.0, 360.0)) -> dict:
        """One recorder jsonl row for ``env_action``; ``mouse_xy`` is the
        cursor in the recorder's 1280×720 screen (used while a GUI is open)."""
        held_keys = sorted(_INV_KEYBOARD[name] for name in KEYBOARD_BUTTON_MAPPING.values()
                           if _scalar(env_action.get(name, 0)))
        mouse_buttons = sorted(idx for name, idx in _INV_MOUSE.items() if _scalar(env_action.get(name, 0)))
        new_buttons = sorted(set(mouse_buttons) - self._prev_mouse)
        self._prev_mouse = set(mouse_buttons)

        inventory = bool(_scalar(env_action.get("inventory", 0)))
        if inventory and not self._prev_inventory:
            self._gui = not self._gui
        self._prev_inventory = inventory
        esc = bool(_scalar(env_action.get("ESC", 0)))
        if esc and not self._prev_esc:
            self._gui = False
        self._prev_esc = esc

        for slot in range(9):
            if _scalar(env_action.get(f"hotbar.{slot + 1}", 0)):
                self._hotbar = slot
                break

        camera = np.asarray(env_action.get("camera", (0.0, 0.0)), np.float64)
        pitch, yaw = float(camera[0]), float(camera[1])
        return {
            "keyboard": {"keys": held_keys},
            "mouse": {
                "x": float(mouse_xy[0]),
                "y": float(mouse_xy[1]),
                "dx": yaw / CAMERA_SCALER,
                "dy": pitch / CAMERA_SCALER,
                "buttons": mouse_buttons,
                "newButtons": new_buttons,
            },
            "hotbar": self._hotbar,
            "isGuiOpen": self._gui,
        }


def env_action_to_json_action(env_action) -> dict:
    """Stateless one-step form of :class:`RecorderJsonlWriter` (newButtons
    are the held buttons, the hotbar slot from this step alone, GUI closed)."""
    return RecorderJsonlWriter().step(env_action)
