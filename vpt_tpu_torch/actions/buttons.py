"""The factored Minecraft button space (reference: lib/actions.py:8-40).

20 binary buttons: 11 named actions + 9 hotbar slots.  The ordering is part of
the checkpoint contract (the IDM's buttons head indexes this list), so it is
fixed here exactly as the reference fixes it.
"""


class Buttons:
    ATTACK = "attack"
    BACK = "back"
    FORWARD = "forward"
    JUMP = "jump"
    LEFT = "left"
    RIGHT = "right"
    SNEAK = "sneak"
    SPRINT = "sprint"
    USE = "use"
    DROP = "drop"
    INVENTORY = "inventory"

    ALL = [
        ATTACK,
        BACK,
        FORWARD,
        JUMP,
        LEFT,
        RIGHT,
        SNEAK,
        SPRINT,
        USE,
        DROP,
        INVENTORY,
    ] + [f"hotbar.{i}" for i in range(1, 10)]


class SyntheticButtons:
    # Composite / scripted actions (unused by the published human action space)
    CHANNEL_ATTACK = "channel-attack"

    ALL = [CHANNEL_ATTACK]
