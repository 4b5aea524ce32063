"""The share of the bytes the serving steps copied to the device from
pageable (unpinned) host memory, in percent: the program's
``h2d_pageable_bytes`` over ``h2d_bytes``, counted at its upload span's
boundary in the profiled stretch."""

from portbench.spans import counter_pct


def read(run):
    return counter_pct(run, "serve", "h2d_pageable_bytes", "h2d_bytes")
