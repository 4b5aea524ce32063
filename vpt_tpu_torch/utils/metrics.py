"""Structured metrics: one JSON line per log call (counterpart of
vpt_tpu/utils/metrics.py ``MetricsLogger``)."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


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
