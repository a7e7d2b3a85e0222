"""Structured metrics logging: JSONL file + stdout mirror (port of
visdial_tpu/utils/logging.py, unchanged)."""

from __future__ import annotations

import json
import os
import sys
import time


class MetricsLogger:
    def __init__(self, path: str | None = None, mirror: bool = True):
        self.path = path
        self.mirror = mirror
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        record = {"t": round(time.time() - self._t0, 3), **record}
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
        if self.mirror:
            print(line, file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
