"""Structured JSON-lines events of the sweep and the emulator build.

Counterpart of ``bdlz_tpu/utils/logging.py``: one line per event,
``{"ts": <unix seconds, 3 decimals>, "event": <name>, **fields}``.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Any, Optional


class EventLog:
    """JSON-lines event logger to a stream or (appending) to a file."""

    def __init__(self, stream: Optional[IO[str]] = None, path: Optional[str] = None):
        self._stream = stream
        self._path = path
        self._fh: Optional[IO[str]] = None

    def _out(self) -> IO[str]:
        if self._fh is None:
            if self._path is not None:
                self._fh = open(self._path, "a", encoding="utf-8")
            else:
                self._fh = self._stream or sys.stderr
        return self._fh

    def emit(self, event: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        out = self._out()
        out.write(json.dumps(rec, default=str) + "\n")
        out.flush()

    def close(self) -> None:
        if self._fh is not None and self._path is not None:
            self._fh.close()
            self._fh = None
