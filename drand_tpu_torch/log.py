"""Structured, named, leveled logging: the port's copy of drand_tpu/log.py,
unchanged (reference: log/log.go:18-34's zap
SugaredLogger wrapper; named hierarchies like
`daemon.Named(addr).Named(beaconID).Named(index)` core/drand_beacon.go:155).

Console or JSON output; bulk-operation rate limiting mirrors the reference's
`LogsToSkip=300` (common/beacon.go:21, sync_manager.go:391-401).
"""

import json
import logging
import sys
import threading
import time
from typing import Any, Optional

LOGS_TO_SKIP = 300   # bulk ops: emit 1 of every N (common/beacon.go:21)

_root_config = {"json": False, "level": logging.INFO, "stream": None}
_config_lock = threading.Lock()


def configure(level: str = "info", json_output: bool = False,
              stream=None) -> None:
    """Process-wide logging config (CLI --verbose / --json flags)."""
    with _config_lock:
        _root_config["level"] = getattr(logging, level.upper(), logging.INFO)
        _root_config["json"] = json_output
        _root_config["stream"] = stream


class Logger:
    """Named logger with key-value structured fields."""

    def __init__(self, name: str = "drand", fields: Optional[dict] = None):
        self.name = name
        self.fields = fields or {}
        self._skip_counter = 0
        self._skip_lock = threading.Lock()

    def named(self, suffix: str) -> "Logger":
        return Logger(f"{self.name}.{suffix}", dict(self.fields))

    def with_fields(self, **fields: Any) -> "Logger":
        merged = dict(self.fields)
        merged.update(fields)
        return Logger(self.name, merged)

    # -- emit ----------------------------------------------------------------

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        if level < _root_config["level"]:
            return
        stream = _root_config["stream"] or sys.stderr
        fields = dict(self.fields)
        fields.update(kv)
        if _root_config["json"]:
            rec = {"ts": time.time(), "level": logging.getLevelName(level),
                   "logger": self.name, "msg": msg, **fields}
            print(json.dumps(rec, default=str), file=stream)
        else:
            kvs = " ".join(f"{k}={v}" for k, v in fields.items())
            ts = time.strftime("%H:%M:%S")
            lvl = logging.getLevelName(level)[:4]
            print(f"{ts} {lvl} [{self.name}] {msg}"
                  + (f" {kvs}" if kvs else ""), file=stream)

    def debug(self, msg: str, **kv):
        self._emit(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv):
        self._emit(logging.INFO, msg, kv)

    def warn(self, msg: str, **kv):
        self._emit(logging.WARNING, msg, kv)

    def error(self, msg: str, **kv):
        self._emit(logging.ERROR, msg, kv)

    def rate_limited_info(self, msg: str, **kv):
        """Emit 1 of every LOGS_TO_SKIP calls (bulk sync loops)."""
        with self._skip_lock:
            self._skip_counter += 1
            if self._skip_counter % LOGS_TO_SKIP != 1:
                return
        self._emit(logging.INFO, msg, kv)


DEFAULT = Logger()
