"""Shared constants and the lock factories of the serving plane.

The port's copy of drand_tpu/common.py: beacon-ID helpers and
make_lock / make_rlock / make_condition as plain ``threading`` primitives.
The reference's lock-order sanitizer hook is not carried, so each factory
is the stock primitive.
"""

import threading

DEFAULT_BEACON_ID = "default"


def is_default_beacon_id(beacon_id: str) -> bool:
    return beacon_id in ("", DEFAULT_BEACON_ID)


def compare_beacon_ids(id1: str, id2: str) -> bool:
    if is_default_beacon_id(id1) and is_default_beacon_id(id2):
        return True
    return id1 == id2


def make_lock():
    """A mutex (``threading.Lock``)."""
    return threading.Lock()


def make_rlock():
    """A re-entrant mutex (``threading.RLock``)."""
    return threading.RLock()


def make_condition(lock=None):
    """A condition variable over `lock` (a fresh RLock when None)."""
    return threading.Condition(lock)
