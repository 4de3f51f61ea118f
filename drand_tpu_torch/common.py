"""Lock factories of the serving plane.

The port's copy of make_lock / make_condition (drand_tpu/common.py): plain
``threading`` primitives.  The reference's lock-order sanitizer hook is not
carried, so each factory is the stock primitive.
"""

import threading


def make_lock():
    """A mutex (``threading.Lock``)."""
    return threading.Lock()


def make_condition(lock=None):
    """A condition variable over `lock` (a fresh RLock when None)."""
    return threading.Condition(lock)
