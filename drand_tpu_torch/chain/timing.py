"""Round <-> time math with overflow guards (chain/time.go:18-63).

The port's copy of drand_tpu/chain/timing.py, unchanged but for its imports.

All times are UNIX seconds (ints); periods are positive int seconds.
Round 1 happens exactly at genesis; round 0 is the genesis beacon itself.
"""

import math

_MAX_INT64 = (1 << 63) - 1
_TIME_BUFFER = 1 << 36  # headroom below int64 max (time.go:9-11)
TIME_OF_ROUND_ERROR = _MAX_INT64 - _TIME_BUFFER


def time_of_round(period: int, genesis: int, round_: int) -> int:
    """UNIX time the given round should happen (time.go:18-39)."""
    if round_ == 0:
        return genesis
    if period < 0:
        return TIME_OF_ROUND_ERROR
    period_bits = math.log2(period + 1)
    if round_ >= ((1 << 64) - 1) >> (int(period_bits) + 2):
        return TIME_OF_ROUND_ERROR
    val = genesis + (round_ - 1) * period
    if val > _MAX_INT64 - _TIME_BUFFER:
        return TIME_OF_ROUND_ERROR
    return val


def next_round(now: int, period: int, genesis: int):
    """(next upcoming round, its UNIX time) (time.go:52-63)."""
    if now < genesis:
        return 1, genesis
    from_genesis = now - genesis
    next_r = from_genesis // period + 1
    next_t = genesis + (next_r * period)
    return next_r + 1, next_t


def current_round(now: int, period: int, genesis: int) -> int:
    """The round active at `now` (time.go:41-48)."""
    next_r, _ = next_round(now, period, genesis)
    if next_r <= 1:
        return next_r
    return next_r - 1
