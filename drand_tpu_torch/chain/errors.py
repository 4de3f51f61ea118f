"""Chain error types (chain/errors/errors.go).

The port's copy of drand_tpu/chain/errors.py, unchanged but for its imports.
"""


class ErrNoBeaconStored(Exception):
    """Sync called too early: no beacon stored above the requested round."""


class ErrNoBeaconSaved(Exception):
    """Beacon not found in the database."""


class ErrMissingPrevious(Exception):
    """A trimmed-format store was asked to reconstruct `previous_sig`
    (require_previous=True) but the prior round's row is absent — the chain
    on disk has a hole right below the requested round.  Raised instead of
    silently returning a beacon with a fabricated empty previous_sig, so
    callers (integrity scan, sync linkage checks) see the gap instead of a
    beacon that cannot possibly re-verify.  Round 1 is exempt: it anchors
    on the genesis SEED, which is chain metadata, not a stored row."""

    def __init__(self, round_: int):
        super().__init__(
            f"cannot reconstruct previous_sig for round {round_}: "
            f"round {round_ - 1} is missing from the store")
        self.round = round_
