"""Host-CPU beacon verification, the verify service's fallback.

The port's copy of drand_tpu/crypto/hostverify.py: `HostBatchVerifier` is a
drop-in for `batch.BatchBeaconVerifier.verify_batch` that checks one round
at a time with the pure-Python pairing (`Scheme.verify_beacon`).  It is far
slower than the card (seconds a round), so the service swaps it in only
while a device backend is degraded, and for handles asked for with
``device=False``."""

import numpy as np

from .schemes import Scheme


class HostBatchVerifier:
    kind = "host"    # the metrics label the service reports

    def __init__(self, scheme: Scheme, public_key_bytes: bytes):
        self.scheme = scheme
        self.pub_point = scheme.key_group.from_bytes(public_key_bytes)

    def verify_batch(self, rounds, sigs, prev_sigs=None) -> np.ndarray:
        prev_sigs = prev_sigs or [None] * len(rounds)
        out = [self.scheme.verify_beacon(self.pub_point, r, p, s)
               for r, s, p in zip(rounds, sigs, prev_sigs)]
        return np.array(out, dtype=bool)
