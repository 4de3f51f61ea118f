"""User-supplied entropy sources (reference: entropy/entropy.go:16-67).

`get_random(source, n)` falls back to the OS CSPRNG when the custom source
fails or under-delivers; `ScriptReader` shells out to a user executable and
concatenates its stdout until n bytes are available.

The port's copy of drand_tpu/entropy.py, unchanged but for its imports.
"""

import secrets
import subprocess
from typing import Optional


class ScriptReader:
    """Entropy from a user script's stdout (entropy.go:33-58)."""

    def __init__(self, path: str):
        self.path = path

    def read(self, n: int) -> bytes:
        if not self.path:
            raise ValueError("no reader was provided")
        out = b""
        while len(out) < n:
            proc = subprocess.run([self.path], capture_output=True,
                                  timeout=30)
            if proc.returncode != 0 or not proc.stdout:
                raise OSError(f"entropy script failed: rc={proc.returncode}")
            out += proc.stdout
        return out[:n]


def get_random(source: Optional[object], n: int) -> bytes:
    """n random bytes from `source` (an object with .read(n)->bytes), with
    CSPRNG fallback on any failure (entropy.go:16-30)."""
    if source is None:
        return secrets.token_bytes(n)
    try:
        data = source.read(n)
        if len(data) == n:
            return data
    except Exception:
        pass
    return secrets.token_bytes(n)
