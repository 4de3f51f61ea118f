"""Secure filesystem helpers, the port's copy of drand_tpu/fs.py, unchanged
(reference fs/fs.go): private dirs 0700,
secret files 0600 — plus the atomic-write primitive every persistent
group/share/journal file must go through (temp + fsync + rename)."""

import os
import tempfile

# Read the process umask ONCE at import (imports are effectively
# single-threaded): os.umask is a get-by-set on global state, so probing
# it per call would race concurrent writers into a 0-umask window that
# chmods files world-writable.
_UMASK = os.umask(0)
os.umask(_UMASK)


def create_secure_folder(path: str) -> str:
    os.makedirs(path, mode=0o700, exist_ok=True)
    return path


def write_atomic(path: str, data: bytes, secure: bool = False) -> None:
    """Crash-safe replace: write to a sibling temp file, fsync, rename.

    A reader (or a restart) sees either the old bytes or the new bytes,
    never a torn file — `open(path, "w")` truncates in place, so a crash
    mid-write leaves an unparseable stub exactly where a node expects its
    group or share (the non-atomic key/state persistence hazard of
    arXiv:2109.11677).  `secure=True` pins 0600 before any byte lands;
    without it the file gets the umask-default mode an open(path, "w")
    would have produced — mkstemp's 0600 must not silently make public
    artifacts (group TOML, public identity) unreadable to sidecar
    readers."""
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname,
                               prefix="." + os.path.basename(path) + ".")
    try:
        if secure:
            os.fchmod(fd, 0o600)
        else:
            os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


def check_secure_file(path: str) -> bool:
    """True iff the file exists with owner-only permissions."""
    try:
        mode = os.stat(path).st_mode & 0o777
    except FileNotFoundError:
        return False
    return mode & 0o077 == 0
