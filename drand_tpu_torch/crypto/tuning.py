"""Lane-width / pipeline-depth tuning results (TUNING.json).

The port's copy of drand_tpu/crypto/tuning.py.  The verify service consults
it at handle creation; precedence, each knob on its own:

  1. explicit value (VerifyService ctor arg set non-zero): tests and
     operators pin;
  2. env override: DRAND_VERIFY_PAD / DRAND_VERIFY_PIPELINE_DEPTH;
  3. TUNING.json entry for (current platform, scheme kind):
     DRAND_TUNING_FILE, else ./TUNING.json, else the repo root copy;
  4. the defaults: pad 8192, depth 1.

File shape::

    {"version": 1,
     "entries": {"cuda": {"g2": {"pad": 16384, "depth": 2,
                                 "rounds_per_s": 6000.0},
                          "g2@4": {"pad": 32768, "depth": 2, ...}, ...},
                 "cpu": {...}}}

The port's service looks entries up under platform "cuda" (a pool with a
GPU) or "cpu"; the JAX service's "tpu" entries never apply to it.  A
`<kind>@<n>` entry is the winner measured on an n-device group and beats
the bare `<kind>` entry for handles whose group owns n devices; the bare
kind is the fallback for sizes with no sweep of their own.

The caller supplies the platform string.
"""

import json
import os

from ..common import make_lock
from typing import Optional, Tuple

DEFAULT_PAD = 8192
DEFAULT_DEPTH = 1
TUNING_BASENAME = "TUNING.json"

_lock = make_lock()
_cache = {}     # path -> (mtime, parsed entries)


def tuning_path() -> Optional[str]:
    """The tuning file in effect: DRAND_TUNING_FILE wins (even when the
    file is absent — an operator pinning a path must not silently fall
    through to a stale repo copy), then ./TUNING.json, then the copy
    beside the package (repo root)."""
    env = os.environ.get("DRAND_TUNING_FILE")
    if env:
        return env
    for cand in (os.path.join(os.getcwd(), TUNING_BASENAME),
                 os.path.join(os.path.dirname(os.path.dirname(
                     os.path.dirname(os.path.abspath(__file__)))),
                     TUNING_BASENAME)):
        if os.path.exists(cand):
            return cand
    return None


def load_entries(path: Optional[str] = None) -> dict:
    """Parsed `entries` of the tuning file (mtime-cached); {} when there
    is no file or it is unreadable/malformed — tuning is advisory, a bad
    file must never take verification down."""
    path = path or tuning_path()
    if not path:
        return {}
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return {}
    with _lock:
        hit = _cache.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
    try:
        with open(path) as f:
            data = json.load(f)
        entries = dict(data.get("entries", {}))
    except (OSError, ValueError):
        entries = {}
    with _lock:
        _cache[path] = (mtime, entries)
    return entries


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def resolve(kind: str, platform: str,
            pad: Optional[int] = None,
            depth: Optional[int] = None,
            group_size: int = 1) -> Tuple[int, int, str]:
    """(pad, depth, source) for a verify handle of `kind` ("g1" | "g2")
    on `platform` ("cuda" | "cpu") whose
    device group owns `group_size` devices.  Explicit args pin; env
    overrides beat the file; the file must match the CURRENT platform
    (a card sweep's numbers never apply to the CPU)
    and prefers the `<kind>@<group_size>` entry over the bare `<kind>`
    fallback; otherwise the 8192x1 defaults."""
    src_pad = src_depth = "default"
    out_pad, out_depth = DEFAULT_PAD, DEFAULT_DEPTH
    plat_entries = load_entries().get(platform, {})
    if not isinstance(plat_entries, dict):
        plat_entries = {}
    ent = plat_entries.get(f"{kind}@{int(group_size)}")
    if not isinstance(ent, dict):
        ent = plat_entries.get(kind, {})
    if isinstance(ent, dict):
        if isinstance(ent.get("pad"), int) and ent["pad"] > 0:
            out_pad, src_pad = ent["pad"], "tuning"
        if isinstance(ent.get("depth"), int) and ent["depth"] > 0:
            out_depth, src_depth = ent["depth"], "tuning"
    env_pad = _env_int("DRAND_VERIFY_PAD")
    if env_pad:
        out_pad, src_pad = env_pad, "env"
    env_depth = _env_int("DRAND_VERIFY_PIPELINE_DEPTH")
    if env_depth:
        out_depth, src_depth = env_depth, "env"
    if pad:
        out_pad, src_pad = int(pad), "explicit"
    if depth:
        out_depth, src_depth = int(depth), "explicit"
    return out_pad, out_depth, f"pad:{src_pad},depth:{src_depth}"


def write_tuning(path: str, platform: str, results: dict) -> None:
    """Merge `results` ({kind: {"pad": .., "depth": .., "rounds_per_s": ..}})
    for `platform` into the tuning file (atomic temp + rename)."""
    data = {"version": 1, "entries": {}}
    try:
        with open(path) as f:
            old = json.load(f)
        if isinstance(old.get("entries"), dict):
            data["entries"] = old["entries"]
    except (OSError, ValueError):
        pass
    data["entries"].setdefault(platform, {}).update(results)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    with _lock:
        _cache.pop(path, None)
