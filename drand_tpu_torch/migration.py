"""Disk-layout migration: single-beacon v1 folders -> multibeacon
(reference: core/migration/migration.go:15-119, CLI `util migrate`).

v1 layout:   <folder>/{key,groups,db}
multibeacon: <folder>/multibeacon/<beaconID>/{key,groups,db}

The port's copy of drand_tpu/migration.py, unchanged but for its imports.
"""

import os
import shutil

from .common import DEFAULT_BEACON_ID, MULTI_BEACON_FOLDER

_V1_DIRS = ("key", "groups", "db")


def needs_migration(folder: str) -> bool:
    """v1 dirs still present — regardless of whether a multibeacon layout
    already exists (a daemon may have created it before the operator ran
    migrate, or a previous run may have moved only some dirs)."""
    return any(os.path.isdir(os.path.join(folder, d)) for d in _V1_DIRS)


def migrate(folder: str, beacon_id: str = DEFAULT_BEACON_ID) -> bool:
    """Move v1 dirs under multibeacon/<id>/; returns True when work was done.
    Safe to re-run (no-op when already migrated); refuses to clobber data
    that already exists at the destination."""
    if not needs_migration(folder):
        return False
    target = os.path.join(folder, MULTI_BEACON_FOLDER, beacon_id)
    os.makedirs(target, mode=0o700, exist_ok=True)
    moves = [(os.path.join(folder, d), os.path.join(target, d))
             for d in _V1_DIRS if os.path.isdir(os.path.join(folder, d))]
    # check every destination BEFORE moving anything: failing halfway
    # would leave a layout neither reader understands
    conflicts = [dst for _, dst in moves if os.path.exists(dst)]
    if conflicts:
        raise RuntimeError(
            f"migration targets already exist: {conflicts}; resolve the "
            f"conflicts manually (v1 data left in place)")
    for src, dst in moves:
        shutil.move(src, dst)
    return True
