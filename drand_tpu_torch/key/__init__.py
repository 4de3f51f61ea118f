"""Identity, group, and key persistence (the port's copy of
drand_tpu/key/; reference `key/`, SURVEY.md §2.2)."""

from .keys import (DistPublic, Identity, Pair, Share, minimum_t, new_keypair)
from .group import Group, Node, new_group
from .store import FileStore

__all__ = ["Pair", "Identity", "Share", "DistPublic", "minimum_t",
           "new_keypair", "Group", "Node", "new_group", "FileStore"]
