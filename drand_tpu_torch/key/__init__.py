"""Identities, shares and the group (the port's copy of drand_tpu/key/,
without its file store)."""

from .keys import (DistPublic, Identity, Pair, Share, minimum_t, new_keypair)
from .group import Group, Node, new_group

__all__ = ["Pair", "Identity", "Share", "DistPublic", "minimum_t",
           "new_keypair", "Group", "Node", "new_group"]
