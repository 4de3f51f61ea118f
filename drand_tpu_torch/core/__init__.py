"""The daemon's core (the port's counterpart of drand_tpu/core/).

Only the tenant-token authority (`authz.py`) is ported so far: the REST
edge checks bearer tokens with it.  The reference package's
``__init__`` exports the daemon, which imports grpc; the port's exports
nothing of the daemon until the daemon itself is ported.
"""
