"""L6 daemon orchestration (the port's copy of drand_tpu/core/; reference:
core/, SURVEY.md §2.7).

The exports load on first use (a module ``__getattr__``): the REST edge
imports `core.authz` and must run where grpc is absent, and the daemon
imports grpc.
"""

import importlib

_EXPORTS = {"BeaconProcess": "beacon_process", "Config": "config",
            "default_config_folder": "config", "DrandDaemon": "daemon",
            "TenantConfig": "tenancy", "TenantRegistry": "tenancy"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
