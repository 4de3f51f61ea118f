"""L5 network plane: gRPC services, client pool, gateways, control plane.

The port's copy of drand_tpu/net/ (reference: net/, SURVEY.md §2.6).
Messages live in drand_tpu_torch/protos; service specs in services.py; the
generic service framework in rpc.py.  The chaos proxy (chaosproxy.py) is
not ported yet.

The exports load on first use (a module ``__getattr__``): the public edge
(REST server, client, admission) imports this package and must run where
grpc is absent, and only the gRPC plane's modules import grpc.
"""

import importlib

_EXPORTS = {
    "AdmissionController": "admission", "AdmissionInterceptor": "admission",
    "Shed": "admission", "Ticket": "admission",
    "CertManager": "client", "DialMap": "client", "Peer": "client",
    "ProtocolClient": "client",
    "IdentityPlane": "identity", "PeerIdentity": "identity",
    "issue_cert": "identity", "provision_fleet": "identity",
    "ControlClient": "listener", "ControlListener": "listener",
    "Listener": "listener", "PrivateGateway": "listener",
    "BackoffPolicy": "resilience", "BreakerOpen": "resilience",
    "BreakerRegistry": "resilience", "CircuitBreaker": "resilience",
    "Deadline": "resilience", "DeadlineExceeded": "resilience",
    "ResiliencePolicy": "resilience",
    "CONTROL": "services", "PROTOCOL": "services", "PUBLIC": "services",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
