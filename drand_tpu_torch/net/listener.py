"""gRPC listeners + gateways (net/listener.go:37-209, net/gateway.go:17-105,
net/control.go:23-96).

A `PrivateGateway` is the daemon's composite network face: a serving
listener (Protocol + Public on the node-to-node port) plus the dialing
`ProtocolClient`.  The control plane is a separate localhost listener
serving the `Control` service for the CLI.

The port's copy of drand_tpu/net/listener.py, unchanged but for its imports.
"""

import threading
from concurrent import futures
from typing import Optional

import grpc

from . import services
from .client import CertManager, Peer, ProtocolClient


class Listener:
    """One gRPC server bound to an address, serving given (spec, impl)
    pairs.  TLS when cert/key paths are provided (net/listener.go:132-166).

    `admission` (net/admission.py AdmissionController) installs the
    serving-plane interceptor: every RPC is classified critical / normal /
    sheddable and admitted (or shed with RESOURCE_EXHAUSTED + a
    retry-after trailer) BEFORE its service method runs.  The worker pool
    stays deliberately bounded — admission control decides who gets a
    worker; the pool size only caps parallelism."""

    def __init__(self, address: str, handlers, tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None, max_workers: int = 16,
                 admission=None, identity=None):
        self.address = address
        interceptors = ()
        max_rpcs = None
        if admission is not None:
            from .admission import AdmissionInterceptor
            interceptors = (AdmissionInterceptor(admission),)
            # the TOKENS must be the binding constraint, not the executor:
            # with fewer workers than tokens, a read flood would fill the
            # worker pool and queue critical partials in the executor's
            # unbounded queue BEFORE their interceptor (which would admit
            # them via the reserve) ever runs.  Workers are lazy-spawned,
            # so the headroom costs nothing while idle; maximum_concurrent_
            # rpcs backstops the executor queue itself (gRPC answers the
            # overflow with RESOURCE_EXHAUSTED before accepting the RPC).
            max_workers = max(max_workers, admission.capacity + 8)
            max_rpcs = 2 * admission.capacity
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            interceptors=interceptors,
            maximum_concurrent_rpcs=max_rpcs)
        self.server.add_generic_rpc_handlers(
            tuple(spec.handler(impl) for spec, impl in handlers))
        if identity is not None:
            # mTLS (net/identity.py): hot-reloadable server
            # credentials that REQUIRE a client certificate — the peer's
            # SAN set becomes its authenticated identity downstream.
            self.port = self.server.add_secure_port(
                address, identity.server_credentials())
        elif tls_cert and tls_key:
            with open(tls_key, "rb") as f:
                key = f.read()
            with open(tls_cert, "rb") as f:
                crt = f.read()
            creds = grpc.ssl_server_credentials(((key, crt),))
            self.port = self.server.add_secure_port(address, creds)
        else:
            self.port = self.server.add_insecure_port(address)
        if self.port == 0:
            raise OSError(f"cannot bind {address}")

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 1.0) -> None:
        # bounded: grace covers in-flight RPC drain, the pad covers gRPC's
        # own teardown — a stuck handler must not hang daemon shutdown
        self.server.stop(grace).wait(timeout=grace + 10.0)


class PrivateGateway:
    """Serving + dialing composite for the node-to-node plane
    (net/gateway.go:17-105).  `protocol_impl` and `public_impl` provide the
    snake_case RPC methods of their service specs."""

    def __init__(self, address: str, protocol_impl, public_impl,
                 certs: Optional[CertManager] = None,
                 tls_cert: Optional[str] = None, tls_key: Optional[str] = None,
                 resilience=None, admission=None, identity=None):
        self.listener = Listener(
            address,
            [(services.PROTOCOL, protocol_impl), (services.PUBLIC, public_impl)],
            tls_cert=tls_cert, tls_key=tls_key, admission=admission,
            identity=identity)
        self.client = ProtocolClient(certs=certs, resilience=resilience,
                                     identity=identity)
        host = address.rsplit(":", 1)[0]
        self.listen_addr = f"{host}:{self.listener.port}"

    def start_all(self) -> None:
        self.listener.start()

    def stop_all(self) -> None:
        self.listener.stop()
        self.client.close()


class ControlListener:
    """Localhost control-plane server (net/control.go:23-66)."""

    def __init__(self, control_impl, port: int = 0, host: str = "127.0.0.1",
                 identity=None):
        self.listener = Listener(f"{host}:{port}",
                                 [(services.CONTROL, control_impl)],
                                 identity=identity)
        self.port = self.listener.port

    def start(self) -> None:
        self.listener.start()

    def stop(self) -> None:
        self.listener.stop()


class ControlClient:
    """CLI-side control-plane client (net/control.go:68-96).

    When the daemon runs with an identity plane the control listener also
    requires mTLS; point the client at the same cert dir (explicitly via
    `identity_dir`, or the DRAND_IDENTITY_DIR env the CLI already exports
    for the daemon) so operator subcommands keep working."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 10.0, identity_dir: Optional[str] = None):
        target = f"{host}:{port}"
        if identity_dir is None:
            import os
            identity_dir = os.environ.get("DRAND_IDENTITY_DIR") or None
        if identity_dir:
            from .identity import IdentityPlane
            plane = IdentityPlane(identity_dir)
            self.channel = grpc.secure_channel(
                target, plane.channel_credentials(),
                # per-node certs carry localhost SANs, but name the target
                # explicitly so dialing via 127.0.0.1 always verifies
                options=(("grpc.ssl_target_name_override", "localhost"),))
        else:
            self.channel = grpc.insecure_channel(target)
        self.timeout = timeout
        self.stub = services.CONTROL.stub(self.channel,
                                          default_timeout=timeout)

    def close(self) -> None:
        self.channel.close()
