"""Minimal gRPC service framework built from message classes.

No grpc protoc plugin ships in this environment, so instead of generated
`*_pb2_grpc.py` stubs each service is declared once as a `ServiceSpec`
(method name, request/response message class, streaming flag) and both
sides are derived from it:

  * `spec.handler(impl)`  -> a `grpc.GenericRpcHandler` for a server; the
    impl object provides one method per RPC, `snake_case(name)(request,
    context)`.
  * `spec.stub(channel)`  -> a client stub exposing the same snake_case
    callables over a `grpc.Channel`.

Wire paths are `/<package.Service>/<Method>` exactly as generated code
would produce, so nodes built on this framework speak standard gRPC
(reference surface: protobuf/drand/protocol.proto:17-37, api.proto:16-28,
control.proto:15-56).

The port's copy of drand_tpu/net/rpc.py, unchanged but for its imports.
"""

import re
from dataclasses import dataclass
from typing import Sequence

import grpc


def snake(name: str) -> str:
    """CamelCase -> snake_case, acronym-aware: SignalDKGParticipant ->
    signal_dkg_participant, ListBeaconIDs -> list_beacon_ids (a plural 's'
    right after an acronym stays attached to it)."""
    s = re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name)
    return re.sub(r"(?<=[A-Z])([A-Z](?!s\b)[a-z])", r"_\1", s).lower()


@dataclass(frozen=True)
class Method:
    name: str                 # wire method name (CamelCase)
    request: type             # protobuf message class
    response: type            # protobuf message class
    server_stream: bool = False


class ServiceSpec:
    def __init__(self, full_name: str, methods: Sequence[Method]):
        self.full_name = full_name
        self.methods = {m.name: m for m in methods}

    # -- server side ---------------------------------------------------------

    def handler(self, impl) -> grpc.GenericRpcHandler:
        handlers = {}
        for m in self.methods.values():
            fn = getattr(impl, snake(m.name))
            if m.server_stream:
                handlers[m.name] = grpc.unary_stream_rpc_method_handler(
                    fn, request_deserializer=m.request.FromString,
                    response_serializer=m.response.SerializeToString)
            else:
                handlers[m.name] = grpc.unary_unary_rpc_method_handler(
                    fn, request_deserializer=m.request.FromString,
                    response_serializer=m.response.SerializeToString)
        return grpc.method_handlers_generic_handler(self.full_name, handlers)

    # -- client side ---------------------------------------------------------

    def stub(self, channel: grpc.Channel, default_timeout: float = None):
        """Client stub; `default_timeout` (seconds) applies to every call
        that doesn't pass its own `timeout=`.  Streaming calls are exempt
        (a sync/watch stream is legitimately long-lived)."""
        return _Stub(self, channel, default_timeout)


class _Stub:
    def __init__(self, spec: ServiceSpec, channel: grpc.Channel,
                 default_timeout: float = None):
        for m in spec.methods.values():
            path = f"/{spec.full_name}/{m.name}"
            if m.server_stream:
                call = channel.unary_stream(
                    path, request_serializer=m.request.SerializeToString,
                    response_deserializer=m.response.FromString)
            else:
                call = channel.unary_unary(
                    path, request_serializer=m.request.SerializeToString,
                    response_deserializer=m.response.FromString)
                if default_timeout is not None:
                    call = _with_default_timeout(call, default_timeout)
            setattr(self, snake(m.name), call)


def _with_default_timeout(call, default):
    def wrapped(request, timeout=default, **kw):
        return call(request, timeout=timeout, **kw)
    return wrapped


def abort_invalid(context, msg: str):
    context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)


def abort_not_found(context, msg: str):
    context.abort(grpc.StatusCode.NOT_FOUND, msg)
