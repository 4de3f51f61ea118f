"""L7 client library (reference: client/, SURVEY.md §2.8).

Decorator pipeline: watch aggregator -> cache -> optimizing ->
verifying(per source) -> transport (HTTP).  The port's copy of
drand_tpu/client/; `GrpcTransport` waits for the port's gRPC transport, so
only what exists is exported."""

from .aggregator import PollingWatcher, WatchAggregator
from .cache import CachingClient
from .client import (From, insecurely, new_client, with_auto_watch,
                     with_cache_size, with_chain_hash, with_chain_info,
                     with_full_chain_verification)
from .interface import Client, Result
from .optimizing import OptimizingClient
from .transports import HttpTransport
from .verify import VerifyingClient, verify_beacon_with_info

__all__ = [
    "Client", "Result", "new_client", "From", "with_chain_info",
    "with_chain_hash", "with_full_chain_verification", "with_cache_size",
    "with_auto_watch", "insecurely", "VerifyingClient", "CachingClient",
    "OptimizingClient", "WatchAggregator", "PollingWatcher",
    "HttpTransport", "verify_beacon_with_info",
]
