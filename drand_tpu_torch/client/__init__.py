"""L7 client library (reference: client/, SURVEY.md §2.8).

Decorator pipeline: watch aggregator -> cache -> optimizing ->
verifying(per source) -> transport (gRPC or HTTP).  The port's copy of
drand_tpu/client/; `GrpcTransport` loads the gRPC plane only when one is
built."""

from .aggregator import PollingWatcher, WatchAggregator
from .cache import CachingClient
from .client import (From, insecurely, new_client, with_auto_watch,
                     with_cache_size, with_chain_hash, with_chain_info,
                     with_full_chain_verification)
from .interface import Client, Result
from .optimizing import OptimizingClient
from .transports import GrpcTransport, HttpTransport
from .verify import VerifyingClient, verify_beacon_with_info

__all__ = [
    "Client", "Result", "new_client", "From", "with_chain_info",
    "with_chain_hash", "with_full_chain_verification", "with_cache_size",
    "with_auto_watch", "insecurely", "VerifyingClient", "CachingClient",
    "OptimizingClient", "WatchAggregator", "PollingWatcher",
    "GrpcTransport", "HttpTransport", "verify_beacon_with_info",
]
