"""Client assembly (reference: client/client.go:21-345, makeClient :48-111).

    client = new_client(
        From(GrpcTransport("127.0.0.1:4444")),
        with_chain_info(info),          # or with_chain_hash("...")
        with_full_chain_verification(),
        with_cache_size(32),
        with_auto_watch(),
    )

Decorator order (outermost first): watch aggregator -> cache ->
optimizing -> verifying(per source) -> transport, exactly the reference
pipeline.

The port's copy of drand_tpu/client/client.py, unchanged.
"""

from typing import List, Optional

from ..chain.info import Info
from .aggregator import WatchAggregator
from .cache import CachingClient
from .interface import Client, Result
from .optimizing import OptimizingClient
from .verify import VerifyingClient


class _Options:
    def __init__(self):
        self.sources: List[Client] = []
        self.info: Optional[Info] = None
        self.chain_hash: str = ""
        self.strict: bool = False
        self.cache_size: int = 32
        self.auto_watch: bool = False
        self.skip_verify: bool = False


def From(*sources: Client):
    def opt(o: _Options):
        o.sources.extend(sources)
    return opt


def with_chain_info(info: Info):
    def opt(o: _Options):
        o.info = info
    return opt


def with_chain_hash(hash_hex: str):
    def opt(o: _Options):
        o.chain_hash = hash_hex
    return opt


def with_full_chain_verification():
    def opt(o: _Options):
        o.strict = True
    return opt


def with_cache_size(n: int):
    def opt(o: _Options):
        o.cache_size = n
    return opt


def with_auto_watch():
    def opt(o: _Options):
        o.auto_watch = True
    return opt


def insecurely():
    """Skip verification (reference: client.Insecurely) — test/dev only."""
    def opt(o: _Options):
        o.skip_verify = True
    return opt


def new_client(*options) -> Client:
    o = _Options()
    for opt in options:
        opt(o)
    if not o.sources:
        raise ValueError("client needs at least one source (From(...))")

    # pin the root of trust: explicit info wins; else a chain hash is
    # checked against whatever the sources serve (client.go:279-316)
    info = o.info
    if info is None and o.chain_hash:
        for src in o.sources:
            try:
                candidate = src.info()
            except Exception:
                continue
            if candidate.hash_string() == o.chain_hash:
                info = candidate
                break
        if info is None:
            raise ValueError("no source matched the pinned chain hash")

    sources = o.sources
    if not o.skip_verify:
        sources = [VerifyingClient(s, info=info, strict=o.strict)
                   for s in sources]
    inner: Client = (sources[0] if len(sources) == 1
                     else OptimizingClient(sources))
    if isinstance(inner, OptimizingClient):
        inner.start_speed_tests()
    inner = CachingClient(inner, o.cache_size)
    return WatchAggregator(inner, auto_watch=o.auto_watch)


__all__ = ["new_client", "From", "with_chain_info", "with_chain_hash",
           "with_full_chain_verification", "with_cache_size",
           "with_auto_watch", "insecurely", "Client", "Result"]
