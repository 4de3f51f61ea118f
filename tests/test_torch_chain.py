"""The port's chain core (drand_tpu_torch/chain/): beacon codec, chain info,
round math and the storage matrix.

The cases of tests/test_chain.py run here against the port: each is rebuilt
over the reference module's globals with the chain's names swapped for the
port's (tests/torch_service_cases.py), so the case's body runs as written.
The storage cases run over the port's engines: memdb, sqlite, and sqlite
with `require_previous`.  The postgres engine is not ported, so its cases
stay with the reference.  Then the same store contents written through
both packages read back alike.
"""

import hashlib

import pytest

import test_chain as ref_chain
from torch_service_cases import port_cases

from drand_tpu import chain as ref
from drand_tpu_torch import chain as C

NAMES = {name: getattr(C, name) for name in (
    "Beacon", "ErrMissingPrevious", "ErrNoBeaconSaved", "ErrNoBeaconStored",
    "Info", "MemDBStore", "SqliteStore", "TIME_OF_ROUND_ERROR",
    "bytes_to_round", "current_round", "genesis_beacon", "next_round",
    "round_to_bytes", "time_of_round")}
POSTGRES = ("test_postgres_previous_reconstruction",
            "test_postgres_beacon_id_isolation", "test_postgres_store_gated",
            "test_pg_dialect_guards")
CASES = port_cases(ref_chain, NAMES, skip=POSTGRES)
STORE_CASES = [(n, fn) for n, fn in CASES
               if "store" in fn.__code__.co_varnames[
                   :fn.__code__.co_argcount]]
OTHER_CASES = [(n, fn) for n, fn in CASES if (n, fn) not in STORE_CASES]


@pytest.fixture(params=["memdb", "sqlite", "sqlite-prev"])
def store(request, tmp_path):
    """The reference's storage matrix over the port's engines."""
    if request.param == "memdb":
        s = C.MemDBStore(buffer_size=100)
    else:
        s = C.SqliteStore(str(tmp_path / "chain.db"),
                          require_previous=request.param.endswith("prev"))
    yield s
    s.close()


@pytest.mark.parametrize("case", [fn for _, fn in STORE_CASES],
                         ids=[n for n, _ in STORE_CASES])
def test_reference_store_case(case, store):
    case(store=store)


@pytest.mark.parametrize("case", [fn for _, fn in OTHER_CASES],
                         ids=[n for n, _ in OTHER_CASES])
def test_reference_case(case, request):
    params = case.__code__.co_varnames[:case.__code__.co_argcount]
    case(**{p: request.getfixturevalue(p) for p in params})


def _chain(cls, n):
    prev, out = None, []
    for r in range(n):
        sig = hashlib.sha256(b"sig%d" % r).digest() + bytes([r]) * 16
        out.append(cls(round=r, signature=sig, previous_sig=prev))
        prev = sig
    return out


@pytest.mark.parametrize("engine", ["memdb", "sqlite", "sqlite-prev"])
def test_same_contents_read_back_alike(engine, tmp_path):
    """One chain with a hole and a tombstone, written through the
    reference's engine and the port's: every read (cursor walk, get, last,
    the tombstoned bytes, the hexjson backup) gives the same bytes."""
    stores = []
    for pkg, tag in ((ref, "ref"), (C, "port")):
        if engine == "memdb":
            s = pkg.MemDBStore(buffer_size=100)
        else:
            s = pkg.SqliteStore(str(tmp_path / f"{tag}.db"),
                                require_previous=engine.endswith("prev"))
        s.put_many([b for b in _chain(pkg.Beacon, 12) if b.round != 6])
        assert s.tombstone(9) is True
        stores.append(s)

    def view(s):
        walk = []
        try:
            for b in s.cursor():
                walk.append((b.round, b.signature, b.previous_sig))
        except Exception as e:              # noqa: BLE001 — compared by name
            walk.append(type(e).__name__)   # a strict store's hole
        got = {}
        for r in (1, 5, 8, 10):
            try:
                b = s.get(r)
                got[r] = (b.signature, b.previous_sig)
            except Exception as e:          # noqa: BLE001 — compared by name
                got[r] = type(e).__name__
        last = s.last()
        tomb = s.tombstoned(9)
        return (walk, got, (last.round, last.signature),
                tomb.signature if tomb else None, len(s))

    assert view(stores[0]) == view(stores[1])
    for s in stores:
        s.close()


def test_beacon_codec_and_info_hash_agree_with_the_reference():
    b = dict(round=7, signature=b"\x01" * 48, previous_sig=b"\x02" * 96)
    assert C.Beacon(**b).to_json() == ref.Beacon(**b).to_json()
    assert C.Beacon.from_json(ref.Beacon(**b).to_json()) == C.Beacon(**b)
    assert C.Beacon(**b).randomness() == ref.Beacon(**b).randomness()
    info = dict(public_key=b"\x03" * 48, period=3, genesis_time=1_692_803_367,
                genesis_seed=b"\x04" * 32, scheme="bls-unchained-on-g1",
                beacon_id="quicknet")
    assert C.Info(**info).hash() == ref.Info(**info).hash()
    assert C.Info(**info).to_json() == ref.Info(**info).to_json()
