"""The port's DKG state machine with its device seams taken
(drand_tpu_torch/crypto/dkg.py -> crypto/dkg_device.py).

One node of a ceremony runs with ``dkg_device.MIN_N`` lowered and
``DkgConfig.device="cpu"`` (K6's plain version; each 256-bit plain ladder
costs seconds here), the others on the host loops: the device-routed node
must answer, adopt and finish exactly as a host-routed twin with the same
long-term secret (tests/test_dkg_device.py's full-session cases).  The
reshare case takes all three seams on that node: the constant-term pin
rejects a key-change attempt, the shares are checked, and the weighted
combine keeps the collective key byte for byte.
"""

import secrets

import pytest
import torch

from drand_tpu_torch.crypto import dkg as D
from drand_tpu_torch.crypto import dkg_device as DD
from drand_tpu_torch.crypto import schemes
from drand_tpu_torch.crypto.host import tbls as HT

SCH = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _session(n, thr, nonce, device_node=None, **kw):
    """Generators of one session; `device_node` gets device="cpu"."""
    g = SCH.key_group
    secs = kw.pop("secs", None) or [secrets.randbelow(1 << 200)
                                    for _ in range(n)]
    nodes = kw.pop("nodes", None) or [
        D.DkgNode(i, g.to_bytes(g.curve.mul(g.curve.gen, s)))
        for i, s in enumerate(secs)]
    shares = kw.pop("shares", None)
    gens = [D.DistKeyGenerator(D.DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=nonce, new_nodes=nodes,
        threshold=thr, device="cpu" if i == device_node else None,
        share=shares[i] if shares else None, **kw)) for i in range(n)]
    return secs, nodes, gens


def _on_device(gen, call, monkeypatch):
    """Run one generator's call with every seam routed to the device."""
    with monkeypatch.context() as mp:
        mp.setattr(DD, "MIN_N", 2)
        before = DD.dispatch_count()
        out = call(gen)
        return out, DD.dispatch_count() - before


def test_fresh_dkg_device_node_matches_host(monkeypatch):
    """Dealer 3's deal to holder 0 is garbage (signature broken) and
    dealer 4's commitment changed after signing: holder 0, routed to the
    device, complains about both exactly as its host twin does, adopts
    the same shares, and finishes with the same commitments."""
    n, thr = 5, 3
    secs, nodes, gens = _session(n, thr, b"n" * 32, device_node=0)
    deals = [x.generate_deals() for x in gens]
    deals[3].deals[0].encrypted = bytes(64)
    deals[4].commits[1] = deals[4].commits[0]
    r0, disp = _on_device(gens[0], lambda g: g.process_deal_bundles(deals),
                          monkeypatch)
    assert disp == 1                        # one verify_shares
    resps = [r0] + [x.process_deal_bundles(deals) for x in gens[1:]]
    st0 = {r.dealer_index: r.status for r in r0.responses}
    assert st0[3] == D.STATUS_COMPLAINT and st0[4] == D.STATUS_COMPLAINT
    _, _, (twin,) = _session(1, thr, b"n" * 32, secs=secs[:1], nodes=nodes)
    twin_resp = twin.process_deal_bundles(deals)
    assert {r.dealer_index: r.status for r in twin_resp.responses} == st0
    assert twin._my_shares == gens[0]._my_shares
    (out0, just0), disp = _on_device(
        gens[0], lambda g: g.process_response_bundles(resps), monkeypatch)
    assert disp == 1 and just0 is None      # one plain combine
    outs = [out0] + [x.process_response_bundles(resps)[0] for x in gens[1:]]
    assert all(o.commits == out0.commits and o.qual == [0, 1, 2]
               for o in outs)


def test_reshare_device_node_pins_and_keeps_key(monkeypatch):
    """A reshare whose node 0 takes all three seams: dealer 2 deals a
    polynomial whose constant term is not its old share, the pin rejects
    it on every node, and node 0's weighted combine ends on the host
    nodes' commitments, the collective key unchanged."""
    n, thr = 5, 3
    secs, nodes, gens = _session(n, thr, b"f" * 32)
    deals = [x.generate_deals() for x in gens]
    resps = [x.process_deal_bundles(deals) for x in gens]
    outs = [x.process_response_bundles(resps)[0] for x in gens]
    pk = outs[0].public_key()
    reshare = dict(old_nodes=nodes, old_threshold=thr,
                   public_coeffs=list(outs[0].commits))
    _, _, rgens = _session(n, thr, b"r" * 32, device_node=0, secs=secs,
                           nodes=nodes, shares=[o.share for o in outs],
                           **reshare)
    rdeals = [x.generate_deals() for x in rgens]
    _, _, (evil,) = _session(1, thr, b"r" * 32, secs=secs[2:3],
                             nodes=nodes, shares=[HT.PriShare(2, 123456789)],
                             **reshare)
    rdeals[2] = evil.generate_deals()
    r0, disp = _on_device(rgens[0], lambda g: g.process_deal_bundles(rdeals),
                          monkeypatch)
    assert disp == 2                        # the pin and verify_shares
    rresps = [r0] + [x.process_deal_bundles(rdeals) for x in rgens[1:]]
    assert all(2 not in x._valid_dealers for x in rgens), \
        "constant-term pin missed a key-change attempt"
    (rout0, _), disp = _on_device(
        rgens[0], lambda g: g.process_response_bundles(rresps), monkeypatch)
    assert disp == 1                        # the weighted combine
    routs = [rout0] + [x.process_response_bundles(rresps)[0]
                       for x in rgens[1:]]
    assert all(o.commits == rout0.commits for o in routs)
    assert {o.public_key() for o in routs} == {pk}, "collective key drifted"
