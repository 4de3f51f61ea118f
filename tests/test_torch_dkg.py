"""The port's DKG and reshare state machine (drand_tpu_torch/crypto/dkg.py)
on its host paths, and across the wire with the JAX package's.

The scenarios of tests/test_dkg.py run on the port (default scheme, keys
on G1; every seam below ``dkg_device.MIN_N``, so the host loops): a fresh
5-of-3 DKG, a malicious dealer excluded, a complaint resolved by a
justification, a 5 -> 7 reshare keeping the key, a reshare with a leaving
node, too few dealers.  The group key is checked by Lagrange interpolation
of the shares at 0.  The interop cases carry bundles between the two
implementations with ``convert.dkg_wire``: a port node and a JAX-package
node with the same long-term secret must answer with the same statuses,
adopt the same shares and finish with the same commitment bytes, whichever
side dealt.  Device-routed nodes are in tests/test_torch_dkg_device_path.py.
"""

import pytest

from drand_tpu.crypto import dkg as JD
from drand_tpu.crypto import schemes as JS
from drand_tpu.crypto import schnorr as JSchnorr

from drand_tpu_torch import convert as CV
from drand_tpu_torch.crypto import schemes, schnorr
from drand_tpu_torch.crypto.dkg import (Deal, DkgConfig, DkgError, DkgNode,
                                        DistKeyGenerator, _encrypt_share)
from drand_tpu_torch.crypto.host import tbls as HT
from drand_tpu_torch.crypto.host.params import R

SCH = schemes.scheme_from_name(schemes.DEFAULT_SCHEME_ID)
JSCH = JS.scheme_from_name(JS.DEFAULT_SCHEME_ID)


def make_nodes(n, tag):
    secrets_, nodes = [], []
    for i in range(n):
        sec, pub = SCH.keypair(seed=f"{tag}-{i}".encode())
        secrets_.append(sec)
        nodes.append(DkgNode(index=i, public=SCH.public_bytes(pub)))
    return secrets_, nodes


def drive(gens, tamper_deals=None, drop_justs=frozenset()):
    """Run the full exchange synchronously; returns outputs by generator."""
    deals = [b for b in (g.generate_deals() for g in gens) if b is not None]
    if tamper_deals:
        deals = [tamper_deals(b) or b for b in deals]
    resps = [r for r in (g.process_deal_bundles(deals) for g in gens)
             if r is not None]
    outs, justs = [], []
    for g in gens:
        out, j = g.process_response_bundles(resps)
        outs.append(out)
        if j is not None and j.dealer_index not in drop_justs:
            justs.append(j)
    if all(o is not None for o in outs):
        return outs
    return [g.process_justification_bundles(justs) for g in gens]


def check_group_key(outs, threshold):
    """Every node holds the same public polynomial, every share matches
    it, and two different threshold subsets interpolate to the secret of
    commits[0]."""
    commits = outs[0].commits
    for o in outs:
        assert o.commits == commits, "nodes disagree on the public polynomial"
    g = SCH.key_group
    pub_poly = HT.PubPoly.from_bytes(g, b"".join(commits))
    holders = [o.share for o in outs if o.share is not None]
    for s in holders:
        assert g.curve.mul(g.curve.gen, s.value) == pub_poly.eval(s.index)
    for sub in (holders[:threshold], holders[-threshold:]):
        idx = [s.index for s in sub]
        secret = sum(HT._lagrange_coeff(idx, s.index) * s.value
                     for s in sub) % R
        assert g.to_bytes(g.curve.mul(g.curve.gen, secret)) == commits[0]
    return commits


@pytest.fixture(scope="module")
def fresh5():
    secs, nodes = make_nodes(5, "fresh")
    gens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=b"nonce-fresh",
        new_nodes=nodes, threshold=3)) for i in range(5)]
    return secs, nodes, drive(gens)


def test_fresh_dkg_5_of_3(fresh5):
    _, _, outs = fresh5
    assert all(o.qual == [0, 1, 2, 3, 4] for o in outs)
    check_group_key(outs, 3)


def test_malicious_dealer_excluded():
    """Dealer 4 sends a garbage share to holder 1 and never justifies: it
    drops out of QUAL and the remaining 4 dealers finish."""
    secs, nodes = make_nodes(5, "mal")
    gens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=b"nonce-mal",
        new_nodes=nodes, threshold=3)) for i in range(5)]

    def tamper(bundle):
        if bundle.dealer_index == 4:
            bad = _encrypt_share(SCH, secs[4], nodes[1].public, 4, 1,
                                 b"nonce-mal", 0xDEAD)
            bundle.deals = [d if d.share_index != 1 else Deal(1, bad)
                            for d in bundle.deals]
            bundle.signature = schnorr.sign(SCH.key_group, secs[4],
                                            bundle.hash(b"nonce-mal"))
        return bundle

    outs = drive(gens, tamper_deals=tamper, drop_justs={4})
    assert all(o.qual == [0, 1, 2, 3] for o in outs)
    check_group_key(outs, 3)


def test_complaint_resolved_by_justification():
    """A transit-corrupted deal triggers a complaint; the honest dealer's
    justification clears it and the complainer adopts the revealed share."""
    secs, nodes = make_nodes(4, "just")
    gens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=b"nonce-just",
        new_nodes=nodes, threshold=3)) for i in range(4)]

    def corrupt(bundle):
        if bundle.dealer_index == 2:
            bundle.deals = [d if d.share_index != 0 else Deal(0, bytes(64))
                            for d in bundle.deals]
            bundle.signature = schnorr.sign(SCH.key_group, secs[2],
                                            bundle.hash(b"nonce-just"))
        return bundle

    outs = drive(gens, tamper_deals=corrupt)
    assert all(o.qual == [0, 1, 2, 3] for o in outs)
    assert 2 in gens[0]._my_shares
    check_group_key(outs, 3)


def test_reshare_preserves_public_key(fresh5):
    """The 5-node group reshared to 7 nodes (5 old + 2 new), t 3 -> 4: the
    collective public key does not change and the new shares interpolate
    to it."""
    secs, nodes, outs = fresh5
    old_commits = outs[0].commits
    new_secs, extra = make_nodes(2, "new")
    new_nodes = nodes + [DkgNode(index=5 + i, public=extra[i].public)
                         for i in range(2)]
    all_secs = secs + new_secs
    regens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=all_secs[i], nonce=b"n1",
        new_nodes=new_nodes, threshold=4, old_nodes=nodes, old_threshold=3,
        share=outs[i].share if i < 5 else None,
        public_coeffs=old_commits)) for i in range(7)]
    reouts = drive(regens)
    assert reouts[0].commits[0] == old_commits[0], "collective key changed"
    check_group_key(reouts, 4)


def test_reshare_with_leaving_node(fresh5):
    """Old node 0 deals but is not in the new group: it finishes with
    share=None while the rest carry the chain forward at t = 2 of 4."""
    secs, nodes, outs = fresh5
    old_commits = outs[0].commits
    new_nodes = [DkgNode(index=i, public=nodes[i + 1].public)
                 for i in range(4)]
    regens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=b"l1", new_nodes=new_nodes,
        threshold=2, old_nodes=nodes, old_threshold=3, share=outs[i].share,
        public_coeffs=old_commits)) for i in range(5)]
    reouts = drive(regens)
    assert reouts[0].share is None          # node 0 left
    assert all(o.share is not None for o in reouts[1:])
    assert reouts[0].commits[0] == old_commits[0]
    check_group_key(reouts, 2)


def test_too_few_dealers_raises():
    secs, nodes = make_nodes(3, "few")
    gens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=b"f0",
        new_nodes=nodes, threshold=3)) for i in range(3)]
    deals = [g.generate_deals() for g in gens]
    # only one dealer's bundle arrives anywhere
    resps = [g.process_deal_bundles(deals[:1]) for g in gens]
    with pytest.raises(DkgError):
        for g in gens:
            g.process_response_bundles([r for r in resps if r])


def test_duplicate_dealer_bundles_first_wins():
    """An equivocating dealer sending two validly signed bundles in one
    batch: the first wins, and the stored bundle and the adopted share
    stay consistent."""
    secs, nodes = make_nodes(4, "dup")
    gens = [DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[i], nonce=b"d" * 32, new_nodes=nodes,
        threshold=3)) for i in range(4)]
    deals = [x.generate_deals() for x in gens]
    evil_twin = DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[0], nonce=b"d" * 32, new_nodes=nodes,
        threshold=3))
    second = evil_twin.generate_deals()     # another polynomial, valid sig
    g1 = gens[1]
    g1.process_deal_bundles(deals + [second])
    stored = g1._deal_bundles[0]
    assert stored.hash(b"d" * 32) == deals[0].hash(b"d" * 32)
    pub = HT.PubPoly.from_bytes(SCH.key_group, b"".join(stored.commits))
    c = SCH.key_group.curve
    assert c.mul(c.gen, g1._my_shares[0]) == pub.eval(1)


# ---------------------------------------------------------------------------
# interop: bundles across the two implementations
# ---------------------------------------------------------------------------

def _pair_run(dealer_side, n=4, thr=3):
    """`dealer_side` ("jax" or "port") makes every bundle; dealer 2's deal
    to holder 0 is transit-corrupted (re-signed) and dealer 3's commitment
    is changed after signing.  Holder 0 runs twice, as a port node and as
    a JAX-package node with the same long-term secret, each fed the
    bundles carried into its own classes.  Returns both holders' response
    statuses, adopted shares and outputs."""
    secs, nodes = make_nodes(n, f"interop-{dealer_side}")
    nonce = b"i" * 32
    if dealer_side == "jax":
        mk, cfg_cls, sch, sign = (JD.DistKeyGenerator, JD.DkgConfig, JSCH,
                                  JSchnorr.sign)
        dnodes = CV.dkg_wire(nodes, JD)
    else:
        mk, cfg_cls, sch, sign = DistKeyGenerator, DkgConfig, SCH, \
            schnorr.sign
        dnodes = nodes
    gens = [mk(cfg_cls(scheme=sch, longterm=secs[i], nonce=nonce,
                       new_nodes=dnodes, threshold=thr)) for i in range(n)]
    deals = [g.generate_deals() for g in gens]
    deals[2].deals = [type(d)(0, bytes(64)) if d.share_index == 0 else d
                      for d in deals[2].deals]
    deals[2].signature = sign(sch.key_group, secs[2], deals[2].hash(nonce))
    deals[3].commits[1] = deals[3].commits[0]
    resps = [g.process_deal_bundles(deals) for g in gens]
    got = [g.process_response_bundles(resps) for g in gens]
    justs = [j for _, j in got if j is not None]

    port0 = DistKeyGenerator(DkgConfig(
        scheme=SCH, longterm=secs[0], nonce=nonce, new_nodes=nodes,
        threshold=thr))
    jax0 = JD.DistKeyGenerator(JD.DkgConfig(
        scheme=JSCH, longterm=secs[0], nonce=nonce,
        new_nodes=CV.dkg_wire(nodes, JD), threshold=thr))
    out = {}
    for side, node, to in (("port", port0, None), ("jax", jax0, JD)):
        rb = node.process_deal_bundles(CV.dkg_wire(deals, to))
        o, j = node.process_response_bundles(CV.dkg_wire(resps, to))
        assert o is None and j is None      # dealer 2 still owes a reply
        o = node.process_justification_bundles(CV.dkg_wire(justs, to))
        out[side] = {"statuses": [(r.dealer_index, r.status)
                                  for r in rb.responses],
                     "shares": dict(node._my_shares), "qual": o.qual,
                     "commits": list(o.commits), "share": o.share,
                     "response": rb}
    # each holder's own response bundle verifies on the other side
    for side, other in (("port", JD), ("jax", None)):
        rb = CV.dkg_wire(out[side]["response"], other)
        check = (JSchnorr.verify if other is JD else schnorr.verify)
        group = (JSCH if other is JD else SCH).key_group
        assert check(group, nodes[0].public, rb.hash(nonce), rb.signature)
    return out


@pytest.mark.parametrize("dealer_side", ["jax", "port"])
def test_interop_bundles_cross_both_ways(dealer_side):
    out = _pair_run(dealer_side)
    port, jax = out["port"], out["jax"]
    assert port["statuses"] == jax["statuses"] == [(0, 0), (1, 0), (2, 1),
                                                   (3, 1)]
    assert port["shares"] == jax["shares"]
    assert set(port["shares"]) == {0, 1, 2}     # dealer 2's by its reply
    assert port["qual"] == jax["qual"] == [0, 1, 2]
    assert port["commits"] == jax["commits"]
    assert (port["share"].index, port["share"].value) == \
        (jax["share"].index, jax["share"].value)
    assert CV.dkg_wire(port["share"], JD) == jax["share"]
