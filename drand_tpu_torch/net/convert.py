"""proto <-> domain codecs (reference: chain/beacon/convert.go:9-24,
key/group.go:371-486, core/drand_beacon_control.go packet plumbing).

The port's copy of drand_tpu/net/convert.py, unchanged but for its imports.
"""

from typing import Optional

from ..chain.beacon import Beacon
from ..chain.info import Info
from ..crypto import dkg as D
from ..crypto.schemes import get_scheme_by_id_with_default
from ..key.group import Group, Node
from ..key.keys import DistPublic, Identity
from ..protos import drand_pb2 as pb

def _version_from_env() -> pb.NodeVersion:
    """Advertised protocol version; DRAND_NODE_VERSION=maj.min.patch
    overrides (mixed-version rollout testing, demo/regression/main.go)."""
    import os
    raw = os.environ.get("DRAND_NODE_VERSION", "")
    if raw:
        try:
            maj, mino, pat = (int(x) for x in raw.split("."))
            return pb.NodeVersion(major=maj, minor=mino, patch=pat)
        except ValueError:
            pass
    return pb.NodeVersion(major=2, minor=0, patch=0)


VERSION = _version_from_env()


def metadata(beacon_id: str = "", chain_hash: bytes = b"") -> pb.Metadata:
    return pb.Metadata(node_version=VERSION, beaconID=beacon_id or "default",
                       chain_hash=chain_hash)


def version_compatible(md) -> bool:
    """Reject peers with an incompatible protocol major version
    (core/drand_daemon_interceptors.go:19-89; a zero version — legacy or
    absent metadata — is accepted like the reference's prerelease rule)."""
    if md is None or not md.HasField("node_version"):
        return True
    v = md.node_version
    if v.major == 0 and v.minor == 0:
        return True
    return v.major == VERSION.major


# -- beacons ----------------------------------------------------------------

def beacon_to_proto(b: Beacon, beacon_id: str = "") -> pb.BeaconPacket:
    return pb.BeaconPacket(previous_signature=b.previous_sig or b"",
                           round=b.round, signature=b.signature,
                           metadata=metadata(beacon_id))


def proto_to_beacon(p: pb.BeaconPacket) -> Beacon:
    return Beacon(round=p.round, signature=p.signature,
                  previous_sig=p.previous_signature or None)


def beacon_to_rand(b: Beacon, beacon_id: str = "") -> pb.PublicRandResponse:
    return pb.PublicRandResponse(
        round=b.round, signature=b.signature,
        previous_signature=b.previous_sig or b"",
        randomness=b.randomness(), metadata=metadata(beacon_id))


def rand_to_beacon(p: pb.PublicRandResponse) -> Beacon:
    return Beacon(round=p.round, signature=p.signature,
                  previous_sig=p.previous_signature or None)


# -- identities -------------------------------------------------------------

def identity_to_proto(ident: Identity) -> pb.Identity:
    return pb.Identity(address=ident.addr, key=ident.key, tls=ident.tls,
                       signature=ident.signature or b"")


def proto_to_identity(p, scheme) -> Identity:
    return Identity(key=p.key, addr=p.address, scheme=scheme, tls=p.tls,
                    signature=p.signature or None)


# -- groups -----------------------------------------------------------------

def group_to_proto(g: Group, beacon_id: str = "") -> pb.GroupPacket:
    pkt = pb.GroupPacket(
        threshold=g.threshold, period=g.period,
        genesis_time=g.genesis_time, transition_time=max(g.transition_time, 0),
        genesis_seed=g.get_genesis_seed(),
        catchup_period=g.catchup_period, schemeID=g.scheme.id,
        metadata=metadata(beacon_id or g.beacon_id))
    for n in g.nodes:
        pkt.nodes.append(pb.GroupNode(public=identity_to_proto(n.identity),
                                      index=n.index))
    if g.public_key is not None:
        pkt.dist_key.extend(g.public_key.coefficients)
    return pkt


def proto_to_group(p: pb.GroupPacket) -> Group:
    scheme = get_scheme_by_id_with_default(p.schemeID)
    nodes = [Node(identity=proto_to_identity(gn.public, scheme),
                  index=gn.index) for gn in p.nodes]
    pk = DistPublic(list(p.dist_key)) if p.dist_key else None
    beacon_id = p.metadata.beaconID if p.HasField("metadata") else ""
    return Group(
        threshold=p.threshold, period=p.period, scheme=scheme, nodes=nodes,
        genesis_time=p.genesis_time, beacon_id=beacon_id,
        catchup_period=p.catchup_period,
        genesis_seed=p.genesis_seed or None,
        transition_time=p.transition_time, public_key=pk)


# -- chain info -------------------------------------------------------------

def info_to_proto(info: Info) -> pb.ChainInfoPacket:
    return pb.ChainInfoPacket(
        public_key=info.public_key, period=info.period,
        genesis_time=info.genesis_time, hash=info.hash(),
        group_hash=info.genesis_seed, schemeID=info.scheme,
        metadata=metadata(info.beacon_id))


def proto_to_info(p: pb.ChainInfoPacket) -> Info:
    info = Info(public_key=p.public_key, period=p.period,
                genesis_time=p.genesis_time, genesis_seed=p.group_hash,
                scheme=p.schemeID,
                beacon_id=p.metadata.beaconID if p.HasField("metadata") else "")
    if p.hash and p.hash != info.hash():
        raise ValueError("chain info hash mismatch")
    return info


# -- DKG bundles ------------------------------------------------------------

def dkg_bundle_to_proto(bundle, beacon_id: str = "") -> pb.DKGBundle:
    out = pb.DKGBundle(metadata=metadata(beacon_id))
    if isinstance(bundle, D.DealBundle):
        db = out.deal
        db.dealer_index = bundle.dealer_index
        db.commits.extend(bundle.commits)
        for d in bundle.deals:
            db.deals.append(pb.DealShare(share_index=d.share_index,
                                         encrypted_share=d.encrypted))
        db.session_id, db.signature = bundle.session_id, bundle.signature
    elif isinstance(bundle, D.ResponseBundle):
        rb = out.response
        rb.share_index = bundle.share_index
        for r in bundle.responses:
            rb.responses.append(pb.DealerStatus(
                dealer_index=r.dealer_index,
                status=(r.status == D.STATUS_SUCCESS)))
        rb.session_id, rb.signature = bundle.session_id, bundle.signature
    elif isinstance(bundle, D.JustificationBundle):
        jb = out.justification
        jb.dealer_index = bundle.dealer_index
        for j in bundle.justifications:
            jb.justifications.append(pb.JustificationShare(
                share_index=j.share_index,
                share=j.share.to_bytes(32, "big")))
        jb.session_id, jb.signature = bundle.session_id, bundle.signature
    else:
        raise TypeError(f"not a DKG bundle: {type(bundle)}")
    return out


def proto_to_dkg_bundle(p: pb.DKGBundle):
    which = p.WhichOneof("bundle")
    if which == "deal":
        db = p.deal
        return D.DealBundle(
            dealer_index=db.dealer_index, commits=list(db.commits),
            deals=[D.Deal(share_index=d.share_index,
                          encrypted=d.encrypted_share) for d in db.deals],
            session_id=db.session_id, signature=db.signature)
    if which == "response":
        rb = p.response
        return D.ResponseBundle(
            share_index=rb.share_index,
            responses=[D.Response(
                dealer_index=r.dealer_index,
                status=D.STATUS_SUCCESS if r.status else D.STATUS_COMPLAINT)
                for r in rb.responses],
            session_id=rb.session_id, signature=rb.signature)
    if which == "justification":
        jb = p.justification
        return D.JustificationBundle(
            dealer_index=jb.dealer_index,
            justifications=[D.Justification(
                share_index=j.share_index,
                share=int.from_bytes(j.share, "big"))
                for j in jb.justifications],
            session_id=jb.session_id, signature=jb.signature)
    raise ValueError("empty DKG bundle")
