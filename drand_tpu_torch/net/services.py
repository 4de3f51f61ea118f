"""The three drand service specs (wire-path compatible with the reference).

  Protocol — node-to-node plane (protobuf/drand/protocol.proto:17-37)
  Public   — public API plane   (protobuf/drand/api.proto:16-28)
  Control  — localhost CLI<->daemon plane (protobuf/drand/control.proto:15-56)

The port's copy of drand_tpu/net/services.py, unchanged but for its imports.
"""

from ..protos import drand_pb2 as pb
from .rpc import Method, ServiceSpec

PROTOCOL = ServiceSpec("drand.Protocol", [
    Method("GetIdentity", pb.IdentityRequest, pb.IdentityResponse),
    Method("SignalDKGParticipant", pb.SignalDKGPacket, pb.Empty),
    Method("PushDKGInfo", pb.DKGInfoPacket, pb.Empty),
    Method("BroadcastDKG", pb.DKGPacket, pb.Empty),
    Method("PartialBeacon", pb.PartialBeaconPacket, pb.Empty),
    # Handel overlay (beacon/handel.py): one candidate aggregate for a
    # tree level.  Rides the Protocol plane, so net/admission.py's
    # classify_method already treats it as critical-class — aggregation
    # traffic is never shed behind public reads.
    Method("HandelAggregate", pb.HandelAggregatePacket, pb.Empty),
    Method("SyncChain", pb.SyncRequest, pb.BeaconPacket, server_stream=True),
    Method("Status", pb.StatusRequest, pb.StatusResponse),
    # Federation: GroupMetrics snapshot over the node-to-node plane
    # (reference serves HTTP-over-gRPC instead: net/listener.go:88).
    Method("Metrics", pb.MetricsRequest, pb.MetricsResponse),
])

PUBLIC = ServiceSpec("drand.Public", [
    Method("PublicRand", pb.PublicRandRequest, pb.PublicRandResponse),
    Method("PublicRandStream", pb.PublicRandRequest, pb.PublicRandResponse,
           server_stream=True),
    Method("ChainInfo", pb.ChainInfoRequest, pb.ChainInfoPacket),
    Method("Home", pb.HomeRequest, pb.HomeResponse),
])

# Relay gossip overlay (lp2p gossipsub equivalent; the gossip relay is not ported yet)
GOSSIP = ServiceSpec("drand.Gossip", [
    Method("Publish", pb.GossipBeaconPacket, pb.Empty),
])

CONTROL = ServiceSpec("drand.Control", [
    Method("PingPong", pb.Ping, pb.Pong),
    Method("Status", pb.StatusRequest, pb.StatusResponse),
    Method("ListSchemes", pb.ListSchemesRequest, pb.ListSchemesResponse),
    Method("ListBeaconIDs", pb.ListBeaconIDsRequest, pb.ListBeaconIDsResponse),
    Method("InitDKG", pb.InitDKGPacket, pb.GroupPacket),
    Method("InitReshare", pb.InitResharePacket, pb.GroupPacket),
    Method("PublicKey", pb.PublicKeyRequest, pb.PublicKeyResponse),
    Method("PrivateKey", pb.PrivateKeyRequest, pb.PrivateKeyResponse),
    Method("ChainInfo", pb.ChainInfoRequest, pb.ChainInfoPacket),
    Method("GroupFile", pb.GroupRequest, pb.GroupPacket),
    Method("Shutdown", pb.ShutdownRequest, pb.ShutdownResponse),
    Method("LoadBeacon", pb.LoadBeaconRequest, pb.LoadBeaconResponse),
    Method("StartFollowChain", pb.StartSyncRequest, pb.SyncProgress,
           server_stream=True),
    Method("StartCheckChain", pb.StartSyncRequest, pb.SyncProgress,
           server_stream=True),
    Method("BackupDatabase", pb.BackupDBRequest, pb.BackupDBResponse),
    Method("RemoteStatus", pb.RemoteStatusRequest, pb.RemoteStatusResponse),
    # Multi-tenant serving (core/tenancy.py): tenant
    # add/update/remove without a daemon restart.  Control plane only —
    # tenancy is operator configuration, never a peer-reachable surface.
    Method("TenantSet", pb.TenantConfigPacket, pb.TenantListResponse),
    Method("TenantRemove", pb.TenantRequest, pb.TenantListResponse),
    Method("TenantList", pb.TenantRequest, pb.TenantListResponse),
    # Tenant tokens (core/authz.py): macaroon mint/revoke.
    # Control plane only — the root key never leaves the daemon, and the
    # minted token string is returned exactly once.
    Method("TokenMint", pb.TokenMintRequest, pb.TokenMintResponse),
    Method("TokenRevoke", pb.TokenRequest, pb.TokenListResponse),
    Method("TokenList", pb.TokenRequest, pb.TokenListResponse),
])
