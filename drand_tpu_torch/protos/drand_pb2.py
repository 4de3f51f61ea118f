# -*- coding: utf-8 -*-
# Generated protocol buffer code (drand_tpu/protos/gen.py, or the
# in-repo descriptor appender when protoc is unavailable).  DO NOT EDIT!
# source: drand.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bdrand.proto\x12\x05drand":\n\x0bNodeVersion\x12\r\n\x05major\x18\x01 \x01(\r\x12\r\n\x05minor\x18\x02 \x01(\r\x12\r\n\x05patch\x18\x03 \x01(\r"Z\n\x08Metadata\x12(\n\x0cnode_version\x18\x01 \x01(\x0b2\x12.drand.NodeVersion\x12\x10\n\x08beaconID\x18\x02 \x01(\t\x12\x12\n\nchain_hash\x18\x03 \x01(\x0c"*\n\x05Empty\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"H\n\x08Identity\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\x0b\n\x03tls\x18\x03 \x01(\x08\x12\x11\n\tsignature\x18\x04 \x01(\x0c";\n\tGroupNode\x12\x1f\n\x06public\x18\x01 \x01(\x0b2\x0f.drand.Identity\x12\r\n\x05index\x18\x02 \x01(\r"\xf5\x01\n\x0bGroupPacket\x12\x1f\n\x05nodes\x18\x01 \x03(\x0b2\x10.drand.GroupNode\x12\x11\n\tthreshold\x18\x02 \x01(\r\x12\x0e\n\x06period\x18\x03 \x01(\r\x12\x14\n\x0cgenesis_time\x18\x04 \x01(\x04\x12\x17\n\x0ftransition_time\x18\x05 \x01(\x04\x12\x14\n\x0cgenesis_seed\x18\x06 \x01(\x0c\x12\x10\n\x08dist_key\x18\x07 \x03(\x0c\x12\x16\n\x0ecatchup_period\x18\x08 \x01(\r\x12\x10\n\x08schemeID\x18\t \x01(\t\x12!\n\x08metadata\x18\n \x01(\x0b2\x0f.drand.Metadata"4\n\x0fIdentityRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"\x87\x01\n\x10IdentityResponse\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\x0b\n\x03tls\x18\x03 \x01(\x08\x12\x11\n\tsignature\x18\x04 \x01(\x0c\x12!\n\x08metadata\x18\x05 \x01(\x0b2\x0f.drand.Metadata\x12\x12\n\nschemeName\x18\x06 \x01(\t"\x86\x01\n\x0fSignalDKGPacket\x12\x1d\n\x04node\x18\x01 \x01(\x0b2\x0f.drand.Identity\x12\x14\n\x0csecret_proof\x18\x02 \x01(\x0c\x12\x1b\n\x13previous_group_hash\x18\x03 \x01(\x0c\x12!\n\x08metadata\x18\x04 \x01(\x0b2\x0f.drand.Metadata"\xb1\x01\n\rDKGInfoPacket\x12%\n\tnew_group\x18\x01 \x01(\x0b2\x12.drand.GroupPacket\x12\x14\n\x0csecret_proof\x18\x02 \x01(\x0c\x12\x13\n\x0bdkg_timeout\x18\x03 \x01(\r\x12\x11\n\tsignature\x18\x04 \x01(\x0c\x12!\n\x08metadata\x18\x05 \x01(\x0b2\x0f.drand.Metadata\x12\x18\n\x10kickoff_grace_ms\x18\x06 \x01(\r"x\n\x13PartialBeaconPacket\x12\r\n\x05round\x18\x01 \x01(\x04\x12\x1a\n\x12previous_signature\x18\x02 \x01(\x0c\x12\x13\n\x0bpartial_sig\x18\x03 \x01(\x0c\x12!\n\x08metadata\x18\x04 \x01(\x0b2\x0f.drand.Metadata"9\n\tDealShare\x12\x13\n\x0bshare_index\x18\x01 \x01(\r\x12\x17\n\x0fencrypted_share\x18\x02 \x01(\x0c"{\n\nDealBundle\x12\x14\n\x0cdealer_index\x18\x01 \x01(\r\x12\x0f\n\x07commits\x18\x02 \x03(\x0c\x12\x1f\n\x05deals\x18\x03 \x03(\x0b2\x10.drand.DealShare\x12\x12\n\nsession_id\x18\x04 \x01(\x0c\x12\x11\n\tsignature\x18\x05 \x01(\x0c"4\n\x0cDealerStatus\x12\x14\n\x0cdealer_index\x18\x01 \x01(\r\x12\x0e\n\x06status\x18\x02 \x01(\x08"t\n\x0eResponseBundle\x12\x13\n\x0bshare_index\x18\x01 \x01(\r\x12&\n\tresponses\x18\x02 \x03(\x0b2\x13.drand.DealerStatus\x12\x12\n\nsession_id\x18\x03 \x01(\x0c\x12\x11\n\tsignature\x18\x04 \x01(\x0c"8\n\x12JustificationShare\x12\x13\n\x0bshare_index\x18\x01 \x01(\r\x12\r\n\x05share\x18\x02 \x01(\x0c"\x85\x01\n\x13JustificationBundle\x12\x14\n\x0cdealer_index\x18\x01 \x01(\r\x121\n\x0ejustifications\x18\x02 \x03(\x0b2\x19.drand.JustificationShare\x12\x12\n\nsession_id\x18\x03 \x01(\x0c\x12\x11\n\tsignature\x18\x04 \x01(\x0c"\xbb\x01\n\tDKGBundle\x12!\n\x04deal\x18\x01 \x01(\x0b2\x11.drand.DealBundleH\x00\x12)\n\x08response\x18\x02 \x01(\x0b2\x15.drand.ResponseBundleH\x00\x123\n\rjustification\x18\x03 \x01(\x0b2\x1a.drand.JustificationBundleH\x00\x12!\n\x08metadata\x18\x04 \x01(\x0b2\x0f.drand.MetadataB\x08\n\x06bundle"M\n\tDKGPacket\x12\x1d\n\x03dkg\x18\x01 \x01(\x0b2\x10.drand.DKGBundle\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"D\n\x0bSyncRequest\x12\x12\n\nfrom_round\x18\x01 \x01(\x04\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"o\n\x0cBeaconPacket\x12\x1a\n\x12previous_signature\x18\x01 \x01(\x0c\x12\r\n\x05round\x18\x02 \x01(\x04\x12\x11\n\tsignature\x18\x03 \x01(\x0c\x12!\n\x08metadata\x18\x04 \x01(\x0b2\x0f.drand.Metadata"E\n\x11PublicRandRequest\x12\r\n\x05round\x18\x01 \x01(\x04\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"\x89\x01\n\x12PublicRandResponse\x12\r\n\x05round\x18\x01 \x01(\x04\x12\x11\n\tsignature\x18\x02 \x01(\x0c\x12\x1a\n\x12previous_signature\x18\x03 \x01(\x0c\x12\x12\n\nrandomness\x18\x04 \x01(\x0c\x12!\n\x08metadata\x18\x05 \x01(\x0b2\x0f.drand.Metadata"5\n\x10ChainInfoRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"\xa2\x01\n\x0fChainInfoPacket\x12\x12\n\npublic_key\x18\x01 \x01(\x0c\x12\x0e\n\x06period\x18\x02 \x01(\r\x12\x14\n\x0cgenesis_time\x18\x03 \x01(\x03\x12\x0c\n\x04hash\x18\x04 \x01(\x0c\x12\x12\n\ngroup_hash\x18\x05 \x01(\x0c\x12\x10\n\x08schemeID\x18\x06 \x01(\t\x12!\n\x08metadata\x18\x07 \x01(\x0b2\x0f.drand.Metadata"0\n\x0bHomeRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"A\n\x0cHomeResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"-\n\rStatusAddress\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\x0b\n\x03tls\x18\x02 \x01(\x08"\\\n\rStatusRequest\x12(\n\ncheck_conn\x18\x01 \x03(\x0b2\x14.drand.StatusAddress\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"\x1f\n\rDkgStatusPart\x12\x0e\n\x06status\x18\x01 \x01(\r"r\n\x10BeaconStatusPart\x12\x0e\n\x06status\x18\x01 \x01(\r\x12\x12\n\nis_running\x18\x02 \x01(\x08\x12\x12\n\nis_stopped\x18\x03 \x01(\x08\x12\x12\n\nis_started\x18\x04 \x01(\x08\x12\x12\n\nis_serving\x18\x05 \x01(\x08"L\n\x14ChainStoreStatusPart\x12\x10\n\x08is_empty\x18\x01 \x01(\x08\x12\x12\n\nlast_round\x18\x02 \x01(\x04\x12\x0e\n\x06length\x18\x03 \x01(\x04"\xa6\x02\n\x0eStatusResponse\x12!\n\x03dkg\x18\x01 \x01(\x0b2\x14.drand.DkgStatusPart\x12%\n\x07reshare\x18\x02 \x01(\x0b2\x14.drand.DkgStatusPart\x12\'\n\x06beacon\x18\x03 \x01(\x0b2\x17.drand.BeaconStatusPart\x120\n\x0bchain_store\x18\x04 \x01(\x0b2\x1b.drand.ChainStoreStatusPart\x12;\n\x0bconnections\x18\x05 \x03(\x0b2&.drand.StatusResponse.ConnectionsEntry\x1a2\n\x10ConnectionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x08:\x028\x01")\n\x04Ping\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata")\n\x04Pong\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"\x8d\x01\n\tSetupInfo\x12\x0e\n\x06leader\x18\x01 \x01(\x08\x12\x16\n\x0eleader_address\x18\x02 \x01(\t\x12\r\n\x05nodes\x18\x03 \x01(\r\x12\x11\n\tthreshold\x18\x04 \x01(\r\x12\x17\n\x0ftimeout_seconds\x18\x05 \x01(\r\x12\x0e\n\x06secret\x18\x06 \x01(\x0c\x12\r\n\x05force\x18\x07 \x01(\r"\xa3\x01\n\rInitDKGPacket\x12\x1e\n\x04info\x18\x01 \x01(\x0b2\x10.drand.SetupInfo\x12\x1d\n\x15beacon_period_seconds\x18\x02 \x01(\r\x12\x1e\n\x16catchup_period_seconds\x18\x03 \x01(\r\x12\x10\n\x08schemeID\x18\x04 \x01(\t\x12!\n\x08metadata\x18\x05 \x01(\x0b2\x0f.drand.Metadata"n\n\x11InitResharePacket\x12\x1e\n\x04info\x18\x01 \x01(\x0b2\x10.drand.SetupInfo\x12\x16\n\x0eold_group_path\x18\x02 \x01(\t\x12!\n\x08metadata\x18\x03 \x01(\x0b2\x0f.drand.Metadata"5\n\x10PublicKeyRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"G\n\x11PublicKeyResponse\x12\x0f\n\x07pub_key\x18\x01 \x01(\x0c\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"6\n\x11PrivateKeyRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"H\n\x12PrivateKeyResponse\x12\x0f\n\x07pri_key\x18\x01 \x01(\x0c\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"1\n\x0cGroupRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"4\n\x0fShutdownRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"5\n\x10ShutdownResponse\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"6\n\x11LoadBeaconRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"7\n\x12LoadBeaconResponse\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"\x89\x01\n\x10StartSyncRequest\x12\r\n\x05nodes\x18\x01 \x03(\t\x12\x0e\n\x06is_tls\x18\x02 \x01(\x08\x12\r\n\x05up_to\x18\x03 \x01(\x04\x12\x10\n\x08beaconID\x18\x04 \x01(\t\x12\x12\n\nchain_hash\x18\x05 \x01(\t\x12!\n\x08metadata\x18\x06 \x01(\x0b2\x0f.drand.Metadata"R\n\x0cSyncProgress\x12\x0f\n\x07current\x18\x01 \x01(\x04\x12\x0e\n\x06target\x18\x02 \x01(\x04\x12!\n\x08metadata\x18\x03 \x01(\x0b2\x0f.drand.Metadata"I\n\x0fBackupDBRequest\x12\x13\n\x0boutput_file\x18\x01 \x01(\t\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"5\n\x10BackupDBResponse\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"7\n\x12ListSchemesRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"E\n\x13ListSchemesResponse\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"9\n\x14ListBeaconIDsRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"G\n\x15ListBeaconIDsResponse\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"a\n\x13RemoteStatusRequest\x12\'\n\taddresses\x18\x01 \x03(\x0b2\x14.drand.StatusAddress\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"J\n\x10RemoteStatusNode\x12\x0f\n\x07address\x18\x01 \x01(\t\x12%\n\x06status\x18\x02 \x01(\x0b2\x15.drand.StatusResponse"d\n\x14RemoteStatusResponse\x12)\n\x08statuses\x18\x01 \x03(\x0b2\x17.drand.RemoteStatusNode\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"3\n\x0eMetricsRequest\x12!\n\x08metadata\x18\x01 \x01(\x0b2\x0f.drand.Metadata"E\n\x0fMetricsResponse\x12\x0f\n\x07metrics\x18\x01 \x01(\x0c\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"\x99\x01\n\x12GossipBeaconPacket\x12\x12\n\nchain_hash\x18\x01 \x01(\x0c\x12\r\n\x05round\x18\x02 \x01(\x04\x12\x11\n\tsignature\x18\x03 \x01(\x0c\x12\x1a\n\x12previous_signature\x18\x04 \x01(\x0c\x12\x0e\n\x06sender\x18\x05 \x01(\t\x12!\n\x08metadata\x18\x06 \x01(\x0b2\x0f.drand.Metadata"\xb1\x01\n\x15HandelAggregatePacket\x12\r\n\x05round\x18\x01 \x01(\x04\x12\x1a\n\x12previous_signature\x18\x02 \x01(\x0c\x12\r\n\x05level\x18\x03 \x01(\r\x12\x0f\n\x07bitmask\x18\x04 \x01(\x0c\x12\x14\n\x0cpartial_sigs\x18\x05 \x03(\x0c\x12\x14\n\x0csender_index\x18\x06 \x01(\r\x12!\n\x08metadata\x18\x07 \x01(\x0b2\x0f.drand.Metadata"\xd3\x01\n\x12TenantConfigPacket\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06weight\x18\x02 \x01(\x01\x12\x0c\n\x04rate\x18\x03 \x01(\x01\x12\r\n\x05burst\x18\x04 \x01(\r\x12\x15\n\rdevice_budget\x18\x05 \x01(\x01\x12\x0e\n\x06chains\x18\x06 \x03(\t\x12\x11\n\tpin_group\x18\x07 \x01(\x05\x12\x15\n\ranti_affinity\x18\x08 \x01(\x08\x12\x0e\n\x06paused\x18\t \x01(\x08\x12!\n\x08metadata\x18\n \x01(\x0b2\x0f.drand.Metadata"@\n\rTenantRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"c\n\x12TenantListResponse\x12*\n\x07tenants\x18\x01 \x03(\x0b2\x19.drand.TenantConfigPacket\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"}\n\x10TokenMintRequest\x12\x0e\n\x06tenant\x18\x01 \x01(\t\x12\x0e\n\x06chains\x18\x02 \x03(\t\x12\x13\n\x0bttl_seconds\x18\x03 \x01(\x01\x12\x11\n\tread_only\x18\x04 \x01(\x08\x12!\n\x08metadata\x18\x05 \x01(\x0b2\x0f.drand.Metadata"h\n\x11TokenMintResponse\x12\r\n\x05token\x18\x01 \x01(\t\x12\x10\n\x08token_id\x18\x02 \x01(\t\x12\x0f\n\x07expires\x18\x03 \x01(\x01\x12!\n\x08metadata\x18\x04 \x01(\x0b2\x0f.drand.Metadata"C\n\x0cTokenRequest\x12\x10\n\x08token_id\x18\x01 \x01(\t\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadata"r\n\tTokenInfo\x12\x10\n\x08token_id\x18\x01 \x01(\t\x12\x0e\n\x06tenant\x18\x02 \x01(\t\x12\x0f\n\x07expires\x18\x03 \x01(\x01\x12\x11\n\tread_only\x18\x04 \x01(\x08\x12\x0f\n\x07revoked\x18\x05 \x01(\x08\x12\x0e\n\x06chains\x18\x06 \x03(\t"X\n\x11TokenListResponse\x12 \n\x06tokens\x18\x01 \x03(\x0b2\x10.drand.TokenInfo\x12!\n\x08metadata\x18\x02 \x01(\x0b2\x0f.drand.Metadatab\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'drand_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEVERSION._serialized_start=22
  _NODEVERSION._serialized_end=80
  _METADATA._serialized_start=82
  _METADATA._serialized_end=172
  _EMPTY._serialized_start=174
  _EMPTY._serialized_end=216
  _IDENTITY._serialized_start=218
  _IDENTITY._serialized_end=290
  _GROUPNODE._serialized_start=292
  _GROUPNODE._serialized_end=351
  _GROUPPACKET._serialized_start=354
  _GROUPPACKET._serialized_end=599
  _IDENTITYREQUEST._serialized_start=601
  _IDENTITYREQUEST._serialized_end=653
  _IDENTITYRESPONSE._serialized_start=656
  _IDENTITYRESPONSE._serialized_end=791
  _SIGNALDKGPACKET._serialized_start=794
  _SIGNALDKGPACKET._serialized_end=928
  _DKGINFOPACKET._serialized_start=931
  _DKGINFOPACKET._serialized_end=1108
  _PARTIALBEACONPACKET._serialized_start=1110
  _PARTIALBEACONPACKET._serialized_end=1230
  _DEALSHARE._serialized_start=1232
  _DEALSHARE._serialized_end=1289
  _DEALBUNDLE._serialized_start=1291
  _DEALBUNDLE._serialized_end=1414
  _DEALERSTATUS._serialized_start=1416
  _DEALERSTATUS._serialized_end=1468
  _RESPONSEBUNDLE._serialized_start=1470
  _RESPONSEBUNDLE._serialized_end=1586
  _JUSTIFICATIONSHARE._serialized_start=1588
  _JUSTIFICATIONSHARE._serialized_end=1644
  _JUSTIFICATIONBUNDLE._serialized_start=1647
  _JUSTIFICATIONBUNDLE._serialized_end=1780
  _DKGBUNDLE._serialized_start=1783
  _DKGBUNDLE._serialized_end=1970
  _DKGPACKET._serialized_start=1972
  _DKGPACKET._serialized_end=2049
  _SYNCREQUEST._serialized_start=2051
  _SYNCREQUEST._serialized_end=2119
  _BEACONPACKET._serialized_start=2121
  _BEACONPACKET._serialized_end=2232
  _PUBLICRANDREQUEST._serialized_start=2234
  _PUBLICRANDREQUEST._serialized_end=2303
  _PUBLICRANDRESPONSE._serialized_start=2306
  _PUBLICRANDRESPONSE._serialized_end=2443
  _CHAININFOREQUEST._serialized_start=2445
  _CHAININFOREQUEST._serialized_end=2498
  _CHAININFOPACKET._serialized_start=2501
  _CHAININFOPACKET._serialized_end=2663
  _HOMEREQUEST._serialized_start=2665
  _HOMEREQUEST._serialized_end=2713
  _HOMERESPONSE._serialized_start=2715
  _HOMERESPONSE._serialized_end=2780
  _STATUSADDRESS._serialized_start=2782
  _STATUSADDRESS._serialized_end=2827
  _STATUSREQUEST._serialized_start=2829
  _STATUSREQUEST._serialized_end=2921
  _DKGSTATUSPART._serialized_start=2923
  _DKGSTATUSPART._serialized_end=2954
  _BEACONSTATUSPART._serialized_start=2956
  _BEACONSTATUSPART._serialized_end=3070
  _CHAINSTORESTATUSPART._serialized_start=3072
  _CHAINSTORESTATUSPART._serialized_end=3148
  _STATUSRESPONSE._serialized_start=3151
  _STATUSRESPONSE._serialized_end=3445
  _STATUSRESPONSE_CONNECTIONSENTRY._serialized_start=3395
  _STATUSRESPONSE_CONNECTIONSENTRY._serialized_end=3445
  _PING._serialized_start=3447
  _PING._serialized_end=3488
  _PONG._serialized_start=3490
  _PONG._serialized_end=3531
  _SETUPINFO._serialized_start=3534
  _SETUPINFO._serialized_end=3675
  _INITDKGPACKET._serialized_start=3678
  _INITDKGPACKET._serialized_end=3841
  _INITRESHAREPACKET._serialized_start=3843
  _INITRESHAREPACKET._serialized_end=3953
  _PUBLICKEYREQUEST._serialized_start=3955
  _PUBLICKEYREQUEST._serialized_end=4008
  _PUBLICKEYRESPONSE._serialized_start=4010
  _PUBLICKEYRESPONSE._serialized_end=4081
  _PRIVATEKEYREQUEST._serialized_start=4083
  _PRIVATEKEYREQUEST._serialized_end=4137
  _PRIVATEKEYRESPONSE._serialized_start=4139
  _PRIVATEKEYRESPONSE._serialized_end=4211
  _GROUPREQUEST._serialized_start=4213
  _GROUPREQUEST._serialized_end=4262
  _SHUTDOWNREQUEST._serialized_start=4264
  _SHUTDOWNREQUEST._serialized_end=4316
  _SHUTDOWNRESPONSE._serialized_start=4318
  _SHUTDOWNRESPONSE._serialized_end=4371
  _LOADBEACONREQUEST._serialized_start=4373
  _LOADBEACONREQUEST._serialized_end=4427
  _LOADBEACONRESPONSE._serialized_start=4429
  _LOADBEACONRESPONSE._serialized_end=4484
  _STARTSYNCREQUEST._serialized_start=4487
  _STARTSYNCREQUEST._serialized_end=4624
  _SYNCPROGRESS._serialized_start=4626
  _SYNCPROGRESS._serialized_end=4708
  _BACKUPDBREQUEST._serialized_start=4710
  _BACKUPDBREQUEST._serialized_end=4783
  _BACKUPDBRESPONSE._serialized_start=4785
  _BACKUPDBRESPONSE._serialized_end=4838
  _LISTSCHEMESREQUEST._serialized_start=4840
  _LISTSCHEMESREQUEST._serialized_end=4895
  _LISTSCHEMESRESPONSE._serialized_start=4897
  _LISTSCHEMESRESPONSE._serialized_end=4966
  _LISTBEACONIDSREQUEST._serialized_start=4968
  _LISTBEACONIDSREQUEST._serialized_end=5025
  _LISTBEACONIDSRESPONSE._serialized_start=5027
  _LISTBEACONIDSRESPONSE._serialized_end=5098
  _REMOTESTATUSREQUEST._serialized_start=5100
  _REMOTESTATUSREQUEST._serialized_end=5197
  _REMOTESTATUSNODE._serialized_start=5199
  _REMOTESTATUSNODE._serialized_end=5273
  _REMOTESTATUSRESPONSE._serialized_start=5275
  _REMOTESTATUSRESPONSE._serialized_end=5375
  _METRICSREQUEST._serialized_start=5377
  _METRICSREQUEST._serialized_end=5428
  _METRICSRESPONSE._serialized_start=5430
  _METRICSRESPONSE._serialized_end=5499
  _GOSSIPBEACONPACKET._serialized_start=5502
  _GOSSIPBEACONPACKET._serialized_end=5655
  _HANDELAGGREGATEPACKET._serialized_start=5658
  _HANDELAGGREGATEPACKET._serialized_end=5835
  _TENANTCONFIGPACKET._serialized_start=5838
  _TENANTCONFIGPACKET._serialized_end=6049
  _TENANTREQUEST._serialized_start=6051
  _TENANTREQUEST._serialized_end=6115
  _TENANTLISTRESPONSE._serialized_start=6117
  _TENANTLISTRESPONSE._serialized_end=6216
  _TOKENMINTREQUEST._serialized_start=6218
  _TOKENMINTREQUEST._serialized_end=6343
  _TOKENMINTRESPONSE._serialized_start=6345
  _TOKENMINTRESPONSE._serialized_end=6449
  _TOKENREQUEST._serialized_start=6451
  _TOKENREQUEST._serialized_end=6518
  _TOKENINFO._serialized_start=6520
  _TOKENINFO._serialized_end=6634
  _TOKENLISTRESPONSE._serialized_start=6636
  _TOKENLISTRESPONSE._serialized_end=6724
# @@protoc_insertion_point(module_scope)
