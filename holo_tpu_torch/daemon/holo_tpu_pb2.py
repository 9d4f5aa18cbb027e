# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: holo_tpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eholo_tpu.proto\x12\x08holo_tpu\"\x15\n\x13\x43\x61pabilitiesRequest\"8\n\x14\x43\x61pabilitiesResponse\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x0f\n\x07modules\x18\x02 \x03(\t\"\"\n\x10GetSchemaRequest\x12\x0e\n\x06module\x18\x01 \x01(\t\"(\n\x11GetSchemaResponse\x12\x13\n\x0bschema_json\x18\x01 \x01(\t\"J\n\x10GetConfigRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12(\n\x08\x65ncoding\x18\x02 \x01(\x0e\x32\x16.holo_tpu.DataEncoding\"(\n\x11GetConfigResponse\x12\x13\n\x0b\x63onfig_json\x18\x01 \x01(\t\"I\n\x0fGetStateRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12(\n\x08\x65ncoding\x18\x02 \x01(\x0e\x32\x16.holo_tpu.DataEncoding\"&\n\x10GetStateResponse\x12\x12\n\nstate_json\x18\x01 \x01(\t\"&\n\x0fValidateRequest\x12\x13\n\x0b\x63onfig_json\x18\x01 \x01(\t\"!\n\x10ValidateResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\":\n\x08PathEdit\x12\x11\n\toperation\x18\x01 \x01(\t\x12\x0c\n\x04path\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\"\xa1\x01\n\rCommitRequest\x12,\n\toperation\x18\x01 \x01(\x0e\x32\x19.holo_tpu.CommitOperation\x12\x13\n\x0b\x63onfig_json\x18\x02 \x01(\t\x12!\n\x05\x65\x64its\x18\x03 \x03(\x0b\x32\x12.holo_tpu.PathEdit\x12\x0f\n\x07\x63omment\x18\x04 \x01(\t\x12\x19\n\x11\x63onfirmed_timeout\x18\x05 \x01(\r\"7\n\x0e\x43ommitResponse\x12\x16\n\x0etransaction_id\x18\x01 \x01(\r\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"6\n\x0e\x45xecuteRequest\x12\x10\n\x08rpc_name\x18\x01 \x01(\t\x12\x12\n\ninput_json\x18\x02 \x01(\t\"&\n\x0f\x45xecuteResponse\x12\x13\n\x0boutput_json\x18\x01 \x01(\t\"\x19\n\x17ListTransactionsRequest\"A\n\x0fTransactionInfo\x12\n\n\x02id\x18\x01 \x01(\r\x12\x11\n\ttimestamp\x18\x02 \x01(\x01\x12\x0f\n\x07\x63omment\x18\x03 \x01(\t\"K\n\x18ListTransactionsResponse\x12/\n\x0ctransactions\x18\x01 \x03(\x0b\x32\x19.holo_tpu.TransactionInfo\"#\n\x15GetTransactionRequest\x12\n\n\x02id\x18\x01 \x01(\r\"l\n\x16GetTransactionResponse\x12\'\n\x04info\x18\x01 \x01(\x0b\x32\x19.holo_tpu.TransactionInfo\x12\x14\n\x0c\x63hanges_json\x18\x02 \x01(\t\x12\x13\n\x0b\x63onfig_json\x18\x03 \x01(\t\"\"\n\x10SubscribeRequest\x12\x0e\n\x06topics\x18\x01 \x03(\t\"F\n\x0cNotification\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x14\n\x0cpayload_json\x18\x02 \x01(\t\x12\x11\n\ttimestamp\x18\x03 \x01(\x01**\n\x0c\x44\x61taEncoding\x12\x08\n\x04JSON\x10\x00\x12\x07\n\x03XML\x10\x01\x12\x07\n\x03LYB\x10\x02*5\n\x0f\x43ommitOperation\x12\t\n\x05MERGE\x10\x00\x12\x0b\n\x07REPLACE\x10\x01\x12\n\n\x06\x43HANGE\x10\x02\x32\xdd\x05\n\nNorthbound\x12M\n\x0c\x43\x61pabilities\x12\x1d.holo_tpu.CapabilitiesRequest\x1a\x1e.holo_tpu.CapabilitiesResponse\x12\x44\n\tGetSchema\x12\x1a.holo_tpu.GetSchemaRequest\x1a\x1b.holo_tpu.GetSchemaResponse\x12\x44\n\tGetConfig\x12\x1a.holo_tpu.GetConfigRequest\x1a\x1b.holo_tpu.GetConfigResponse\x12\x41\n\x08GetState\x12\x19.holo_tpu.GetStateRequest\x1a\x1a.holo_tpu.GetStateResponse\x12\x41\n\x08Validate\x12\x19.holo_tpu.ValidateRequest\x1a\x1a.holo_tpu.ValidateResponse\x12;\n\x06\x43ommit\x12\x17.holo_tpu.CommitRequest\x1a\x18.holo_tpu.CommitResponse\x12>\n\x07\x45xecute\x12\x18.holo_tpu.ExecuteRequest\x1a\x19.holo_tpu.ExecuteResponse\x12Y\n\x10ListTransactions\x12!.holo_tpu.ListTransactionsRequest\x1a\".holo_tpu.ListTransactionsResponse\x12S\n\x0eGetTransaction\x12\x1f.holo_tpu.GetTransactionRequest\x1a .holo_tpu.GetTransactionResponse\x12\x41\n\tSubscribe\x12\x1a.holo_tpu.SubscribeRequest\x1a\x16.holo_tpu.Notification0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'holo_tpu_torch.daemon.holo_tpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DATAENCODING._serialized_start=1298
  _DATAENCODING._serialized_end=1340
  _COMMITOPERATION._serialized_start=1342
  _COMMITOPERATION._serialized_end=1395
  _CAPABILITIESREQUEST._serialized_start=28
  _CAPABILITIESREQUEST._serialized_end=49
  _CAPABILITIESRESPONSE._serialized_start=51
  _CAPABILITIESRESPONSE._serialized_end=107
  _GETSCHEMAREQUEST._serialized_start=109
  _GETSCHEMAREQUEST._serialized_end=143
  _GETSCHEMARESPONSE._serialized_start=145
  _GETSCHEMARESPONSE._serialized_end=185
  _GETCONFIGREQUEST._serialized_start=187
  _GETCONFIGREQUEST._serialized_end=261
  _GETCONFIGRESPONSE._serialized_start=263
  _GETCONFIGRESPONSE._serialized_end=303
  _GETSTATEREQUEST._serialized_start=305
  _GETSTATEREQUEST._serialized_end=378
  _GETSTATERESPONSE._serialized_start=380
  _GETSTATERESPONSE._serialized_end=418
  _VALIDATEREQUEST._serialized_start=420
  _VALIDATEREQUEST._serialized_end=458
  _VALIDATERESPONSE._serialized_start=460
  _VALIDATERESPONSE._serialized_end=493
  _PATHEDIT._serialized_start=495
  _PATHEDIT._serialized_end=553
  _COMMITREQUEST._serialized_start=556
  _COMMITREQUEST._serialized_end=717
  _COMMITRESPONSE._serialized_start=719
  _COMMITRESPONSE._serialized_end=774
  _EXECUTEREQUEST._serialized_start=776
  _EXECUTEREQUEST._serialized_end=830
  _EXECUTERESPONSE._serialized_start=832
  _EXECUTERESPONSE._serialized_end=870
  _LISTTRANSACTIONSREQUEST._serialized_start=872
  _LISTTRANSACTIONSREQUEST._serialized_end=897
  _TRANSACTIONINFO._serialized_start=899
  _TRANSACTIONINFO._serialized_end=964
  _LISTTRANSACTIONSRESPONSE._serialized_start=966
  _LISTTRANSACTIONSRESPONSE._serialized_end=1041
  _GETTRANSACTIONREQUEST._serialized_start=1043
  _GETTRANSACTIONREQUEST._serialized_end=1078
  _GETTRANSACTIONRESPONSE._serialized_start=1080
  _GETTRANSACTIONRESPONSE._serialized_end=1188
  _SUBSCRIBEREQUEST._serialized_start=1190
  _SUBSCRIBEREQUEST._serialized_end=1224
  _NOTIFICATION._serialized_start=1226
  _NOTIFICATION._serialized_end=1296
  _NORTHBOUND._serialized_start=1398
  _NORTHBOUND._serialized_end=2131
# @@protoc_insertion_point(module_scope)
