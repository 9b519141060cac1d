# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: das.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tdas.proto\x12\x03\x64\x61s\"\x1e\n\x0e\x42indingRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\'\n\x0bLoadRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\"A\n\x0b\x41tomRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x0e\n\x06handle\x18\x02 \x01(\t\x12\x15\n\routput_format\x18\x03 \x01(\t\"k\n\x0bLinkRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x11\n\tlink_type\x18\x02 \x01(\t\x12\x14\n\x0ctarget_types\x18\x03 \x03(\t\x12\x0f\n\x07targets\x18\x04 \x03(\t\x12\x15\n\routput_format\x18\x05 \x01(\t\"W\n\x0bNodeRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x11\n\tnode_type\x18\x02 \x01(\t\x12\x11\n\tnode_name\x18\x03 \x01(\t\x12\x15\n\routput_format\x18\x04 \x01(\t\":\n\x05Query\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05query\x18\x02 \x01(\t\x12\x15\n\routput_format\x18\x03 \x01(\t\"\x15\n\x06\x44\x41SKey\x12\x0b\n\x03key\x18\x01 \x01(\t\"&\n\x06Status\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0b\n\x03msg\x18\x02 \x01(\t2\xd7\x03\n\x11ServiceDefinition\x12,\n\x06\x63reate\x12\x13.das.BindingRequest\x1a\x0b.das.Status\"\x00\x12/\n\treconnect\x12\x13.das.BindingRequest\x1a\x0b.das.Status\"\x00\x12\x36\n\x13load_knowledge_base\x12\x10.das.LoadRequest\x1a\x0b.das.Status\"\x00\x12.\n\x10\x63heck_das_status\x12\x0b.das.DASKey\x1a\x0b.das.Status\"\x00\x12#\n\x05\x63lear\x12\x0b.das.DASKey\x1a\x0b.das.Status\"\x00\x12#\n\x05\x63ount\x12\x0b.das.DASKey\x1a\x0b.das.Status\"\x00\x12+\n\x08get_atom\x12\x10.das.AtomRequest\x1a\x0b.das.Status\"\x00\x12/\n\x0csearch_nodes\x12\x10.das.NodeRequest\x1a\x0b.das.Status\"\x00\x12/\n\x0csearch_links\x12\x10.das.LinkRequest\x1a\x0b.das.Status\"\x00\x12\"\n\x05query\x12\n.das.Query\x1a\x0b.das.Status\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'das_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BINDINGREQUEST._serialized_start=18
  _BINDINGREQUEST._serialized_end=48
  _LOADREQUEST._serialized_start=50
  _LOADREQUEST._serialized_end=89
  _ATOMREQUEST._serialized_start=91
  _ATOMREQUEST._serialized_end=156
  _LINKREQUEST._serialized_start=158
  _LINKREQUEST._serialized_end=265
  _NODEREQUEST._serialized_start=267
  _NODEREQUEST._serialized_end=354
  _QUERY._serialized_start=356
  _QUERY._serialized_end=414
  _DASKEY._serialized_start=416
  _DASKEY._serialized_end=437
  _STATUS._serialized_start=439
  _STATUS._serialized_end=477
  _SERVICEDEFINITION._serialized_start=480
  _SERVICEDEFINITION._serialized_end=951
# @@protoc_insertion_point(module_scope)
