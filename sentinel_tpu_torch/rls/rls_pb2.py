# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: rls.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\trls.proto\x12\x1a\x65nvoy.service.ratelimit.v2\"\x82\x01\n\x13RateLimitDescriptor\x12\x46\n\x07\x65ntries\x18\x01 \x03(\x0b\x32\x35.envoy.service.ratelimit.v2.RateLimitDescriptor.Entry\x1a#\n\x05\x45ntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"}\n\x10RateLimitRequest\x12\x0e\n\x06\x64omain\x18\x01 \x01(\t\x12\x44\n\x0b\x64\x65scriptors\x18\x02 \x03(\x0b\x32/.envoy.service.ratelimit.v2.RateLimitDescriptor\x12\x13\n\x0bhits_addend\x18\x03 \x01(\r\"\xcb\x02\n\x11RateLimitResponse\x12H\n\x0coverall_code\x18\x01 \x01(\x0e\x32\x32.envoy.service.ratelimit.v2.RateLimitResponse.Code\x12P\n\x08statuses\x18\x02 \x03(\x0b\x32>.envoy.service.ratelimit.v2.RateLimitResponse.DescriptorStatus\x1am\n\x10\x44\x65scriptorStatus\x12@\n\x04\x63ode\x18\x01 \x01(\x0e\x32\x32.envoy.service.ratelimit.v2.RateLimitResponse.Code\x12\x17\n\x0flimit_remaining\x18\x03 \x01(\r\"+\n\x04\x43ode\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x06\n\x02OK\x10\x01\x12\x0e\n\nOVER_LIMIT\x10\x02\x32\x84\x01\n\x10RateLimitService\x12p\n\x0fShouldRateLimit\x12,.envoy.service.ratelimit.v2.RateLimitRequest\x1a-.envoy.service.ratelimit.v2.RateLimitResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'rls_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RATELIMITDESCRIPTOR._serialized_start=42
  _RATELIMITDESCRIPTOR._serialized_end=172
  _RATELIMITDESCRIPTOR_ENTRY._serialized_start=137
  _RATELIMITDESCRIPTOR_ENTRY._serialized_end=172
  _RATELIMITREQUEST._serialized_start=174
  _RATELIMITREQUEST._serialized_end=299
  _RATELIMITRESPONSE._serialized_start=302
  _RATELIMITRESPONSE._serialized_end=633
  _RATELIMITRESPONSE_DESCRIPTORSTATUS._serialized_start=479
  _RATELIMITRESPONSE_DESCRIPTORSTATUS._serialized_end=588
  _RATELIMITRESPONSE_CODE._serialized_start=590
  _RATELIMITRESPONSE_CODE._serialized_end=633
  _RATELIMITSERVICE._serialized_start=636
  _RATELIMITSERVICE._serialized_end=768
# @@protoc_insertion_point(module_scope)
