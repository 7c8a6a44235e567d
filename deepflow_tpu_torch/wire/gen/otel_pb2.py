# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: otel.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\notel.proto\x12\ndftpu.otel\"N\n\x19\x45xportTraceServiceRequest\x12\x31\n\x0eresource_spans\x18\x01 \x03(\x0b\x32\x19.dftpu.otel.ResourceSpans\"d\n\rResourceSpans\x12&\n\x08resource\x18\x01 \x01(\x0b\x32\x14.dftpu.otel.Resource\x12+\n\x0bscope_spans\x18\x02 \x03(\x0b\x32\x16.dftpu.otel.ScopeSpans\"4\n\x08Resource\x12(\n\nattributes\x18\x01 \x03(\x0b\x32\x14.dftpu.otel.KeyValue\"-\n\nScopeSpans\x12\x1f\n\x05spans\x18\x02 \x03(\x0b\x32\x10.dftpu.otel.Span\"<\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.dftpu.otel.AnyValue\"n\n\x08\x41nyValue\x12\x16\n\x0cstring_value\x18\x01 \x01(\tH\x00\x12\x14\n\nbool_value\x18\x02 \x01(\x08H\x00\x12\x13\n\tint_value\x18\x03 \x01(\x03H\x00\x12\x16\n\x0c\x64ouble_value\x18\x04 \x01(\x01H\x00\x42\x07\n\x05value\"\'\n\x06Status\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x0c\n\x04\x63ode\x18\x03 \x01(\x05\"\xfa\x01\n\x04Span\x12\x10\n\x08trace_id\x18\x01 \x01(\x0c\x12\x0f\n\x07span_id\x18\x02 \x01(\x0c\x12\x13\n\x0btrace_state\x18\x03 \x01(\t\x12\x16\n\x0eparent_span_id\x18\x04 \x01(\x0c\x12\x0c\n\x04name\x18\x05 \x01(\t\x12\x0c\n\x04kind\x18\x06 \x01(\x05\x12\x1c\n\x14start_time_unix_nano\x18\x07 \x01(\x06\x12\x1a\n\x12\x65nd_time_unix_nano\x18\x08 \x01(\x06\x12(\n\nattributes\x18\t \x03(\x0b\x32\x14.dftpu.otel.KeyValue\x12\"\n\x06status\x18\x0f \x01(\x0b\x32\x12.dftpu.otel.Statusb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'otel_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXPORTTRACESERVICEREQUEST._serialized_start=26
  _EXPORTTRACESERVICEREQUEST._serialized_end=104
  _RESOURCESPANS._serialized_start=106
  _RESOURCESPANS._serialized_end=206
  _RESOURCE._serialized_start=208
  _RESOURCE._serialized_end=260
  _SCOPESPANS._serialized_start=262
  _SCOPESPANS._serialized_end=307
  _KEYVALUE._serialized_start=309
  _KEYVALUE._serialized_end=369
  _ANYVALUE._serialized_start=371
  _ANYVALUE._serialized_end=481
  _STATUS._serialized_start=483
  _STATUS._serialized_end=522
  _SPAN._serialized_start=525
  _SPAN._serialized_end=775
# @@protoc_insertion_point(module_scope)
