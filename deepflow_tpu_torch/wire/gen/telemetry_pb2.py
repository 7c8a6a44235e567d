# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: telemetry.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ftelemetry.proto\x12\x0f\x64\x66tpu.telemetry\"$\n\x05Label\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"*\n\x06Sample\x12\r\n\x05value\x18\x01 \x01(\x01\x12\x11\n\ttimestamp\x18\x02 \x01(\x03\"^\n\nTimeSeries\x12&\n\x06labels\x18\x01 \x03(\x0b\x32\x16.dftpu.telemetry.Label\x12(\n\x07samples\x18\x02 \x03(\x0b\x32\x17.dftpu.telemetry.Sample\"?\n\x0cWriteRequest\x12/\n\ntimeseries\x18\x01 \x03(\x0b\x32\x1b.dftpu.telemetry.TimeSeries\"Z\n\x10PrometheusMetric\x12\x0f\n\x07metrics\x18\x01 \x01(\x0c\x12\x19\n\x11\x65xtra_label_names\x18\x02 \x03(\t\x12\x1a\n\x12\x65xtra_label_values\x18\x03 \x03(\t\"v\n\x0bIoEventData\x12\x13\n\x0b\x62ytes_count\x18\x01 \x01(\r\x12/\n\toperation\x18\x02 \x01(\x0e\x32\x1c.dftpu.telemetry.IoOperation\x12\x0f\n\x07latency\x18\x03 \x01(\x04\x12\x10\n\x08\x66ilename\x18\x04 \x01(\x0c\"\xf3\x01\n\tProcEvent\x12\x0b\n\x03pid\x18\x01 \x01(\r\x12\x11\n\tthread_id\x18\x02 \x01(\r\x12\x14\n\x0c\x63oroutine_id\x18\x03 \x01(\r\x12\x15\n\rprocess_kname\x18\x04 \x01(\x0c\x12\x12\n\nstart_time\x18\x05 \x01(\x04\x12\x10\n\x08\x65nd_time\x18\x06 \x01(\x04\x12.\n\nevent_type\x18\x07 \x01(\x0e\x32\x1a.dftpu.telemetry.EventType\x12\x33\n\rio_event_data\x18\x08 \x01(\x0b\x32\x1c.dftpu.telemetry.IoEventData\x12\x0e\n\x06pod_id\x18\n \x01(\r\"\xd8\x01\n\nAlarmEvent\x12\x0e\n\x06lcuuid\x18\x01 \x01(\t\x12\x0c\n\x04user\x18\x02 \x01(\t\x12\x11\n\ttimestamp\x18\x03 \x01(\r\x12\x11\n\tpolicy_id\x18\x04 \x01(\r\x12\x13\n\x0bpolicy_name\x18\x05 \x01(\t\x12\x14\n\x0cpolicy_level\x18\x06 \x01(\r\x12\x19\n\x11trigger_condition\x18\x10 \x01(\t\x12\x15\n\rtrigger_value\x18\x11 \x01(\x01\x12\x13\n\x0b\x65vent_level\x18\x13 \x01(\r\x12\x14\n\x0c\x61larm_target\x18\x14 \x01(\t\"\x91\x01\n\x07Profile\x12\x11\n\ttimestamp\x18\x01 \x01(\x04\x12\x13\n\x0b\x61pp_service\x18\x02 \x01(\t\x12\x0b\n\x03pid\x18\x03 \x01(\r\x12\x0f\n\x07vtap_id\x18\x04 \x01(\r\x12\x12\n\nevent_type\x18\x05 \x01(\t\x12\r\n\x05stack\x18\x06 \x01(\t\x12\r\n\x05value\x18\x07 \x01(\x04\x12\x0e\n\x06pod_id\x18\x08 \x01(\r\"\x87\x01\n\x0cLabelMatcher\x12\x30\n\x04type\x18\x01 \x01(\x0e\x32\".dftpu.telemetry.LabelMatcher.Type\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\"(\n\x04Type\x12\x06\n\x02\x45Q\x10\x00\x12\x07\n\x03NEQ\x10\x01\x12\x06\n\x02RE\x10\x02\x12\x07\n\x03NRE\x10\x03\"r\n\tPromQuery\x12\x1a\n\x12start_timestamp_ms\x18\x01 \x01(\x03\x12\x18\n\x10\x65nd_timestamp_ms\x18\x02 \x01(\x03\x12/\n\x08matchers\x18\x03 \x03(\x0b\x32\x1d.dftpu.telemetry.LabelMatcher\":\n\x0bReadRequest\x12+\n\x07queries\x18\x01 \x03(\x0b\x32\x1a.dftpu.telemetry.PromQuery\">\n\x0bQueryResult\x12/\n\ntimeseries\x18\x01 \x03(\x0b\x32\x1b.dftpu.telemetry.TimeSeries\"=\n\x0cReadResponse\x12-\n\x07results\x18\x01 \x03(\x0b\x32\x1c.dftpu.telemetry.QueryResult*\"\n\x0bIoOperation\x12\t\n\x05Write\x10\x00\x12\x08\n\x04Read\x10\x01*(\n\tEventType\x12\x0e\n\nOtherEvent\x10\x00\x12\x0b\n\x07IoEvent\x10\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'telemetry_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _IOOPERATION._serialized_start=1545
  _IOOPERATION._serialized_end=1579
  _EVENTTYPE._serialized_start=1581
  _EVENTTYPE._serialized_end=1621
  _LABEL._serialized_start=36
  _LABEL._serialized_end=72
  _SAMPLE._serialized_start=74
  _SAMPLE._serialized_end=116
  _TIMESERIES._serialized_start=118
  _TIMESERIES._serialized_end=212
  _WRITEREQUEST._serialized_start=214
  _WRITEREQUEST._serialized_end=277
  _PROMETHEUSMETRIC._serialized_start=279
  _PROMETHEUSMETRIC._serialized_end=369
  _IOEVENTDATA._serialized_start=371
  _IOEVENTDATA._serialized_end=489
  _PROCEVENT._serialized_start=492
  _PROCEVENT._serialized_end=735
  _ALARMEVENT._serialized_start=738
  _ALARMEVENT._serialized_end=954
  _PROFILE._serialized_start=957
  _PROFILE._serialized_end=1102
  _LABELMATCHER._serialized_start=1105
  _LABELMATCHER._serialized_end=1240
  _LABELMATCHER_TYPE._serialized_start=1200
  _LABELMATCHER_TYPE._serialized_end=1240
  _PROMQUERY._serialized_start=1242
  _PROMQUERY._serialized_end=1356
  _READREQUEST._serialized_start=1358
  _READREQUEST._serialized_end=1416
  _QUERYRESULT._serialized_start=1418
  _QUERYRESULT._serialized_end=1480
  _READRESPONSE._serialized_start=1482
  _READRESPONSE._serialized_end=1543
# @@protoc_insertion_point(module_scope)
