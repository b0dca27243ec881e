"""Protobuf format via compiled descriptor sets (the port's copy of
arroyo_tpu/formats/proto_fmt.py).

Reference: crates/arroyo-formats/src/proto/ (prost-reflect DynamicMessage
decoding against a FileDescriptorSet supplied in the table DDL). Here the
equivalent: the DDL supplies ``proto.descriptor_file`` (output of
``protoc --descriptor_set_out``) and ``proto.message_name``; messages decode
to row dicts through google.protobuf's message factory, which is imported
only when a message is decoded or encoded.
"""

from __future__ import annotations

from typing import Optional

from .base import RowBatchingDeserializer


def _load_message_class(descriptor_file: str, message_name: str):
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    with open(descriptor_file, "rb") as f:
        fds = descriptor_pb2.FileDescriptorSet.FromString(f.read())
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    desc = pool.FindMessageTypeByName(message_name)
    return message_factory.GetMessageClass(desc)


def _message_to_row(msg) -> dict:
    row = {}
    for field, value in msg.ListFields():
        if field.is_repeated:
            row[field.name] = [
                _message_to_row(v) if field.message_type else v for v in value
            ]
        elif field.message_type:
            row[field.name] = _message_to_row(value)
        else:
            row[field.name] = value
    # include unset scalar fields with their defaults so columns stay dense
    for field in msg.DESCRIPTOR.fields:
        if field.name not in row and not field.message_type and \
                not field.is_repeated:
            row[field.name] = field.default_value
    return row


class ProtoDeserializer(RowBatchingDeserializer):
    def __init__(self, *args, descriptor_file: str, message_name: str,
                 confluent_wire_format: bool = False, **kw):
        super().__init__(*args, **kw)
        self.msg_class = _load_message_class(descriptor_file, message_name)
        self.confluent = confluent_wire_format

    def _decode(self, payload) -> list[dict]:
        data = payload if isinstance(payload, bytes) else str(payload).encode()
        if self.confluent:
            # magic byte + 4-byte schema id + message-indexes varint(s)
            if len(data) < 6 or data[:1] != b"\x00":
                raise ValueError("not a confluent-framed protobuf message")
            # single top-level message => indexes encoded as one 0 byte
            data = data[5:]
            if data[:1] == b"\x00":
                data = data[1:]
        msg = self.msg_class.FromString(data)
        return [_message_to_row(msg)]


def _assign_field(msg, field, value) -> None:
    if field.is_repeated:
        target = getattr(msg, field.name)
        for item in value:
            if field.message_type:
                _fill_message(target.add(), item)
            else:
                target.append(item)
    elif field.message_type:
        _fill_message(getattr(msg, field.name), value)
    else:
        setattr(msg, field.name, value)


def _fill_message(msg, row: dict) -> None:
    by_name = {f.name: f for f in msg.DESCRIPTOR.fields}
    for k, v in row.items():
        if v is None or k.startswith("_"):
            continue
        field = by_name.get(k)
        if field is None:
            raise ValueError(
                f"row column {k!r} has no field on {msg.DESCRIPTOR.full_name}"
            )
        _assign_field(msg, field, v)


def encode_rows(descriptor_file: str, message_name: str, rows: list[dict]) -> list[bytes]:
    cls = _load_message_class(descriptor_file, message_name)
    out = []
    for r in rows:
        m = cls()
        _fill_message(m, r)
        out.append(m.SerializeToString())
    return out
