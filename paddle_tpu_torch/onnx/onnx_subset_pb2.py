"""The messages of ``onnx_subset.proto`` (ModelProto, GraphProto,
NodeProto, TensorProto, ...) with the port's own wire encoder and
decoder, in the style of ``static.program_export``'s ``_enc_*`` and
``static.program_import``'s ``_Reader`` — no protobuf runtime.

The module keeps the JAX package's path and message names, and the
protobuf message API its exporter and runtime use: attribute access
with proto3 defaults, sub-messages created on first access, repeated
fields as lists with ``add()`` / ``extend`` / slice assignment,
``SerializeToString()`` and ``ParseFromString()``.  Serialization is
proto3's: fields in field-number order, default scalars left out,
repeated numeric fields packed, an empty sub-message left out — the
bytes a protobuf runtime writes for the same message, and any protobuf
encoding of these fields parses.  ``onnx_subset.proto`` beside this file
is the schema's record.
"""

import struct

from ..static.program_import import _Reader, _zigzag64

_SCALAR_DEFAULTS = {"int": 0, "float": 0.0, "str": "", "bytes": b""}


class _Repeated(list):
    """A repeated field: a list; ``add()`` appends a new message."""

    def __init__(self, cls=None):
        super().__init__()
        self._cls = cls

    def add(self, **kw):
        m = self._cls(**kw)
        self.append(m)
        return m


class _Message:
    # field name -> (number, kind, sub-message class or None, repeated)
    FIELDS = {}

    def __init__(self, **kw):
        for name, (_no, _kind, cls, rep) in self.FIELDS.items():
            if rep:
                object.__setattr__(self, name, _Repeated(cls))
        for k, v in kw.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        spec = type(self).FIELDS.get(name)
        if spec is None:
            raise AttributeError(name)
        _no, kind, cls, rep = spec
        if cls is not None:               # a sub-message, created on use
            m = cls()
            object.__setattr__(self, name, m)
            return m
        return _SCALAR_DEFAULTS[kind]

    def __setattr__(self, name, value):
        spec = type(self).FIELDS.get(name)
        if spec is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        if spec[3]:
            rep = _Repeated(spec[2])
            rep.extend(value)
            value = rep
        object.__setattr__(self, name, value)

    def _value(self, name):
        return self.__dict__.get(name)

    # ---- equality (a field at its default equals an unset one)
    def _fields(self):
        out = {}
        for name, (_no, kind, cls, rep) in self.FIELDS.items():
            v = self._value(name)
            if rep:
                if v:
                    out[name] = list(v)
            elif cls is not None:
                if v is not None and v.SerializeToString():
                    out[name] = v
            elif v is not None and v != _SCALAR_DEFAULTS[kind]:
                out[name] = v
        return out

    def __eq__(self, other):
        return type(self) is type(other) and self._fields() == \
            other._fields()

    def __repr__(self):
        return f"{type(self).__name__}({self._fields()})"

    # ---- wire encoding
    def SerializeToString(self):
        out = bytearray()
        for name, (no, kind, cls, rep) in sorted(
                self.FIELDS.items(), key=lambda kv: kv[1][0]):
            v = self._value(name)
            if v is None:
                continue
            if rep:
                if not v:
                    continue
                if kind in ("int", "float"):
                    body = b"".join(_scalar(kind, x) for x in v)
                    out += _key(no, 2) + _vint(len(body)) + body
                else:
                    for x in v:
                        out += _length_delimited(no, kind, x)
            elif cls is not None:
                body = v.SerializeToString()
                if body:
                    out += _key(no, 2) + _vint(len(body)) + body
            elif v != _SCALAR_DEFAULTS[kind]:
                if kind in ("int", "float"):
                    out += _key(no, 0 if kind == "int" else 5) + \
                        _scalar(kind, v)
                else:
                    out += _length_delimited(no, kind, v)
        return bytes(out)

    def ParseFromString(self, data):
        by_no = {no: (name, kind, cls, rep)
                 for name, (no, kind, cls, rep) in self.FIELDS.items()}
        for name, (_no, _kind, cls, rep) in self.FIELDS.items():
            if rep:
                object.__setattr__(self, name, _Repeated(cls))
            else:
                self.__dict__.pop(name, None)
        r = _Reader(data)
        while not r.eof():
            key = r.varint()
            no, wt = key >> 3, key & 7
            if no not in by_no:
                r.skip(wt)
                continue
            name, kind, cls, rep = by_no[no]
            if kind in ("int", "float") and rep and wt == 2:   # packed
                sub = _Reader(r.bytes_())
                while not sub.eof():
                    getattr(self, name).append(_read_scalar(sub, kind))
                continue
            if kind in ("int", "float"):
                val = _read_scalar(r, kind)
            elif kind == "str":
                val = bytes(r.bytes_()).decode("utf-8")
            elif kind == "bytes":
                val = bytes(r.bytes_())
            else:
                val = cls()
                val.ParseFromString(bytes(r.bytes_()))
            if rep:
                getattr(self, name).append(val)
            else:
                object.__setattr__(self, name, val)
        return len(data)


def _vint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(no, wire):
    return _vint(no << 3 | wire)


def _scalar(kind, v):
    if kind == "int":
        return _vint(int(v))
    return struct.pack("<f", float(v))


def _length_delimited(no, kind, v):
    if kind == "str":
        v = v.encode("utf-8")
    elif kind == "msg":
        v = v.SerializeToString()
    return _key(no, 2) + _vint(len(v)) + bytes(v)


def _read_scalar(r, kind):
    if kind == "int":
        return _zigzag64(r.varint())
    (v,) = struct.unpack("<f", bytes(r.d[r.pos:r.pos + 4]))
    r.pos += 4
    return v


def _fields(**spec):
    """``name=(number, kind)`` or ``(number, "msg", cls)``; a kind
    prefixed ``rep_`` is repeated."""
    out = {}
    for name, (no, kind, *cls) in spec.items():
        rep = kind.startswith("rep_")
        kind = kind[4:] if rep else kind
        out[name] = (no, kind, cls[0] if cls else None, rep)
    return out


class OperatorSetIdProto(_Message):
    FIELDS = _fields(domain=(1, "str"), version=(2, "int"))


class TensorProto(_Message):
    FIELDS = _fields(dims=(1, "rep_int"), data_type=(2, "int"),
                     name=(8, "str"), raw_data=(9, "bytes"))


class TensorShapeProto(_Message):
    class Dimension(_Message):
        FIELDS = _fields(dim_value=(1, "int"), dim_param=(2, "str"))


TensorShapeProto.FIELDS = _fields(
    dim=(1, "rep_msg", TensorShapeProto.Dimension))


class TypeProto(_Message):
    class Tensor(_Message):
        FIELDS = _fields(elem_type=(1, "int"),
                         shape=(2, "msg", TensorShapeProto))


TypeProto.FIELDS = _fields(tensor_type=(1, "msg", TypeProto.Tensor))


class ValueInfoProto(_Message):
    FIELDS = _fields(name=(1, "str"), type=(2, "msg", TypeProto),
                     doc_string=(3, "str"))


class AttributeProto(_Message):
    FIELDS = _fields(name=(1, "str"), f=(2, "float"), i=(3, "int"),
                     s=(4, "bytes"), t=(5, "msg", TensorProto),
                     floats=(7, "rep_float"), ints=(8, "rep_int"),
                     strings=(9, "rep_bytes"), type=(20, "int"))


class NodeProto(_Message):
    FIELDS = _fields(input=(1, "rep_str"), output=(2, "rep_str"),
                     name=(3, "str"), op_type=(4, "str"),
                     attribute=(5, "rep_msg", AttributeProto),
                     doc_string=(6, "str"), domain=(7, "str"))


class GraphProto(_Message):
    FIELDS = _fields(node=(1, "rep_msg", NodeProto), name=(2, "str"),
                     initializer=(5, "rep_msg", TensorProto),
                     doc_string=(10, "str"),
                     input=(11, "rep_msg", ValueInfoProto),
                     output=(12, "rep_msg", ValueInfoProto),
                     value_info=(13, "rep_msg", ValueInfoProto))


class ModelProto(_Message):
    FIELDS = _fields(ir_version=(1, "int"), producer_name=(2, "str"),
                     producer_version=(3, "str"), domain=(4, "str"),
                     model_version=(5, "int"), doc_string=(6, "str"),
                     graph=(7, "msg", GraphProto),
                     opset_import=(8, "rep_msg", OperatorSetIdProto))
