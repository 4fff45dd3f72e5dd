"""Data type system.

Mirrors the reference's ``DataType`` hierarchy
(paimon-common/.../types/DataType.java and paimon-api/.../types, 35 files)
with the same JSON serialization used in ``schema/schema-N`` files: atomic
types serialize to SQL-ish strings (``"INT NOT NULL"``, ``"VARCHAR(10)"``),
complex types to JSON objects (``{"type": "ARRAY", "element": ...}``).

Also owns the Arrow <-> paimon type mapping, which the reference keeps in
paimon-arrow (ArrowUtils); here Arrow is the native in-memory format so the
mapping lives with the types.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import pyarrow as pa

__all__ = [
    "DataType", "DataField", "RowType", "DataTypeRoot",
    "TinyIntType", "SmallIntType", "IntType", "BigIntType",
    "FloatType", "DoubleType", "BooleanType", "CharType", "VarCharType",
    "BinaryType", "VarBinaryType", "DecimalType", "DateType", "TimeType",
    "TimestampType", "LocalZonedTimestampType", "ArrayType", "MapType",
    "MultisetType", "RowKind", "BlobType", "VariantType", "VectorType",
    "parse_data_type", "data_type_from_arrow", "data_type_to_arrow",
    "SpecialFields",
]

# Field ids >= this are reserved for system fields
# (reference paimon-api/.../table/SpecialFields.java:76-93).
SYSTEM_FIELD_ID_START = 2147483647 // 2


class RowKind:
    """Row change kind (+I/-U/+U/-D), reference types/RowKind.java."""

    INSERT = 0          # +I
    UPDATE_BEFORE = 1   # -U
    UPDATE_AFTER = 2    # +U
    DELETE = 3          # -D

    _SHORT = {0: "+I", 1: "-U", 2: "+U", 3: "-D"}
    _FROM_SHORT = {v: k for k, v in _SHORT.items()}

    @staticmethod
    def short_string(kind: int) -> str:
        return RowKind._SHORT[kind]

    @staticmethod
    def from_short_string(s: str) -> int:
        return RowKind._FROM_SHORT[s]

    @staticmethod
    def is_add(kind: int) -> bool:
        return kind in (RowKind.INSERT, RowKind.UPDATE_AFTER)

    @staticmethod
    def is_retract(kind: int) -> bool:
        return kind in (RowKind.UPDATE_BEFORE, RowKind.DELETE)


class DataTypeRoot:
    BOOLEAN = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INTEGER = "INT"
    BIGINT = "BIGINT"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    CHAR = "CHAR"
    VARCHAR = "VARCHAR"
    BINARY = "BINARY"
    VARBINARY = "VARBINARY"
    DECIMAL = "DECIMAL"
    DATE = "DATE"
    TIME = "TIME"
    TIMESTAMP = "TIMESTAMP"
    TIMESTAMP_LTZ = "TIMESTAMP WITH LOCAL TIME ZONE"
    ARRAY = "ARRAY"
    MAP = "MAP"
    MULTISET = "MULTISET"
    ROW = "ROW"
    BLOB = "BLOB"
    VARIANT = "VARIANT"
    VECTOR = "VECTOR"


class DataType:
    """Base of all data types. Immutable."""

    root: str = ""

    def __init__(self, nullable: bool = True):
        self.nullable = nullable

    # -- serde ---------------------------------------------------------------

    def _name(self) -> str:
        raise NotImplementedError

    def __str__(self) -> str:
        return self._name() + ("" if self.nullable else " NOT NULL")

    def __repr__(self) -> str:
        return str(self)

    def to_json(self):
        """Atomic types serialize to strings; complex override to dicts."""
        return str(self)

    def copy(self, nullable: bool) -> "DataType":
        import copy as _copy
        c = _copy.copy(self)
        c.nullable = nullable
        return c

    def as_nullable(self) -> "DataType":
        return self if self.nullable else self.copy(True)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.__dict__ == other.__dict__)

    def __hash__(self):
        return hash((type(self).__name__, str(self)))

    # -- properties ----------------------------------------------------------

    def is_numeric(self) -> bool:
        return self.root in (
            DataTypeRoot.TINYINT, DataTypeRoot.SMALLINT, DataTypeRoot.INTEGER,
            DataTypeRoot.BIGINT, DataTypeRoot.FLOAT, DataTypeRoot.DOUBLE,
            DataTypeRoot.DECIMAL)


class _AtomicType(DataType):
    def _name(self) -> str:
        return self.root


class BooleanType(_AtomicType):
    root = DataTypeRoot.BOOLEAN


class TinyIntType(_AtomicType):
    root = DataTypeRoot.TINYINT


class SmallIntType(_AtomicType):
    root = DataTypeRoot.SMALLINT


class IntType(_AtomicType):
    root = DataTypeRoot.INTEGER


class BigIntType(_AtomicType):
    root = DataTypeRoot.BIGINT


class FloatType(_AtomicType):
    root = DataTypeRoot.FLOAT


class DoubleType(_AtomicType):
    root = DataTypeRoot.DOUBLE


class DateType(_AtomicType):
    root = DataTypeRoot.DATE


class VariantType(_AtomicType):
    root = DataTypeRoot.VARIANT


class CharType(DataType):
    root = DataTypeRoot.CHAR

    def __init__(self, length: int = 1, nullable: bool = True):
        super().__init__(nullable)
        self.length = length

    def _name(self):
        return f"CHAR({self.length})"


class VarCharType(DataType):
    root = DataTypeRoot.VARCHAR
    MAX_LENGTH = 2147483647

    def __init__(self, length: int = MAX_LENGTH, nullable: bool = True):
        super().__init__(nullable)
        self.length = length

    def _name(self):
        return f"VARCHAR({self.length})"

    @staticmethod
    def string_type(nullable: bool = True) -> "VarCharType":
        return VarCharType(VarCharType.MAX_LENGTH, nullable)


class BinaryType(DataType):
    root = DataTypeRoot.BINARY

    def __init__(self, length: int = 1, nullable: bool = True):
        super().__init__(nullable)
        self.length = length

    def _name(self):
        return f"BINARY({self.length})"


class VarBinaryType(DataType):
    root = DataTypeRoot.VARBINARY
    MAX_LENGTH = 2147483647

    def __init__(self, length: int = MAX_LENGTH, nullable: bool = True):
        super().__init__(nullable)
        self.length = length

    def _name(self):
        return f"VARBINARY({self.length})"

    @staticmethod
    def bytes_type(nullable: bool = True) -> "VarBinaryType":
        return VarBinaryType(VarBinaryType.MAX_LENGTH, nullable)


class BlobType(DataType):
    """Large binary externalized to .blob files (reference BlobType)."""
    root = DataTypeRoot.BLOB

    def _name(self):
        return "BLOB"


class DecimalType(DataType):
    root = DataTypeRoot.DECIMAL

    def __init__(self, precision: int = 10, scale: int = 0,
                 nullable: bool = True):
        super().__init__(nullable)
        self.precision = precision
        self.scale = scale

    def _name(self):
        return f"DECIMAL({self.precision}, {self.scale})"


class TimeType(DataType):
    root = DataTypeRoot.TIME

    def __init__(self, precision: int = 0, nullable: bool = True):
        super().__init__(nullable)
        self.precision = precision

    def _name(self):
        return f"TIME({self.precision})"


class TimestampType(DataType):
    root = DataTypeRoot.TIMESTAMP

    def __init__(self, precision: int = 6, nullable: bool = True):
        super().__init__(nullable)
        self.precision = precision

    def _name(self):
        return f"TIMESTAMP({self.precision})"


class LocalZonedTimestampType(DataType):
    root = DataTypeRoot.TIMESTAMP_LTZ

    def __init__(self, precision: int = 6, nullable: bool = True):
        super().__init__(nullable)
        self.precision = precision

    def _name(self):
        return f"TIMESTAMP({self.precision}) WITH LOCAL TIME ZONE"


class ArrayType(DataType):
    root = DataTypeRoot.ARRAY

    def __init__(self, element: DataType, nullable: bool = True):
        super().__init__(nullable)
        self.element = element

    def _name(self):
        return f"ARRAY<{self.element}>"

    def to_json(self):
        d = {"type": "ARRAY" + ("" if self.nullable else " NOT NULL"),
             "element": self.element.to_json()}
        return d


class VectorType(DataType):
    """Fixed-length numeric vector (reference VectorType, for ANN search)."""
    root = DataTypeRoot.VECTOR

    def __init__(self, element: DataType, length: int, nullable: bool = True):
        super().__init__(nullable)
        self.element = element
        self.length = length

    def _name(self):
        return f"VECTOR<{self.element}, {self.length}>"

    def to_json(self):
        return {"type": "VECTOR" + ("" if self.nullable else " NOT NULL"),
                "element": self.element.to_json(), "length": self.length}


class MultisetType(DataType):
    root = DataTypeRoot.MULTISET

    def __init__(self, element: DataType, nullable: bool = True):
        super().__init__(nullable)
        self.element = element

    def _name(self):
        return f"MULTISET<{self.element}>"

    def to_json(self):
        return {"type": "MULTISET" + ("" if self.nullable else " NOT NULL"),
                "element": self.element.to_json()}


class MapType(DataType):
    root = DataTypeRoot.MAP

    def __init__(self, key: DataType, value: DataType, nullable: bool = True):
        super().__init__(nullable)
        self.key = key
        self.value = value

    def _name(self):
        return f"MAP<{self.key}, {self.value}>"

    def to_json(self):
        return {"type": "MAP" + ("" if self.nullable else " NOT NULL"),
                "key": self.key.to_json(), "value": self.value.to_json()}


class DataField:
    """A named, id'd field of a RowType (reference types/DataField.java)."""

    def __init__(self, id: int, name: str, type: DataType,
                 description: Optional[str] = None,
                 default_value: Optional[str] = None):
        self.id = id
        self.name = name
        self.type = type
        self.description = description
        self.default_value = default_value

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"id": self.id, "name": self.name,
                             "type": self.type.to_json()}
        if self.description is not None:
            d["description"] = self.description
        if self.default_value is not None:
            d["defaultValue"] = self.default_value
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DataField":
        return DataField(d["id"], d["name"], parse_data_type(d["type"]),
                         d.get("description"), d.get("defaultValue"))

    def __eq__(self, other):
        return (isinstance(other, DataField) and self.id == other.id
                and self.name == other.name and self.type == other.type
                and self.description == other.description
                and self.default_value == other.default_value)

    def __hash__(self):
        return hash((self.id, self.name, str(self.type)))

    def __repr__(self):
        return f"DataField({self.id}, {self.name!r}, {self.type})"


class RowType(DataType):
    root = DataTypeRoot.ROW

    def __init__(self, fields: List[DataField], nullable: bool = True):
        super().__init__(nullable)
        self.fields = list(fields)

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def of(*args, nullable: bool = True) -> "RowType":
        """RowType.of(name, type, name, type, ...) or RowType.of(fields)."""
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            return RowType(list(args[0]), nullable)
        fields = []
        for i in range(0, len(args), 2):
            fields.append(DataField(i // 2, args[i], args[i + 1]))
        return RowType(fields, nullable)

    @staticmethod
    def builder() -> "RowTypeBuilder":
        return RowTypeBuilder()

    # -- access --------------------------------------------------------------

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def field_types(self) -> List[DataType]:
        return [f.type for f in self.fields]

    def field_count(self) -> int:
        return len(self.fields)

    def get_field(self, name: str) -> DataField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def get_field_by_id(self, fid: int) -> DataField:
        for f in self.fields:
            if f.id == fid:
                return f
        raise KeyError(fid)

    def get_field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        return -1

    def project(self, names: List[str]) -> "RowType":
        return RowType([self.get_field(n) for n in names], self.nullable)

    def highest_field_id(self) -> int:
        return _highest_field_id(self)

    # -- serde ---------------------------------------------------------------

    def _name(self):
        inner = ", ".join(f"`{f.name}` {f.type}" for f in self.fields)
        return f"ROW<{inner}>"

    def to_json(self):
        return {"type": "ROW" + ("" if self.nullable else " NOT NULL"),
                "fields": [f.to_json() for f in self.fields]}

    def __eq__(self, other):
        return (isinstance(other, RowType) and self.nullable == other.nullable
                and self.fields == other.fields)

    def __hash__(self):
        return hash(tuple(self.fields))


class RowTypeBuilder:
    def __init__(self):
        self._fields: List[DataField] = []
        self._next_id = 0

    def field(self, name: str, type: DataType,
              description: Optional[str] = None) -> "RowTypeBuilder":
        self._fields.append(DataField(self._next_id, name, type, description))
        self._next_id += 1
        return self

    def build(self) -> RowType:
        return RowType(self._fields)


def _highest_field_id(row: RowType) -> int:
    highest = -1

    def visit(t: DataType):
        nonlocal highest
        if isinstance(t, RowType):
            for f in t.fields:
                if f.id < SYSTEM_FIELD_ID_START:
                    highest = max(highest, f.id)
                visit(f.type)
        elif isinstance(t, (ArrayType, MultisetType, VectorType)):
            visit(t.element)
        elif isinstance(t, MapType):
            visit(t.key)
            visit(t.value)

    visit(row)
    return highest


# ---------------------------------------------------------------------------
# Parsing (reference types/DataTypeJsonParser.java)
# ---------------------------------------------------------------------------

_ATOMIC_RE = re.compile(
    r"^\s*([A-Z ]+?)\s*(?:\(\s*(\d+)\s*(?:,\s*(\d+)\s*)?\))?"
    r"(\s+WITH LOCAL TIME ZONE)?(\s+NOT NULL)?\s*$")

_SIMPLE_TYPES = {
    "BOOLEAN": BooleanType, "TINYINT": TinyIntType, "SMALLINT": SmallIntType,
    "INT": IntType, "INTEGER": IntType, "BIGINT": BigIntType,
    "FLOAT": FloatType, "DOUBLE": DoubleType, "DATE": DateType,
    "BLOB": BlobType, "VARIANT": VariantType,
    "STRING": lambda nullable=True: VarCharType(VarCharType.MAX_LENGTH,
                                                nullable),
    "BYTES": lambda nullable=True: VarBinaryType(VarBinaryType.MAX_LENGTH,
                                                 nullable),
}


def parse_data_type(j) -> DataType:
    """Parse JSON (string or dict) into a DataType."""
    if isinstance(j, str) and ("<" in j or j.lstrip().upper().startswith("ROW(")):
        return parse_type_string(j)
    if isinstance(j, dict):
        type_str = j["type"]
        nullable = not type_str.endswith(" NOT NULL")
        root = type_str[:-len(" NOT NULL")] if not nullable else type_str
        root = root.strip()
        if root == "ARRAY":
            return ArrayType(parse_data_type(j["element"]), nullable)
        if root == "MULTISET":
            return MultisetType(parse_data_type(j["element"]), nullable)
        if root == "MAP":
            return MapType(parse_data_type(j["key"]),
                           parse_data_type(j["value"]), nullable)
        if root == "ROW":
            return RowType([DataField.from_json(f) for f in j["fields"]],
                           nullable)
        if root == "VECTOR":
            return VectorType(parse_data_type(j["element"]), j["length"],
                              nullable)
        raise ValueError(f"Unknown complex type: {type_str}")
    return _parse_atomic(j)


def parse_type_string(s: str) -> DataType:
    """Parse the SQL string form of a (possibly nested) data type.

    Accepts `ARRAY<T>`, `MULTISET<T>`, `MAP<K, V>`, `ROW<name T, ...>`
    (also `ROW(name T, ...)`), `VECTOR<T, n>`, and every atomic form
    `_parse_atomic` accepts, with `NOT NULL` at any nesting level.
    Mirrors reference types/DataTypeJsonParser.java's string grammar.
    """
    t, pos = _parse_type_str(s, 0)
    if s[pos:].strip():
        raise ValueError(f"Trailing input in data type: {s!r}")
    return t


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i].isspace():
        i += 1
    return i


_TYPE_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_ ]*")


def _parse_not_null(s: str, i: int):
    j = _skip_ws(s, i)
    if s[j:j + 8].upper() == "NOT NULL":
        return False, j + 8
    return True, i


def _parse_type_str(s: str, i: int):
    i = _skip_ws(s, i)
    m = _TYPE_WORD_RE.match(s, i)
    if not m:
        raise ValueError(f"Cannot parse data type: {s!r} at {i}")
    # the word regex is greedy over spaces (multi-word atomics like
    # "DOUBLE PRECISION"); trim trailing keywords that belong to the parent
    word = m.group(0)
    head = word.split()[0].upper()
    if head in ("ARRAY", "MULTISET", "MAP", "ROW", "VECTOR"):
        i += len(head)
        i = _skip_ws(s, i)
        if head == "ROW" and i < len(s) and s[i] in "(<":
            close = ")" if s[i] == "(" else ">"
            i += 1
            fields = []
            while True:
                i = _skip_ws(s, i)
                fm = re.match(r"[A-Za-z_][A-Za-z0-9_]*|`[^`]+`", s[i:])
                if not fm:
                    raise ValueError(f"Expected field name at {i} in {s!r}")
                fname = fm.group(0).strip("`")
                i += fm.end()
                ftype, i = _parse_type_str(s, i)
                fields.append(DataField(len(fields), fname, ftype))
                i = _skip_ws(s, i)
                if i < len(s) and s[i] == ",":
                    i += 1
                    continue
                break
            if i >= len(s) or s[i] != close:
                raise ValueError(f"Expected {close!r} at {i} in {s!r}")
            i += 1
            nullable, i = _parse_not_null(s, i)
            return RowType(fields, nullable), i
        if i >= len(s) or s[i] != "<":
            raise ValueError(f"Expected '<' after {head} in {s!r}")
        i += 1
        if head == "MAP":
            k, i = _parse_type_str(s, i)
            i = _skip_ws(s, i)
            if i >= len(s) or s[i] != ",":
                raise ValueError(f"Expected ',' in MAP type: {s!r}")
            v, i = _parse_type_str(s, i + 1)
            out_cls = lambda nullable: MapType(k, v, nullable)  # noqa: E731
        elif head == "VECTOR":
            el, i = _parse_type_str(s, i)
            i = _skip_ws(s, i)
            if i >= len(s) or s[i] != ",":
                raise ValueError(f"Expected ',' in VECTOR type: {s!r}")
            i = _skip_ws(s, i + 1)
            nm = re.match(r"\d+", s[i:])
            if not nm:
                raise ValueError(f"Expected length in VECTOR type: {s!r}")
            length = int(nm.group(0))
            i += nm.end()
            out_cls = lambda nullable: VectorType(el, length, nullable)  # noqa: E731,E501
        else:
            el, i = _parse_type_str(s, i)
            cls = ArrayType if head == "ARRAY" else MultisetType
            out_cls = lambda nullable: cls(el, nullable)  # noqa: E731
        i = _skip_ws(s, i)
        if i >= len(s) or s[i] != ">":
            raise ValueError(f"Expected '>' at {i} in {s!r}")
        i += 1
        nullable, i = _parse_not_null(s, i)
        return out_cls(nullable), i
    # atomic: consume word + optional (p[,s]) + optional WITH LOCAL TIME
    # ZONE + optional NOT NULL, then delegate to the atomic matcher
    j = i + len(word)
    if j < len(s) and s[j] == "(":
        k = s.find(")", j)
        if k < 0:
            raise ValueError(f"Unterminated '(' in data type: {s!r}")
        j = k + 1
        k = _skip_ws(s, j)
        if s[k:k + 20].upper() == "WITH LOCAL TIME ZONE":
            j = k + 20
    atom = s[i:j]
    # word regex may have greedily eaten into ", name TYPE" of a parent ROW
    # — it can't, since ROW fields are split on ','. But it CAN eat a
    # trailing "NOT NULL" or "WITH LOCAL TIME ZONE"; _ATOMIC_RE handles
    # both, so pass them through.
    nullable = True
    rest = _skip_ws(s, j)
    if s[rest:rest + 8].upper() == "NOT NULL":
        atom = atom.rstrip() + " NOT NULL"
        j = rest + 8
    return _parse_atomic(atom.strip()), j


def _parse_atomic(s: str) -> DataType:
    m = _ATOMIC_RE.match(s)
    if not m:
        raise ValueError(f"Cannot parse data type: {s!r}")
    name, p1, p2, ltz, notnull = m.groups()
    name = name.strip()
    nullable = notnull is None
    if name == "TIMESTAMP" and ltz:
        return LocalZonedTimestampType(int(p1) if p1 else 6, nullable)
    if name in _SIMPLE_TYPES:
        return _SIMPLE_TYPES[name](nullable=nullable)
    if name == "CHAR":
        return CharType(int(p1) if p1 else 1, nullable)
    if name == "VARCHAR":
        return VarCharType(int(p1) if p1 else VarCharType.MAX_LENGTH, nullable)
    if name == "BINARY":
        return BinaryType(int(p1) if p1 else 1, nullable)
    if name == "VARBINARY":
        return VarBinaryType(int(p1) if p1 else VarBinaryType.MAX_LENGTH,
                             nullable)
    if name == "DECIMAL" or name == "NUMERIC":
        return DecimalType(int(p1) if p1 else 10, int(p2) if p2 else 0,
                           nullable)
    if name == "TIME":
        return TimeType(int(p1) if p1 else 0, nullable)
    if name == "TIMESTAMP":
        return TimestampType(int(p1) if p1 else 6, nullable)
    raise ValueError(f"Unknown atomic type: {s!r}")


# ---------------------------------------------------------------------------
# Arrow mapping (role of reference paimon-arrow ArrowUtils)
# ---------------------------------------------------------------------------

def data_type_to_arrow(t: DataType) -> pa.DataType:
    if isinstance(t, BooleanType):
        return pa.bool_()
    if isinstance(t, TinyIntType):
        return pa.int8()
    if isinstance(t, SmallIntType):
        return pa.int16()
    if isinstance(t, IntType):
        return pa.int32()
    if isinstance(t, BigIntType):
        return pa.int64()
    if isinstance(t, FloatType):
        return pa.float32()
    if isinstance(t, DoubleType):
        return pa.float64()
    if isinstance(t, (CharType, VarCharType)):
        return pa.string()
    if isinstance(t, VariantType):
        # single source of truth for the on-disk variant shape
        from paimon_tpu_torch.data.variant import variant_arrow_type
        return variant_arrow_type()
    if isinstance(t, (BinaryType, VarBinaryType, BlobType)):
        return pa.binary()
    if isinstance(t, DecimalType):
        return pa.decimal128(t.precision, t.scale)
    if isinstance(t, DateType):
        return pa.date32()
    if isinstance(t, TimeType):
        return pa.time32("ms") if t.precision <= 3 else pa.time64("us")
    if isinstance(t, TimestampType):
        return pa.timestamp(_ts_unit(t.precision))
    if isinstance(t, LocalZonedTimestampType):
        return pa.timestamp(_ts_unit(t.precision), tz="UTC")
    if isinstance(t, ArrayType):
        return pa.list_(data_type_to_arrow(t.element))
    if isinstance(t, VectorType):
        return pa.list_(data_type_to_arrow(t.element), t.length)
    if isinstance(t, MultisetType):
        return pa.map_(data_type_to_arrow(t.element), pa.int32())
    if isinstance(t, MapType):
        return pa.map_(data_type_to_arrow(t.key), data_type_to_arrow(t.value))
    if isinstance(t, RowType):
        return pa.struct([pa.field(f.name, data_type_to_arrow(f.type),
                                   f.type.nullable) for f in t.fields])
    raise ValueError(f"No arrow mapping for {t}")


def _ts_unit(precision: int) -> str:
    if precision <= 3:
        return "ms"
    if precision <= 6:
        return "us"
    return "ns"


def row_type_to_arrow_schema(row: RowType) -> pa.Schema:
    return pa.schema([pa.field(f.name, data_type_to_arrow(f.type),
                               f.type.nullable) for f in row.fields])


def data_type_from_arrow(t: pa.DataType, nullable: bool = True) -> DataType:
    if pa.types.is_boolean(t):
        return BooleanType(nullable)
    if pa.types.is_int8(t):
        return TinyIntType(nullable)
    if pa.types.is_int16(t):
        return SmallIntType(nullable)
    if pa.types.is_int32(t):
        return IntType(nullable)
    if pa.types.is_int64(t):
        return BigIntType(nullable)
    if pa.types.is_float32(t):
        return FloatType(nullable)
    if pa.types.is_float64(t):
        return DoubleType(nullable)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return VarCharType(VarCharType.MAX_LENGTH, nullable)
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return VarBinaryType(VarBinaryType.MAX_LENGTH, nullable)
    if pa.types.is_decimal(t):
        return DecimalType(t.precision, t.scale, nullable)
    if pa.types.is_date(t):
        return DateType(nullable)
    if pa.types.is_time(t):
        return TimeType(3, nullable)
    if pa.types.is_timestamp(t):
        prec = {"s": 0, "ms": 3, "us": 6, "ns": 9}[t.unit]
        if t.tz:
            return LocalZonedTimestampType(prec, nullable)
        return TimestampType(prec, nullable)
    if isinstance(t, pa.FixedSizeListType):
        return VectorType(data_type_from_arrow(t.value_type), t.list_size,
                          nullable)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return ArrayType(data_type_from_arrow(t.value_type), nullable)
    if pa.types.is_map(t):
        return MapType(data_type_from_arrow(t.key_type),
                       data_type_from_arrow(t.item_type), nullable)
    if pa.types.is_struct(t):
        fields = [DataField(i, f.name,
                            data_type_from_arrow(f.type, f.nullable))
                  for i, f in enumerate(t)]
        return RowType(fields, nullable)
    raise ValueError(f"No paimon mapping for arrow type {t}")


def arrow_schema_to_row_type(schema: pa.Schema) -> RowType:
    fields = [DataField(i, f.name, data_type_from_arrow(f.type, f.nullable))
              for i, f in enumerate(schema)]
    return RowType(fields)


class SpecialFields:
    """System fields in KV data files
    (reference paimon-api/.../table/SpecialFields.java:76-93)."""

    KEY_FIELD_PREFIX = "_KEY_"
    KEY_FIELD_ID_START = SYSTEM_FIELD_ID_START

    SEQUENCE_NUMBER = DataField(2147483646, "_SEQUENCE_NUMBER",
                                BigIntType(False))
    VALUE_KIND = DataField(2147483645, "_VALUE_KIND", TinyIntType(False))
    LEVEL = DataField(2147483644, "_LEVEL", IntType(False))
    ROW_ID = DataField(2147483643, "_ROW_ID", BigIntType())

    @staticmethod
    def key_field(f: DataField) -> DataField:
        return DataField(f.id + SpecialFields.KEY_FIELD_ID_START,
                         SpecialFields.KEY_FIELD_PREFIX + f.name,
                         f.type.copy(False) if isinstance(f.type, DataType)
                         else f.type)
