"""Self-contained TFRecord + tf.train.Example codec (no tensorflow).

The port's own copy of ``joshupscale_tpu/data/tfrecord.py``.  The
reference's datasets are TFRecord files of ``tf.train.Example`` protos
(reference scripts/training/dataset.py:50-68 reads them via
``tf.data.TFRecordDataset``; :194-216 parses pair/single examples).
The port reads and writes them without tensorflow:

- record framing: the public TFRecord format -- ``uint64le length,
  uint32le masked-crc32c(length), payload, uint32le
  masked-crc32c(payload)``; a GZIP or ZLIB file (tensorflow's
  ``compression_type``) is this framing compressed as a whole, and
  ``read_records`` decompresses it as it reads with the stdlib's
  ``gzip`` / ``zlib``;
- ``tf.train.Example``: hand-encoded/decoded with the protobuf wire
  format (schema: Example{features=1}, Features{map<string,Feature>
  feature=1}, Feature{bytes_list=1|float_list=2|int64_list=3}, each
  list ``repeated value = 1``) on the wire primitives of
  :mod:`joshupscale_torch.export.onnx_minimal`;
- CRC32C (Castagnoli): table-driven, byte by byte for short inputs and
  in chunks side by side (numpy) for long ones -- a PNG-frame Example
  of tens of MB is written in well under a second.  Length CRCs (12
  bytes/record) are always verified; payload CRCs only when
  ``verify=True``.

Files and Examples written here are byte for byte the JAX package's
(and tensorflow's) for the same records.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import (
    Any, Dict, Iterable, Iterator, List, Optional, Sequence, Union,
)

import numpy as np

from joshupscale_torch.export.onnx_minimal import (
    _len_field,
    _read_varint,
    _str_field,
    _tag,
    _varint,
    parse_message,
)

# ---------------------------------------------------------------------
# CRC32C (Castagnoli, reflected, poly 0x82F63B78) + TFRecord masking


def _make_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _make_table()


_NP_TABLE = np.asarray(_TABLE, np.uint32)
# Below this many bytes the byte loop is quicker than the chunked form.
_CHUNKED_MIN = 1 << 16


def _crc_update(crc: int, data) -> int:
    """The CRC register after ``data`` (no pre/post inversion)."""
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _crc_rows(states: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The CRC registers after each row of ``rows`` (N, L) uint8, from
    ``states`` (N,) uint32: all rows a byte at a time, side by side."""
    crc = states.astype(np.uint32)
    for col in rows.T:
        crc = _NP_TABLE[(crc ^ col) & 0xFF] ^ (crc >> 8)
    return crc


def _crc_chunked(crc: int, data: bytes) -> int:
    """``_crc_update`` for long inputs.  The register is linear over
    GF(2): the register after ``A + B`` is ``shift(register after A) ^
    register of B from 0``, where ``shift`` runs ``len(B)`` zero bytes
    (a 32x32 bit matrix, held as the images of the 32 unit vectors).  So
    the data is cut into N chunks of L bytes, each chunk's register from
    0 is computed side by side (``_crc_rows``), and the chunks are
    chained with the matrix; the head of ``len % L`` bytes goes first,
    byte by byte.  The same CRC as the byte loop, bit for bit."""
    n = len(data)
    length = max(1024, int((n / 2) ** 0.5))
    head = n % length
    crc = _crc_update(crc, data[:head])
    chunks = np.frombuffer(data, np.uint8, offset=head).reshape(-1, length)
    parts = _crc_rows(np.zeros(len(chunks), np.uint32), chunks)
    unit = _crc_rows(np.uint32(1) << np.arange(32, dtype=np.uint32),
                     np.zeros((32, length), np.uint8)).tolist()
    for part in parts.tolist():
        shifted = 0
        for bit in range(32):
            if crc >> bit & 1:
                shifted ^= unit[bit]
        crc = shifted ^ part
    return crc


def crc32c(data: bytes) -> int:
    """CRC32C; known answer crc32c(b"123456789")=0xE3069283.  Inputs of
    64 KiB and more take the chunked form (~50 MB/s instead of ~5)."""
    if len(data) >= _CHUNKED_MIN:
        return _crc_chunked(0xFFFFFFFF, bytes(data)) ^ 0xFFFFFFFF
    return _crc_update(0xFFFFFFFF, data) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset masking of the raw CRC."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------
# Record framing


def write_records(path: str, records: Iterable[bytes]) -> int:
    """Write serialized records as an (uncompressed) TFRecord file."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
            n += 1
    return n


COMPRESSION_TYPES = (None, "", "GZIP", "ZLIB")


def check_compression_type(compression_type: Optional[str]) -> None:
    """Raise ``ValueError`` unless ``compression_type`` is one that
    ``read_records`` reads: None or "" (no compression), "GZIP" or
    "ZLIB", as tensorflow spells them."""
    if compression_type not in COMPRESSION_TYPES:
        raise ValueError(
            f"unsupported compression_type {compression_type!r}; expected "
            f"one of {COMPRESSION_TYPES}")


class _ZlibReader:
    """``read(n)`` over a zlib stream (tensorflow's ZLIB TFRecords: one
    zlib-wrapped deflate stream), decompressed in bounded chunks."""

    def __init__(self, f):
        self._f = f
        self._d = zlib.decompressobj()
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        while len(self._buf) < n and not self._d.eof:
            chunk = self._d.unconsumed_tail or self._f.read(1 << 16)
            if not chunk:
                break
            self._buf += self._d.decompress(chunk, 1 << 20)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def close(self) -> None:
        self._f.close()


def _open(path: str, compression_type: Optional[str]):
    check_compression_type(compression_type)
    if compression_type == "GZIP":
        return gzip.open(path, "rb")
    if compression_type == "ZLIB":
        return _ZlibReader(open(path, "rb"))
    return open(path, "rb")


def read_records(path: str, verify: bool = False,
                 compression_type: Optional[str] = None) -> Iterator[bytes]:
    """Yield serialized records; length CRCs always checked.
    ``compression_type``: None or "" for a plain file, "GZIP" or
    "ZLIB" for a compressed one (``check_compression_type``)."""
    f = _open(path, compression_type)
    try:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc32c(header):
                raise ValueError(f"{path}: corrupt record length")
            payload = f.read(length)
            if len(payload) != length:
                raise ValueError(f"{path}: truncated record payload")
            (pcrc,) = struct.unpack("<I", f.read(4))
            if verify and pcrc != masked_crc32c(payload):
                raise ValueError(f"{path}: corrupt record payload")
            yield payload
    finally:
        f.close()


# ---------------------------------------------------------------------
# tf.train.Example

FeatureValue = Union[Sequence[bytes], Sequence[float], Sequence[int]]


def _encode_feature(values: FeatureValue,
                    kind: Optional[str] = None) -> bytes:
    """kind: optional explicit 'bytes'/'float'/'int64' (needed for empty
    lists, which otherwise default to int64_list)."""
    vals = list(values)
    if kind is None and vals:
        v0 = vals[0]
        if isinstance(v0, (bytes, bytearray)):
            kind = "bytes"
        elif isinstance(v0, (float, np.floating)):
            kind = "float"
        elif isinstance(v0, (int, np.integer)):
            kind = "int64"
        else:
            raise TypeError(
                f"Unsupported feature value type {type(v0).__name__}"
            )
    if kind == "bytes":
        body = b"".join(_len_field(1, bytes(v)) for v in vals)
        return _len_field(1, body)  # Feature.bytes_list
    if kind == "float":
        packed = struct.pack(f"<{len(vals)}f", *(float(v) for v in vals))
        return _len_field(2, _len_field(1, packed))  # Feature.float_list
    # packed repeated int64 (what the protobuf runtime emits)
    body = b"".join(_varint(int(v)) for v in vals)
    return _len_field(3, _len_field(1, body))  # Feature.int64_list


def encode_example(features: Dict[str, FeatureValue],
                   kinds: Optional[Dict[str, str]] = None) -> bytes:
    """Serialize a tf.train.Example (bytes/float/int64 lists by type).

    ``kinds``: optional per-key 'bytes'/'float'/'int64' override --
    the only way to give an EMPTY list the right oneof (an empty list
    with no hint encodes as int64_list, which a consumer parsing a
    string/float feature rejects)."""
    entries = b""
    for key, values in features.items():
        feat = _encode_feature(values, (kinds or {}).get(key))
        entry = _str_field(1, key) + _len_field(2, feat)
        entries += _len_field(1, entry)  # Features.feature map entry
    return _len_field(1, entries)  # Example.features


def _decode_floats(buf: bytes) -> List[float]:
    fields = parse_message(buf)
    out: List[float] = []
    for v in fields.get(1, []):
        # packed (wire 2) and unpacked fixed32 (wire 5) both arrive as
        # raw little-endian bytes from parse_message
        out.extend(struct.unpack(f"<{len(v) // 4}f", v))
    return out


def _decode_ints(buf: bytes) -> List[int]:
    fields = parse_message(buf)
    out: List[int] = []
    for v in fields.get(1, []):
        if isinstance(v, bytes):  # packed varints
            pos = 0
            while pos < len(v):
                val, pos = _read_varint(v, pos)
                out.append(val - (1 << 64) if val >= 1 << 63 else val)
        else:
            out.append(v - (1 << 64) if v >= 1 << 63 else v)
    return out


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example into {key: list-of-values}."""
    example = parse_message(buf)
    out: Dict[str, FeatureValue] = {}
    for features_buf in example.get(1, []):
        for entry_buf in parse_message(features_buf).get(1, []):
            entry = parse_message(entry_buf)
            key = entry[1][0].decode()
            feature = parse_message(entry[2][0])
            if 1 in feature:  # bytes_list
                out[key] = parse_message(feature[1][0]).get(1, [])
            elif 2 in feature:  # float_list
                out[key] = _decode_floats(feature[2][0])
            elif 3 in feature:  # int64_list
                out[key] = _decode_ints(feature[3][0])
            else:
                out[key] = []
    return out


def parse_fixed_len(buf: bytes, spec: Dict[str, int]) -> Dict[str, Any]:
    """tf.io.parse_single_example analog for FixedLenFeature lists.

    ``spec`` maps feature name -> expected list length (reference
    dataset.py:194-216 uses ``FixedLenFeature([10], tf.string)``).
    """
    decoded = decode_example(buf)
    out = {}
    for key, n in spec.items():
        if key not in decoded:
            raise KeyError(f"Example is missing feature {key!r}")
        if len(decoded[key]) != n:
            raise ValueError(
                f"Feature {key!r}: expected {n} values, "
                f"got {len(decoded[key])}")
        out[key] = decoded[key]
    return out
