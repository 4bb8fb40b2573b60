"""Pure-python TF-checkpoint (tensor-bundle) interop — no TensorFlow needed.

The port's own copy of tcnerf/models/tf_checkpoint.py (numpy and `struct`
only); `import_component` copies the tree as plain nested dicts instead of
calling flax, and `export_component` takes the port's bfloat16 leaves (CPU
tensors) as float32, as numpy's bfloat16 arrays are written there.

The reference stores every model component with keras ``save_weights`` in
TF-checkpoint format: a leveldb-SSTable ``.index`` file mapping checkpoint
keys to BundleEntryProto records plus a raw ``.data-00000-of-00001`` shard
(reference: src/lib/mvnerf/model_v0.py:199-240 writes one such pair per
component). This module implements that format directly:

  * `read_bundle(prefix)`  -> {key: np.ndarray} — parse the SSTable footer /
    index block / data blocks, decode BundleEntryProto (hand-rolled varint
    protobuf reader), slice tensors out of the data shard.
  * `write_bundle(prefix, {key: array})` — the inverse (single uncompressed
    block, restart interval 1), to export trained weights into the
    reference's expected layout.
  * `keras_variable_keys(tree)` / `import_component(...)` — map the
    ``layer_with_weights-N/.../kernel/.ATTRIBUTES/VARIABLE_VALUE`` key space
    of keras subclassed models onto flax-layout param trees (`params.
    to_flax`).

Format notes (tensorflow/core/util/tensor_bundle + leveldb table_format):
  index file = leveldb table: blocks of prefix-compressed key/value entries
  with a restart array, a top-level index block addressing the data blocks,
  and a 48-byte footer (metaindex handle, index handle, magic
  0xdb4775248b80fb57). Bundle index tables are written uncompressed.
"""

from __future__ import annotations

import os
import struct
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48
_BLOCK_TRAILER_LEN = 5  # 1 byte compression type + 4 byte crc32c

# TF DataType enum values we support
_DTYPES = {
    1: np.dtype("float32"), 2: np.dtype("float64"), 3: np.dtype("int32"),
    4: np.dtype("uint8"), 5: np.dtype("int16"), 6: np.dtype("int8"),
    9: np.dtype("int64"), 10: np.dtype("bool"),
    19: np.dtype("float16"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"
VARIABLE_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


# --------------------------------------------------------------- varint codec

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


# --------------------------------------------------- minimal protobuf decoder

def _proto_fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """Decode a protobuf message into (field_number, wire_type, value)."""
    fields = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.append((field, wire, val))
    return fields


def _decode_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _, val in _proto_fields(buf):
        if field == 2:  # Dim message
            size = 0
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _decode_bundle_entry(buf: bytes) -> dict:
    """BundleEntryProto: dtype(1) shape(2) shard_id(3) offset(4) size(5)."""
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0}
    for field, _, val in _proto_fields(buf):
        if field == 1:
            entry["dtype"] = val
        elif field == 2:
            entry["shape"] = _decode_shape(val)
        elif field == 3:
            entry["shard_id"] = val
        elif field == 4:
            entry["offset"] = val
        elif field == 5:
            entry["size"] = val
    return entry


def _encode_tag(field: int, wire: int) -> bytes:
    return _write_varint(field << 3 | wire)


def _encode_bundle_entry(dtype_code: int, shape: Sequence[int], offset: int,
                         size: int) -> bytes:
    shape_msg = b""
    for d in shape:
        dim_msg = _encode_tag(1, 0) + _write_varint(int(d))
        shape_msg += _encode_tag(2, 2) + _write_varint(len(dim_msg)) + dim_msg
    out = _encode_tag(1, 0) + _write_varint(dtype_code)
    out += _encode_tag(2, 2) + _write_varint(len(shape_msg)) + shape_msg
    if offset:
        out += _encode_tag(4, 0) + _write_varint(offset)
    out += _encode_tag(5, 0) + _write_varint(size)
    return out


def _encode_bundle_header(num_shards: int = 1) -> bytes:
    # BundleHeaderProto: num_shards(1), endianness(2=LITTLE default),
    # version(3: VersionDef{producer(1)=1})
    version = _encode_tag(1, 0) + _write_varint(1)
    return (_encode_tag(1, 0) + _write_varint(num_shards)
            + _encode_tag(3, 2) + _write_varint(len(version)) + version)


# ----------------------------------------------------------- sstable reading

def _parse_block(buf: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode one leveldb block (without trailer) into (key, value) pairs."""
    if len(buf) < 4:
        return []
    num_restarts = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    data_end = len(buf) - 4 - 4 * num_restarts
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(buf, pos)
        unshared, pos = _read_varint(buf, pos)
        value_len, pos = _read_varint(buf, pos)
        key = key[:shared] + buf[pos:pos + unshared]
        pos += unshared
        value = buf[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_block(data: bytes, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    block = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype != 0:
        raise ValueError(
            f"compressed tensor-bundle block (type {ctype}) unsupported — "
            "TF writes bundle index files uncompressed")
    return _parse_block(block)


def read_index(prefix: str) -> Dict[str, dict]:
    """Parse `<prefix>.index` into {checkpoint_key: BundleEntry dict}."""
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_LEN:
        raise ValueError(f"{prefix}.index too small for a tensor bundle")
    footer = data[-_FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, _FOOTER_LEN - 8)[0]
    if magic != _MAGIC:
        raise ValueError(f"{prefix}.index is not a TF tensor bundle "
                         f"(bad magic {magic:#x})")
    pos = 0
    _, pos = _read_varint(footer, pos)          # metaindex offset
    _, pos = _read_varint(footer, pos)          # metaindex size
    idx_offset, pos = _read_varint(footer, pos)
    idx_size, pos = _read_varint(footer, pos)

    entries: Dict[str, dict] = {}
    for _, handle in _read_block(data, idx_offset, idx_size):
        h_off, hp = _read_varint(handle, 0)
        h_size, _ = _read_varint(handle, hp)
        for key, value in _read_block(data, h_off, h_size):
            if key == b"":  # header entry
                continue
            entries[key.decode("utf-8")] = _decode_bundle_entry(value)
    return entries


def read_bundle(prefix: str,
                keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Read tensors from a TF checkpoint written by keras save_weights."""
    index = read_index(prefix)
    shards = sorted(
        f for f in os.listdir(os.path.dirname(prefix) or ".")
        if f.startswith(os.path.basename(prefix) + ".data-"))
    shard_paths = [os.path.join(os.path.dirname(prefix) or ".", s)
                   for s in shards]
    shard_data = [open(p, "rb").read() for p in shard_paths]
    out = {}
    wanted = set(keys) if keys is not None else None
    for key, entry in index.items():
        if key == OBJECT_GRAPH_KEY or (wanted and key not in wanted):
            continue
        if entry["dtype"] not in _DTYPES:
            continue  # strings / resources (e.g. the object-graph proto)
        dtype = _DTYPES[entry["dtype"]]
        raw = shard_data[entry["shard_id"]][
            entry["offset"]:entry["offset"] + entry["size"]]
        out[key] = np.frombuffer(raw, dtype=dtype).reshape(entry["shape"]).copy()
    return out


# ----------------------------------------------------------- sstable writing

def _block_bytes(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """Single leveldb block, no prefix compression (restart at every entry)."""
    out = bytearray()
    restarts = []
    for key, value in entries:
        restarts.append(len(out))
        out += _write_varint(0)            # shared
        out += _write_varint(len(key))     # unshared
        out += _write_varint(len(value))
        out += key
        out += value
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _crc32c_masked(payload: bytes) -> int:
    # TF verifies these lazily; zlib's crc32 is NOT crc32c, so write the
    # conventional "unverified" placeholder. Readers here never check crcs.
    return 0


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write `<prefix>.index` + `<prefix>.data-00000-of-00001`.

    Produces the reference-compatible layout (keras save_weights): sorted
    keys, BundleHeader under the empty key, raw little-endian tensor bytes.
    """
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    data = bytearray()
    index_entries: List[Tuple[bytes, bytes]] = []
    index_entries.append((b"", _encode_bundle_header(1)))
    for key in sorted(tensors):
        arr = np.ascontiguousarray(tensors[key])
        if arr.dtype not in _DTYPE_CODES:
            arr = arr.astype(np.float32)
        raw = arr.tobytes()
        entry = _encode_bundle_entry(_DTYPE_CODES[arr.dtype], arr.shape,
                                     len(data), len(raw))
        index_entries.append((key.encode("utf-8"), entry))
        data += raw
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))

    # assemble the sstable: one data block, one index block, footer
    out = bytearray()
    data_block = _block_bytes(index_entries)
    data_handle = _write_varint(0) + _write_varint(len(data_block))
    out += data_block
    out += bytes([0]) + struct.pack("<I", _crc32c_masked(data_block))

    meta_off = len(out)
    meta_block = _block_bytes([])
    out += meta_block
    out += bytes([0]) + struct.pack("<I", 0)

    idx_off = len(out)
    # index block: one entry whose key sorts >= every data key
    idx_block = _block_bytes([(b"\xff\xff\xff\xff", data_handle)])
    out += idx_block
    out += bytes([0]) + struct.pack("<I", 0)

    footer = bytearray()
    footer += _write_varint(meta_off) + _write_varint(len(meta_block))
    footer += _write_varint(idx_off) + _write_varint(len(idx_block))
    footer += b"\x00" * (_FOOTER_LEN - 8 - len(footer))
    footer += struct.pack("<Q", _MAGIC)
    out += footer
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(out))


# -------------------------------------------- keras object-path <-> flax tree

def _is_leaf_dict(node) -> bool:
    return isinstance(node, dict) and all(
        not isinstance(v, dict) for v in node.values())


def _keras_order(name: str) -> Tuple:
    """Sort key reproducing keras layer creation order for tcnerf modules:
    layer_0 / conv stems first, then indexed blocks in definition order."""
    import re

    m = re.match(r"(.*?)_(\d+)$", name)
    stem, idx = (m.group(1), int(m.group(2))) if m else (name, -1)
    # creation order of block families inside tcnerf modules (mirrors the
    # reference classes: embeddings create layer_0 -> feature -> fusion;
    # readouts create downscales -> combined -> blocks -> head)
    family_rank = {
        "layer": 0,
        "feature_block": 1, "fusion_block": 2, "block": 1,
        "activation_downscale": 0, "combined_activation_downscale": 1,
        "readout_block": 2, "readout_head": 3, "output_layer": 3,
    }.get(stem, 5)
    return (family_rank, stem, idx, name)


def keras_variable_keys(tree: dict, prefix: str = "") -> List[Tuple[Tuple[str, ...], str]]:
    """Enumerate (flax_path, keras_checkpoint_key) pairs for a component
    param tree, reproducing keras save_weights' `layer_with_weights-N`
    numbering (depth-first over weighted sublayers in creation order).

    Within a layer, weight order is creation order: kernel before bias,
    (scale, bias) for norms.
    """
    pairs: List[Tuple[Tuple[str, ...], str]] = []

    def leaf_rank(name: str) -> Tuple:
        order = {"kernel": 0, "scale": 0, "gamma": 0, "bias": 1, "beta": 1,
                 "mean": 2, "var": 3, "embedding": 0}
        return (order.get(name, 4), name)

    def visit(node: dict, path: Tuple[str, ...], kprefix: str):
        if _is_leaf_dict(node):
            for leaf in sorted(node, key=leaf_rank):
                pairs.append((path + (leaf,),
                              f"{kprefix}/{leaf}{VARIABLE_SUFFIX}"))
            return
        # a module: its weighted children are numbered layer_with_weights-N
        # in creation order; raw-array children (e.g. hash_tables) are
        # attribute-named variables of the module itself
        children = [(k, v) for k, v in node.items() if isinstance(v, dict)]
        arrays = [(k, v) for k, v in node.items() if not isinstance(v, dict)]
        for k, v in sorted(arrays, key=lambda kv: leaf_rank(kv[0])):
            pairs.append((path + (k,), f"{kprefix}/{k}{VARIABLE_SUFFIX}"
                          if kprefix else f"{k}{VARIABLE_SUFFIX}"))
        for n, (k, v) in enumerate(sorted(children,
                                          key=lambda kv: _keras_order(kv[0]))):
            child_prefix = (f"{kprefix}/layer_with_weights-{n}"
                            if kprefix else f"layer_with_weights-{n}")
            visit(v, path + (k,), child_prefix)

    visit(tree, (), "")
    return pairs


def export_component(prefix: str, tree: dict) -> None:
    """Write one component param tree as a reference-format TF checkpoint."""
    tensors = {}
    for path, key in keras_variable_keys(tree):
        node = tree
        for p in path:
            node = node[p]
        tensors[key] = (node.detach().cpu().float().numpy()
                        if hasattr(node, "detach") else np.asarray(node))
    write_bundle(prefix, tensors)


def _plain_copy(tree):
    """A mutable copy of the tree's maps (as plain dicts); leaves shared."""
    if isinstance(tree, Mapping):
        return {str(k): _plain_copy(v) for k, v in tree.items()}
    return tree


def import_component(prefix: str, tree: dict, strict: bool = True) -> dict:
    """Load a reference TF checkpoint for one component onto a flax tree.

    Maps `layer_with_weights-N` keys positionally (keras creation order) and
    validates every shape. Returns a new tree; raises on mismatch when
    strict, else loads the intersecting subset.
    """
    tensors = read_bundle(prefix)
    new_tree = _plain_copy(tree)
    missing, mismatched = [], []
    for path, key in keras_variable_keys(tree):
        if key not in tensors:
            missing.append(key)
            continue
        node = new_tree
        for p in path[:-1]:
            node = node[p]
        want = node[path[-1]]
        got = tensors[key]
        if tuple(np.shape(want)) != tuple(got.shape):
            mismatched.append((key, tuple(got.shape), tuple(np.shape(want))))
            continue
        node[path[-1]] = got.astype(np.asarray(want).dtype) \
            if hasattr(want, "dtype") else got
    if strict and (missing or mismatched):
        raise ValueError(
            f"TF-checkpoint import at {prefix}: missing keys {missing[:5]} "
            f"({len(missing)} total), shape mismatches {mismatched[:5]} "
            f"({len(mismatched)} total). Checkpoint keys: "
            f"{sorted(tensors)[:8]} ...")
    return new_tree
