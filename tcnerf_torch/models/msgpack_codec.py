"""Reader and writer for the part of msgpack that flax's checkpoints use.

`flax.serialization.to_bytes` writes a params tree as one msgpack map whose
keys are strings and whose values are maps or arrays; the tree of a
component that is one array (a grasp model's `hash_tables`) is that array
alone, the top-level object. An array is an ext
object of type 1 (type 3: a numpy scalar) whose payload is itself a packed
3-array `[shape (array of uints), dtype name (str), data (bin)]`. A leaf
larger than `MAX_CHUNK_SIZE` bytes is written as a map
`{"__msgpack_chunked_array__": true, "shape": {"0": d0, ...}, "chunks":
{"0": <1-d array>, ...}}`.

    tree = loads(buf)            # nested dicts of numpy arrays
    buf = dumps(tree)            # the bytes flax's to_bytes writes

The card's machine has neither `msgpack` nor `flax`, so this module needs
only numpy and torch. Leaves are numpy arrays, except bfloat16 ones, which
numpy cannot hold: they are read as uint16 and returned as
`torch.bfloat16` tensors, and a `torch.bfloat16` tensor (or any CPU
tensor) is written under its dtype's name. A read parses the header bytes
only: each leaf is `np.frombuffer` on a slice of the one buffer the file
was read into; a write joins the leaves' bytes once.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: leaves above it are chunked
MAX_CHUNK_SIZE = 2 ** 30

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_FIXEXT_SIZE = {code: n for n, code in _FIXEXT.items()}


# ------------------------------------------------------------------ reading

class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError(f"msgpack: truncated at byte {self.pos}")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _byte(self) -> int:
        b = self.mv[self.pos] if self.pos < len(self.mv) else None
        if b is None:
            raise ValueError(f"msgpack: truncated at byte {self.pos}")
        self.pos += 1
        return b

    def _str(self, b: int) -> str:
        if 0xA0 <= b <= 0xBF:
            n = b & 0x1F
        elif b in (0xD9, 0xDA, 0xDB):
            n = self._uint(1 << (b - 0xD9))
        else:
            raise ValueError(f"msgpack: expected a str, got type byte "
                             f"{b:#04x} at byte {self.pos - 1}")
        return bytes(self._take(n)).decode("utf-8")

    def _int(self, b: int) -> int:
        if b <= 0x7F:
            return b
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        raise ValueError(f"msgpack: expected an unsigned int, got type byte "
                         f"{b:#04x} at byte {self.pos - 1}")

    def _map_len(self, b: int) -> int:
        if 0x80 <= b <= 0x8F:
            return b & 0x0F
        if b == 0xDE:
            return self._uint(2)
        if b == 0xDF:
            return self._uint(4)
        raise ValueError(f"msgpack: expected a map, got type byte {b:#04x} "
                         f"at byte {self.pos - 1}")

    def _array_len(self, b: int) -> int:
        if 0x90 <= b <= 0x9F:
            return b & 0x0F
        if b == 0xDC:
            return self._uint(2)
        if b == 0xDD:
            return self._uint(4)
        raise ValueError(f"msgpack: expected an array, got type byte "
                         f"{b:#04x} at byte {self.pos - 1}")

    def _ext(self, b: int) -> Tuple[int, memoryview]:
        if b in _FIXEXT_SIZE:
            n = _FIXEXT_SIZE[b]
        elif b in (0xC7, 0xC8, 0xC9):
            n = self._uint(1 << (b - 0xC7))
        else:
            raise ValueError(f"msgpack: expected an ext, got type byte "
                             f"{b:#04x} at byte {self.pos - 1}")
        code = self._byte()
        return code, self._take(n)

    def _bin(self) -> memoryview:
        b = self._byte()
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError(f"msgpack: expected bin data, got type byte "
                             f"{b:#04x} at byte {self.pos - 1}")
        return self._take(self._uint(1 << (b - 0xC4)))

    def _array(self, payload: memoryview):
        """An ext payload `[shape, dtype name, data]` -> its array."""
        sub = _Reader(payload)
        if sub._array_len(sub._byte()) != 3:
            raise ValueError("msgpack: an ndarray payload is a 3-array")
        shape = tuple(sub._int(sub._byte())
                      for _ in range(sub._array_len(sub._byte())))
        name = sub._str(sub._byte())
        data = sub._bin()
        if name == "bfloat16":
            a = np.frombuffer(data, np.uint16).reshape(shape)
            return torch.from_numpy(a.copy()).view(torch.bfloat16)
        return np.frombuffer(data, np.dtype(name)).reshape(shape)

    def value(self, path: str):
        b = self._byte()
        if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
            return self.map(b, path)
        if b in _FIXEXT_SIZE or b in (0xC7, 0xC8, 0xC9):
            code, payload = self._ext(b)
            if code not in (EXT_NDARRAY, EXT_NPSCALAR):
                raise ValueError(f"msgpack: ext type {code} at {path!r} is "
                                 "not an ndarray (1) or numpy scalar (3)")
            return self._array(payload)
        if b == 0xC3:
            return True
        if b <= 0x7F or 0xCC <= b <= 0xCF:
            return self._int(b)
        raise ValueError(f"msgpack: type byte {b:#04x} at {path!r} (byte "
                         f"{self.pos - 1}) is outside flax's checkpoint "
                         "subset")

    def map(self, b: int, path: str = "") -> Dict:
        out = {}
        for _ in range(self._map_len(b)):
            key = self._str(self._byte())
            out[key] = self.value(f"{path}/{key}" if path else key)
        if CHUNKED in out:
            return _unchunk(out, path)
        return out


def _unchunk(node: Dict, path: str):
    """flax's chunked form of a leaf -> the leaf."""
    try:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            flat = torch.cat([torch.as_tensor(c).reshape(-1) for c in chunks])
        else:
            flat = np.concatenate([np.reshape(c, -1) for c in chunks])
        return flat.reshape(shape)
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise ValueError(f"msgpack: malformed chunked array at {path!r}: "
                         f"{e}") from e


def loads(buf):
    """The tree of one flax checkpoint blob (bytes, bytearray or memoryview):
    a map, or the array of a one-array component (the leaves are views
    into the blob, writable when it is)."""
    r = _Reader(buf)
    tree = r.value("")
    if not isinstance(tree, (dict, np.ndarray, torch.Tensor)):
        raise ValueError(f"msgpack: a checkpoint is a map or an array, not "
                         f"{type(tree).__name__}")
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack: {len(r.mv) - r.pos} bytes after the "
                         "tree")
    return tree


def read(path: str) -> Dict:
    """`loads` of a file, read with one `readinto` into a writable buffer."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return loads(buf)


# ------------------------------------------------------------------ writing

def _len_header(n: int, fix: Optional[int], fix_max: int,
                codes: Tuple[Optional[int], ...]) -> bytes:
    """The smallest header for length `n`: `fix | n` up to `fix_max`, else
    the first of the 1-, 2- and 4-byte length codes that holds it."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"msgpack: length {n} too large")


def _str_bytes(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _len_header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw


def _uint_bytes(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"msgpack: negative int {v} outside the subset")
    if v < 0x80:
        return bytes([v])
    for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
        if v < 1 << (8 * width):
            return bytes([code]) + v.to_bytes(width, "big")
    raise ValueError(f"msgpack: int {v} too large")


def _leaf_data(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array or CPU tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            raise ValueError("msgpack: write CPU tensors (got one on "
                             f"{t.device})")
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            a, name = t.view(torch.int16).numpy(), "bfloat16"
        else:
            a = t.numpy()
            name = a.dtype.name
    else:
        # not ascontiguousarray, which makes a 0-d array 1-d
        a = np.asarray(x)
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError("msgpack: object and structured dtypes are not "
                             "arrays flax writes")
        name = a.dtype.name
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    return tuple(int(d) for d in a.shape), name, memoryview(
        a.reshape(-1)).cast("B")


def _pack_array(parts: List, x, code: int) -> None:
    shape, name, data = _leaf_data(x)
    head = (bytes([0x93])
            + _len_header(len(shape), 0x90, 15, (None, 0xDC, 0xDD))
            + b"".join(_uint_bytes(d) for d in shape) + _str_bytes(name)
            + _len_header(len(data), None, -1, (0xC4, 0xC5, 0xC6)))
    n = len(head) + len(data)
    if n in _FIXEXT:
        ext = bytes([_FIXEXT[n], code])
    else:
        ext = _len_header(n, None, -1, (0xC7, 0xC8, 0xC9)) + bytes([code])
    parts += [ext, head, data]


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def _chunked(x) -> Dict:
    """flax's `_chunk`: the flat leaf in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else np.asarray(x).dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.shape[0], size))}}


def _pack(parts: List, node) -> None:
    if isinstance(node, Mapping):
        parts.append(_len_header(len(node), 0x80, 15, (None, 0xDE, 0xDF)))
        for key, value in node.items():
            if not isinstance(key, str):
                raise ValueError(f"msgpack: key {key!r} is not a str")
            parts.append(_str_bytes(key))
            if (isinstance(value, (np.ndarray, torch.Tensor))
                    and _nbytes(value) > MAX_CHUNK_SIZE):
                value = _chunked(value)
            _pack(parts, value)
    elif node is True:
        parts.append(b"\xc3")
    elif isinstance(node, int) and not isinstance(node, bool):
        parts.append(_uint_bytes(node))
    elif isinstance(node, np.generic):
        _pack_array(parts, np.asarray(node), EXT_NPSCALAR)
    elif isinstance(node, (np.ndarray, torch.Tensor)):
        _pack_array(parts, node, EXT_NDARRAY)
    else:
        raise ValueError(f"msgpack: {type(node).__name__} is outside flax's "
                         "checkpoint subset")


def dumps(tree) -> bytes:
    """The bytes `flax.serialization.to_bytes(tree)` writes for a nested
    dict of arrays (key order kept) or one array, leaves above
    MAX_CHUNK_SIZE chunked."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        if _nbytes(tree) > MAX_CHUNK_SIZE:
            tree = _chunked(tree)
    elif not isinstance(tree, Mapping):
        raise ValueError("msgpack: a checkpoint is one top-level map or "
                         "array")
    parts: List = []
    _pack(parts, tree)
    return b"".join(parts)


def write(path: str, tree) -> int:
    """`dumps` into `path`; the number of bytes written."""
    blob = dumps(tree)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)
