"""flax's msgpack format (``flax.serialization``), read and written in pure
Python: the port's own coder for the JAX package's ``.msgpack`` files,
byte-compatible with flax's ``msgpack_serialize`` / ``to_bytes`` and
``msgpack_restore``. It needs neither flax nor the msgpack package.

The format is msgpack, written as msgpack-python writes it with
``strict_types=True`` (every int in its smallest form, Python floats as
float64, ``str`` / ``bytes`` / ``list`` / ``dict`` by their exact types,
dicts in their given order; a tuple is refused), plus three extension
types:

* 1, an ndarray: the payload is the msgpack array ``(shape, dtype name,
  raw C-order bytes)``;
* 2, a native complex: ``(real, imag)``;
* 3, a numpy scalar: an ndarray payload of its 0-d array.

An array of more than ``MAX_CHUNK_SIZE`` bytes that is a dict's value (or
the whole tree) is written as ``{"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": flat chunk, ...}}`` and reassembled
on read.

Decoded arrays are writable numpy arrays (each leaf copied once out of
the input; the input is walked through ``memoryview`` slices, never copied
per level). A ``bfloat16`` leaf, which numpy has no dtype for, decodes to
a ``torch.bfloat16`` tensor; torch tensors are written as the arrays they
hold (``bfloat16`` under its flax name).
"""

from __future__ import annotations

import struct
from typing import Any, List, NamedTuple

import numpy as np
import torch

__all__ = ["ExtType", "MAX_CHUNK_SIZE", "from_state_dict", "msgpack_restore",
           "msgpack_serialize", "pack_pieces", "to_bytes",
           "to_state_dict"]

# msgpack holds at most 2**31 - 1 bytes in one object; flax chunks larger
# arrays with this margin
MAX_CHUNK_SIZE = 2 ** 30
_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_RECURSE_LIMIT = 511           # msgpack-python's DEFAULT_RECURSE_LIMIT


class ExtType(NamedTuple):
    """An extension value of a type this format does not define."""
    code: int
    data: bytes


# ----------------------------------------------------------------- writing

def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return struct.pack("B", x)
    if -0x20 <= x < 0:
        return struct.pack("b", x)
    if 0x80 <= x <= 0xFF:
        return struct.pack("BB", 0xCC, x)
    if -0x80 <= x < 0:
        return struct.pack(">Bb", 0xD0, x)
    if 0xFF < x <= 0xFFFF:
        return struct.pack(">BH", 0xCD, x)
    if -0x8000 <= x < -0x80:
        return struct.pack(">Bh", 0xD1, x)
    if 0xFFFF < x <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, x)
    if -0x80000000 <= x < -0x8000:
        return struct.pack(">Bi", 0xD2, x)
    if 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, x)
    if -0x8000000000000000 <= x < -0x80000000:
        return struct.pack(">Bq", 0xD3, x)
    raise OverflowError("Integer value out of range")


def _sized(n: int, small, codes, what: str) -> bytes:
    """The header of a str / bin / array / map of length n: the fix form
    ``small(n)`` where it fits (None where there is none), else the 8-,
    16- or 32-bit length form."""
    if small is not None and n < small[0]:
        return struct.pack("B", small[1] | n)
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI"),
                                (0x100, 0x10000, 0x100000000)):
        if code is not None and n < limit:
            return struct.pack(fmt, code, n)
    raise ValueError(f"{what} is too large")


def _str_header(n):
    return _sized(n, (32, 0xA0), (0xD9, 0xDA, 0xDB), "String")


def _bin_header(n):
    return _sized(n, None, (0xC4, 0xC5, 0xC6), "bytes")


def _array_header(n):
    return _sized(n, (16, 0x90), (None, 0xDC, 0xDD), "list")


def _map_header(n):
    return _sized(n, (16, 0x80), (None, 0xDE, 0xDF), "dict")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    elif n <= 0xFFFFFFFF:
        head = struct.pack(">BI", 0xC9, n)
    else:
        raise ValueError("ext data is too large")
    return head + struct.pack("b", code)


def _array_bytes(x):
    """(shape, dtype name, C-order bytes as a memoryview) of an ndarray or
    a tensor, as flax's ``_ndarray_to_bytes`` packs them."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            flat = x.contiguous().view(torch.int16).numpy().reshape(-1)
            return tuple(x.shape), "bfloat16", memoryview(flat.view(np.uint8))
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    flat = np.ascontiguousarray(x).reshape(-1)
    return x.shape, x.dtype.name, memoryview(flat.view(np.uint8))


def _ndarray_ext(code: int, x, out: List) -> None:
    shape, name, data = _array_bytes(x)
    head = (_array_header(3) + _array_header(len(shape))
            + b"".join(_int(int(d)) for d in shape)
            + _str_header(len(name)) + name.encode() + _bin_header(data.nbytes))
    out += [_ext_header(code, len(head) + data.nbytes), head, data]


def _pack_default(obj, out: List) -> None:
    """flax's ``_msgpack_ext_pack``: the extension types."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        _ndarray_ext(_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _ndarray_ext(_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, complex):
        data = (_array_header(2) + struct.pack(">Bd", 0xCB, obj.real)
                + struct.pack(">Bd", 0xCB, obj.imag))
        out += [_ext_header(_COMPLEX, len(data)), data]
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack(obj, out: List, depth: int = _RECURSE_LIMIT) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is bytes or t is bytearray or t is memoryview:
        n = obj.nbytes if t is memoryview else len(obj)
        out += [_bin_header(n), obj]
    elif t is str:
        data = obj.encode("utf-8")
        out += [_str_header(len(data)), data]
    elif t is dict:
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    elif t is ExtType:
        out += [_ext_header(obj.code, len(obj.data)), obj.data]
    elif t is list:
        out.append(_array_header(len(obj)))
        for v in obj:
            _pack(v, out, depth - 1)
    else:
        _pack_default(obj, out)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.nbytes if isinstance(x, np.ndarray) else \
        x.numel() * x.element_size()


def _chunk(x) -> dict:
    itemsize = x.itemsize if isinstance(x, np.ndarray) else x.element_size()
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place``: an oversized array that is
    the tree or a value of a dict (not of a list) becomes chunks."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _is_array(v):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    tree[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _copy_tree(tree):
    """The containers of ``tree`` copied as ``jax.tree_util.tree_map(lambda
    x: x, tree)`` copies them: dicts with their keys sorted, lists and
    tuples in order, every other object a leaf."""
    if type(tree) is dict:
        return {k: _copy_tree(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_copy_tree(v) for v in tree)
    return tree


def pack_pieces(tree, in_place: bool = False) -> List:
    """``msgpack_serialize``'s bytes as a list of pieces (bytes and
    memoryviews of the arrays' own storage), to write without joining."""
    if not in_place:
        tree = _copy_tree(tree)
    tree = _chunk_leaves(tree)
    out: List = []
    _pack(tree, out)
    return out


def msgpack_serialize(tree, in_place: bool = False) -> bytes:
    """flax's ``msgpack_serialize``: the tree (dicts, lists, Python
    scalars, arrays) as msgpack bytes. Without ``in_place`` the containers
    are copied first, as flax copies them (dict keys sorted); with it the
    given dicts are written in their order and oversized arrays in them
    are replaced by their chunks."""
    return b"".join(pack_pieces(tree, in_place))


def to_state_dict(tree):
    """flax's ``to_state_dict`` for plain containers: dict keys as
    ``str(key)`` in their order, lists and tuples as ``{"0": ...}``, a
    namedtuple by its fields."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if type(tree) is dict:
        keys = {str(k) for k in tree}
        if len(keys) != len(tree):
            raise ValueError("Dict keys do not have a unique string "
                             f"representation: {keys} vs given: {tree}")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(target, state, name: str = "."):
    """flax's ``from_state_dict`` for plain containers: the tree of
    ``target`` restored from ``state`` (``msgpack_restore``'s nested
    dicts). A dict takes the template's keys (each must be in ``state``,
    as ``str(key)``; keys only ``state`` has are dropped), a list or tuple
    its length (``state`` keys ``"0"``, ``"1"``, ...), a namedtuple its
    fields; a leaf of the template is replaced by the stored value as it
    is."""
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        if set(state) != set(target._fields):
            raise ValueError(
                "The field names of the state dict and the named tuple do "
                f"not match, got {set(state)} and {set(target._fields)} at "
                f"path {name}")
        return type(target)(**{k: from_state_dict(getattr(target, k), v,
                                                  f"{name}/{k}")
                               for k, v in state.items()})
    if type(target) is dict:
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(
                "The target dict keys and state dict keys do not match, "
                f"target dict contains keys {missing} which are not present "
                f"in state dict at path {name}")
        return {k: from_state_dict(v, state[str(k)], f"{name}/{k}")
                for k, v in target.items()}
    if type(target) in (list, tuple):
        if len(state) != len(target):
            raise ValueError(
                "The size of the list and the state dict do not match, got "
                f"{len(target)} and {len(state)} at path {name}")
        out = [from_state_dict(v, state[str(i)], f"{name}/{i}")
               for i, v in enumerate(target)]
        return out if type(target) is list else tuple(out)
    return state


def to_bytes(tree) -> bytes:
    """flax's ``to_bytes`` of a tree of plain containers:
    ``msgpack_serialize(to_state_dict(tree), in_place=True)``."""
    return msgpack_serialize(to_state_dict(tree), in_place=True)


# ----------------------------------------------------------------- reading

_DTYPES_TORCH = {"bfloat16": torch.bfloat16}


class _Reader:
    """Decodes msgpack from a memoryview. ``raw`` keeps str as bytes (as
    flax reads an ndarray payload); bin values are memoryview slices of
    the input."""

    def __init__(self, mv: memoryview, raw: bool):
        self.mv, self.pos, self.raw = mv, 0, raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("msgpack data is truncated")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        data = self.take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext_value(code, self.take(n))

    def read(self, depth: int = _RECURSE_LIMIT) -> Any:
        if depth < 0:
            raise ValueError("recursion limit exceeded")
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if 0x90 <= b <= 0x9F:
            return [self.read(depth - 1) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            return self.text(self.unpack(sized[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read(depth - 1) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), depth)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(depth - 1)
            if type(key) not in (str, bytes):
                raise ValueError(f"{type(key).__name__} is not allowed for "
                                 "map key when strict_map_key=True")
            out[key] = self.read(depth - 1)
        return out


def _read_all(mv: memoryview, raw: bool):
    reader = _Reader(mv, raw)
    out = reader.read()
    if reader.pos != len(mv):
        raise ValueError("msgpack data has extra bytes after its object")
    return out


def _array_from_payload(mv: memoryview):
    """An ndarray ext payload -> a read-only numpy view of the input (or,
    for bfloat16, a tensor)."""
    shape, name, buf = _read_all(mv, raw=True)
    name = name.decode()
    if name in _DTYPES_TORCH:
        flat = np.frombuffer(buf, np.int16).copy()
        return torch.from_numpy(flat).view(_DTYPES_TORCH[name]).reshape(
            shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array dtype {name!r} has no numpy or "
                         "torch counterpart here") from None
    return np.frombuffer(buf, dtype).reshape(shape)


def _ext_value(code: int, data: memoryview):
    if code == _NDARRAY:
        return _array_from_payload(data)
    if code == _COMPLEX:
        real, imag = _read_all(data, raw=False)
        return complex(real, imag)
    if code == _NPSCALAR:
        return _array_from_payload(data)[()]
    return ExtType(code, bytes(data))


def _concat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return _concat(chunks).reshape(shape)


def _unchunk_leaves(tree):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return tree


def _own(tree):
    """Every numpy leaf that is still a view of the input copied into
    memory of its own (writable and aligned); bin values as bytes."""
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_own(v) for v in tree]
    if isinstance(tree, np.ndarray) and not tree.flags.writeable:
        return tree.copy()
    if isinstance(tree, memoryview):
        return bytes(tree)
    return tree


def msgpack_restore(data) -> Any:
    """flax's ``msgpack_restore``: bytes (or any buffer) -> the tree, with
    chunked arrays reassembled and every array writable."""
    tree = _read_all(memoryview(data).cast("B"), raw=False)
    return _own(_unchunk_leaves(tree))
