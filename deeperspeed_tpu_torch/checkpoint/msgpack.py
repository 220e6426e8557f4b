"""A msgpack encoder and decoder that write and read the reference's
checkpoint bytes: ``flax.serialization.to_bytes`` and ``msgpack_restore``,
in pure Python.

The port's checkpoints are the reference's files (checkpoint/
serialization.py), and the card's machine has neither ``flax`` nor
``msgpack``, so this module carries their format:

- a tree becomes a state dict as flax's ``to_state_dict`` makes it: dict
  keys as ``str(key)`` in the dict's own order, lists and tuples as
  ``{"0": ..., "1": ...}``, NamedTuples as a dict of their fields;
- ``None``, bools, ints (the smallest msgpack width that holds them),
  floats (always float64), strings (str8 included) and bytes (bin) as
  msgpack packs them with ``use_bin_type=True``;
- an ndarray as ext type 1 holding ``packb((shape, dtype name, raw
  C-order bytes))``, a numpy scalar as ext type 3 (the same payload of a
  0-d array);
- an array over ``MAX_CHUNK_SIZE`` bytes as flax's chunked form,
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces of ``MAX_CHUNK_SIZE // itemsize`` elements.

Leaves may be numpy arrays or torch tensors (a tensor on the card is
copied to the host as it is written). numpy has no bfloat16 here (no
``ml_dtypes``), so bf16 travels as a torch tensor: written under the
dtype name ``"bfloat16"`` from its 16-bit pattern, and read back as a CPU
``torch.bfloat16`` tensor; every other array is read as numpy.

``dump`` streams to an open file, one leaf at a time, so a
multi-gigabyte checkpoint is never joined into one ``bytes`` object.
``restore`` decodes from any buffer; over an ``mmap`` the arrays it
returns are views into the mapping, not copies.
"""

import io
import struct
from typing import Any, Callable

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_FLUSH_BYTES = 1 << 20


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(tree):
    """flax's ``to_state_dict`` for dicts, lists, tuples and NamedTuples;
    any other value is a leaf."""
    if _is_namedtuple(tree):
        return {f: to_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        out = {str(k): to_state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError("dict keys do not have unique string forms")
        return out
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(target, state):
    """Rebuild ``target``'s structure (dicts, lists, tuples, NamedTuples)
    around the leaves of a restored state dict."""
    if _is_namedtuple(target):
        if set(state) != set(target._fields):
            raise ValueError(f"state fields {sorted(state)} do not match "
                             f"{type(target).__name__}{target._fields}")
        return type(target)(**{f: from_state_dict(getattr(target, f),
                                                  state[f])
                               for f in target._fields})
    if isinstance(target, dict):
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(f"state dict lacks keys {sorted(missing)}")
        return {k: from_state_dict(v, state[str(k)])
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        out = [from_state_dict(v, state[str(i)])
               for i, v in enumerate(target)]
        return out if isinstance(target, list) else tuple(out)
    return state


# ---------------------------------------------------------------------- #
# encoding
# ---------------------------------------------------------------------- #


def _int(x: int) -> bytes:
    if x >= 0:
        if x < 0x80:
            return bytes((x,))
        if x <= 0xFF:
            return b"\xcc" + struct.pack(">B", x)
        if x <= 0xFFFF:
            return b"\xcd" + struct.pack(">H", x)
        if x <= 0xFFFFFFFF:
            return b"\xce" + struct.pack(">I", x)
        if x <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + struct.pack(">Q", x)
    else:
        if x >= -32:
            return struct.pack(">b", x)
        if x >= -0x80:
            return b"\xd0" + struct.pack(">b", x)
        if x >= -0x8000:
            return b"\xd1" + struct.pack(">h", x)
        if x >= -0x80000000:
            return b"\xd2" + struct.pack(">i", x)
        if x >= -0x8000000000000000:
            return b"\xd3" + struct.pack(">q", x)
    raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _str_header(n: int) -> bytes:
    if n < 32:
        return bytes((0xA0 | n,))
    if n <= 0xFF:
        return b"\xd9" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xda" + struct.pack(">H", n)
    return b"\xdb" + struct.pack(">I", n)


def _bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n)
    return b"\xc6" + struct.pack(">I", n)


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x80 | n,))
    if n <= 0xFFFF:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x90 | n,))
    if n <= 0xFFFF:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return bytes((_FIXEXT[n], code))
    if n <= 0xFF:
        return b"\xc7" + struct.pack(">Bb", n, code)
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">Hb", n, code)
    return b"\xc9" + struct.pack(">Ib", n, code)


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _str_header(len(b)) + b


def _host_bytes(x):
    """(shape, dtype name, a flat uint8 view of the C-order bytes) of a
    numpy array or a tensor (copied to the host)."""
    if isinstance(x, torch.Tensor):
        name = _TORCH_NAMES.get(x.dtype)
        if name is None:
            raise ValueError(f"no msgpack dtype name for {x.dtype}")
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return tuple(t.shape), name, t.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")  # (np.ascontiguousarray would make 0-d 1-d)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no msgpack form")
    return a.shape, a.dtype.name, a.reshape(-1).view(np.uint8)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunked(x) -> dict:
    """flax's ``_chunk``: the array as flat pieces of MAX_CHUNK_SIZE
    bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = x.numel() if isinstance(x, torch.Tensor) else x.size
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED_KEY: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + step]
                       for j, i in enumerate(range(0, size, step))}}


class _Packer:
    """Writes msgpack to ``write``, small pieces buffered, array bytes
    passed straight through."""

    def __init__(self, write: Callable):
        self._write = write
        self._buf = bytearray()

    def _put(self, b) -> None:
        self._buf += b
        if len(self._buf) >= _FLUSH_BYTES:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._write(bytes(self._buf))
            self._buf = bytearray()

    def _array(self, code: int, x) -> None:
        shape, name, raw = _host_bytes(x)
        head = (_array_header(3) + _array_header(len(shape))
                + b"".join(_int(int(d)) for d in shape) + _str(name)
                + _bin_header(raw.size))
        self._put(_ext_header(code, len(head) + raw.size) + head)
        if raw.size > _FLUSH_BYTES:
            self.flush()
            self._write(memoryview(raw))
        else:
            self._put(raw.tobytes())

    def pack(self, obj, chunkable: bool = True) -> None:
        """Pack ``obj``; an array over MAX_CHUNK_SIZE bytes in flax's
        chunked form where ``chunkable`` (the top level and dict values,
        where flax looks for them)."""
        if obj is None:
            self._put(b"\xc0")
        elif obj is True:
            self._put(b"\xc3")
        elif obj is False:
            self._put(b"\xc2")
        elif type(obj) is int:
            self._put(_int(obj))
        elif type(obj) is float:
            self._put(b"\xcb" + struct.pack(">d", obj))
        elif type(obj) is str:
            self._put(_str(obj))
        elif type(obj) is bytes:
            self._put(_bin_header(len(obj)) + obj)
        elif type(obj) is dict:
            self._put(_map_header(len(obj)))
            for k, v in obj.items():
                self.pack(k, chunkable=False)
                self.pack(v)
        elif _is_array(obj):
            if chunkable and _nbytes(obj) > MAX_CHUNK_SIZE:
                self.pack(_chunked(obj), chunkable=False)
            else:
                self._array(EXT_NDARRAY, obj)
        elif isinstance(obj, np.generic):
            self._array(EXT_NPSCALAR, np.asarray(obj))
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} "
                            f"object")


def dump(tree: Any, f) -> None:
    """Write ``flax.serialization.to_bytes(tree)``'s bytes to the binary
    file ``f``, leaf by leaf."""
    packer = _Packer(f.write)
    packer.pack(to_state_dict(tree))
    packer.flush()


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes(tree)``."""
    out = io.BytesIO()
    dump(tree, out)
    return out.getvalue()


# ---------------------------------------------------------------------- #
# decoding
# ---------------------------------------------------------------------- #


def _array_from(payload: memoryview, scalar: bool):
    """Decode an ndarray ext payload, ``(shape, dtype name, bytes)``, into
    a view of ``payload`` (bf16: a CPU tensor, copied first when
    ``payload`` is read-only)."""
    shape, name, raw = _Decoder(payload, unchunk=False,
                                payload=True).value()
    name = name.decode()
    if name == "bfloat16":
        if not len(raw):
            return torch.empty(shape, dtype=torch.bfloat16)
        if raw.readonly:
            raw = memoryview(bytearray(raw))
        return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
    a = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
    return a[()] if scalar else a


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


class _Decoder:
    def __init__(self, buf, unchunk: bool, payload: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.unchunk = unchunk
        # an ndarray payload: strings as bytes (flax reads it raw) and
        # the array's bytes as a view
        self.payload = payload

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _text(self, n: int):
        raw = self._take(n)
        return bytes(raw) if self.payload else str(raw, "utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from(payload, scalar=False)
        if code == EXT_NPSCALAR:
            return _array_from(payload, scalar=True)
        raise ValueError(f"unknown msgpack ext type {code}")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if self.unchunk and CHUNKED_KEY in out:
            return _unchunk(out)
        return out

    def value(self):
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self._text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            raw = self._take(self._unpack(lengths[b]))
            return raw if self.payload else bytes(raw)
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            return self._ext(self._unpack(lengths[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self._text(self._unpack(lengths[b]))
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {self.pos - 1}")


def restore(buf, unchunk: bool = True):
    """``flax.serialization.msgpack_restore``: the state dict in ``buf``
    (bytes, a memoryview or an mmap). Arrays are views into ``buf`` where
    it is writable or an mmap, bf16 ones CPU tensors. With ``unchunk``
    False a chunked array stays in its chunked dict form, so a caller can
    copy it piece by piece."""
    dec = _Decoder(buf, unchunk=unchunk)
    out = dec.value()
    if dec.pos != len(dec.buf):
        raise ValueError(f"{len(dec.buf) - dec.pos} bytes after the msgpack "
                         f"object")
    return out



def from_bytes(target: Any, data) -> Any:
    """``flax.serialization.from_bytes``: ``target``'s structure with the
    leaves restored from ``data``."""
    return from_state_dict(target, restore(data))


def chunked_parts(x):
    """The pieces of a restored leaf in C order: [x] for an array,
    the chunks of a chunked dict (``restore(..., unchunk=False)``)."""
    if isinstance(x, dict) and x.get(CHUNKED_KEY):
        return [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
    return [x]


def leaf_shape(x):
    if isinstance(x, dict) and x.get(CHUNKED_KEY):
        return tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
    return tuple(x.shape)
