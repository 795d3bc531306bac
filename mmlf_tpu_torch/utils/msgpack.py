"""Reader of the msgpack subset that ``flax.serialization`` writes.

The JAX package stores its checkpoints as ``flax.serialization.to_bytes``
of the train state (``checkpoint.msgpack``).  That is msgpack with:

  * maps, arrays, str, bin, nil, bool, int, float32 and float64;
  * ext type 1, an ndarray, whose payload is itself msgpack: the tuple
    ``(shape, dtype name, C-order bytes)``;
  * ext type 3, a numpy scalar, encoded as a 0-d ndarray.

``unpackb`` decodes exactly that, into what ``flax.serialization.
msgpack_restore`` returns: dicts with str keys, lists, Python scalars,
numpy arrays and numpy scalars.  A ``bfloat16`` leaf (numpy has no such
dtype) is widened to float32 exactly, its 16 bits becoming the high half
of the float32.

It raises ``ValueError``, naming the key, on what flax writes only outside
this net's checkpoints: ext type 2 (a Python complex), any other ext type,
and flax's chunked leaves (``__msgpack_chunked_array__``, used only for
arrays over 1 GiB).  Truncated or malformed input raises ``ValueError``
too.  Nesting is bounded (a checkpoint tree is about 8 levels deep).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED_KEY = '__msgpack_chunked_array__'
MAX_DEPTH = 64

# fixed-width scalars: first byte -> struct format
_SCALARS = {0xca: '>f', 0xcb: '>d',
            0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
            0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# variable-length items: first byte -> (kind, struct format of the length)
_SIZED = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
          0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
          0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
          0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
          0xde: ('map', '>H'), 0xdf: ('map', '>I')}
# fixext 1, 2, 4, 8, 16
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _where(path) -> str:
    return '/'.join(str(k) for k in path) or '<root>'


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f'msgpack data ends early (wanted {n} bytes at '
                             f'offset {self.pos} of {len(self.buf)})')
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, path: tuple):
        if len(path) > MAX_DEPTH:
            raise ValueError(f'msgpack nesting deeper than {MAX_DEPTH} at '
                             f'{_where(path)}')
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.read_map(b & 0x0f, path)
        if b <= 0x9f:
            return [self.read(path + (j,)) for j in range(b & 0x0f)]
        if b <= 0xbf:
            return self.read_str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.read_ext(_FIXEXT[b], path)
        if b not in _SIZED:
            raise ValueError(f'byte 0x{b:02x} is not msgpack, at '
                             f'{_where(path)}')
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt)
        if kind == 'bin':
            return bytes(self.take(n))
        if kind == 'str':
            return self.read_str(n)
        if kind == 'ext':
            return self.read_ext(n, path)
        if kind == 'array':
            return [self.read(path + (j,)) for j in range(n)]
        return self.read_map(n, path)

    def read_str(self, n: int) -> str:
        return str(self.take(n), 'utf-8')

    def read_map(self, n: int, path: tuple) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(path)
            if isinstance(key, (list, dict)):
                raise ValueError(f'{_where(path)}: a map key that is a '
                                 f'{type(key).__name__}')
            if key == CHUNKED_KEY:
                raise ValueError(
                    f'{_where(path)}: a chunked leaf ({CHUNKED_KEY}, flax '
                    f'writes it only for arrays over 1 GiB) is not '
                    f'supported')
            out[key] = self.read(path + (key,))
        return out

    def read_ext(self, n: int, path: tuple):
        code = self.unpack('>b')
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload, path)
        if code == EXT_NPSCALAR:
            return _ndarray(payload, path)[()]
        if code == EXT_COMPLEX:
            raise ValueError(f'{_where(path)}: a complex leaf (msgpack ext '
                             f'type 2) is not supported')
        raise ValueError(f'{_where(path)}: unknown msgpack ext type {code}')


def _ndarray(payload: memoryview, path: tuple) -> np.ndarray:
    """flax's ndarray encoding: msgpack of ``(shape, dtype name, bytes)``."""
    inner = _Reader(payload)
    fields = inner.read(path)
    if not (isinstance(fields, list) and len(fields) == 3
            and inner.pos == len(payload)):
        raise ValueError(f'{_where(path)}: malformed ndarray payload')
    shape, name, buf = fields
    if name == 'bfloat16':
        wide = np.frombuffer(buf, '<u2').astype('<u4') << 16
        return wide.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f'{_where(path)}: unknown dtype {name!r}') from None
    return np.frombuffer(buf, dtype).reshape(shape)


def unpackb(data) -> object:
    """Decode one msgpack object (the whole of ``data``)."""
    reader = _Reader(data)
    out = reader.read(())
    if reader.pos != len(reader.buf):
        raise ValueError(f'{len(reader.buf) - reader.pos} bytes after the '
                         f'msgpack object')
    return out
