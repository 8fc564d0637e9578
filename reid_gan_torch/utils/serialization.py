"""Checkpoints: the port's own layout and the JAX package's flax msgpack.

The port writes the CC reference layout (parity:
CC/clustercontrast/utils/serialization.py:24-49): ``{"state_dict", "epoch",
"best_mAP"}`` saved with ``torch.save`` as ``checkpoint.pth.tar`` and copied
to ``model_best.pth.tar``; and the GAN nets' per-net layout
``{which_epoch}_net_{name}.pth`` (parity: CC/dual_gan/models/
base_model.py:94-161).

It also reads, and for tests writes, the JAX package's flax msgpack
checkpoints (``reid_gan_tpu/utils/serialization.py:31-136``): a whole
variables tree (``checkpoint.msgpack``, ``model_best.msgpack``) and the
per-net ``{which_epoch}_net_{name}.msgpack``. The codec below is a pure
Python copy of the msgpack subset ``flax.serialization`` writes: maps,
arrays, str, bin, ints, floats, nil and bools, the extension types 1
(ndarray: a packed ``(shape, dtype name, C-order bytes)``), 2 (complex) and 3
(numpy scalar), and leaves over ``MAX_CHUNK_SIZE`` bytes stored as
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``.
Arrays are views of the file's bytes (``np.frombuffer``); a bfloat16 leaf,
which numpy has no dtype for, comes back as a ``torch.bfloat16`` tensor.
"""

import os
import shutil
import struct

import numpy as np
import torch

from .osutils import mkdir_if_missing

# flax.serialization.MAX_CHUNK_SIZE: leaves above this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------

class _Reader:
    """A cursor over one msgpack buffer. ``raw`` keeps str payloads as bytes
    (flax decodes an ndarray's inner tuple with ``raw=True``)."""

    def __init__(self, buf, raw=False):
        self.buf = buf
        self.pos = 0
        self.raw = raw

    def _take(self, n):
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("msgpack: truncated data")
        return start

    def _unpack(self, fmt):
        start = self._take(struct.calcsize(fmt))
        return struct.unpack_from(fmt, self.buf, start)[0]

    def _bytes(self, n):
        start = self._take(n)
        return self.buf[start:start + n]

    def _str(self, n):
        b = bytes(self._bytes(n))
        return b if self.raw else b.decode("utf-8")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n):
        code = self._unpack(">b")
        return _ext_unpack(code, self._bytes(n))

    def read(self):
        b = self.buf[self._take(1)]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        if b == 0xc0:
            return None
        if b == 0xc2:
            return False
        if b == 0xc3:
            return True
        fixed = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        sized = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
                 0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
                 0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
        elif 0xd4 <= b <= 0xd8:
            n, kind = 1 << (b - 0xd4), "ext"
        else:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
        if kind == "bin":
            return self._bytes(n)
        if kind == "str":
            return self._str(n)
        if kind == "ext":
            return self._ext(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        return self._map(n)


def _dtype(name):
    return None if name == b"bfloat16" else np.dtype(name.decode("ascii"))


def _ndarray_from_bytes(data):
    """flax's ``_ndarray_from_bytes``: the array is a view of ``data``."""
    shape, name, buf = _Reader(data, raw=True).read()
    dtype = _dtype(name)
    if dtype is None:     # bfloat16: the bits as int16, viewed as bf16
        return torch.from_numpy(np.frombuffer(buf, np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = _Reader(data).read()
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        arr = _ndarray_from_bytes(data)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    raise ValueError(f"msgpack: unsupported extension type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data):
    """flax ``msgpack_restore``: bytes → a tree of dicts, lists, Python
    scalars, numpy arrays (views of ``data``) and numpy scalars."""
    reader = _Reader(memoryview(data))
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


# ---------------------------------------------------------------------------
# msgpack encoding
# ---------------------------------------------------------------------------

def _head(n, fix, fix_max, codes):
    """A length-prefixed header: the fix form below ``fix_max``, else the
    8/16/32-bit form (``codes``: the three type bytes, None where the
    format has no 8-bit form)."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: object of {n} entries or bytes is too large")


def _pack_int(v):
    if 0 <= v <= 0x7f or -32 <= v < 0:
        return struct.pack(">b", v) if v < 0 else bytes([v])
    if v >= 0:
        for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                           (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
        if -lim <= v:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(code, payload):
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _head(n, None, 0, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code) + payload


def _ndarray_to_bytes(arr):
    """flax's ``_ndarray_to_bytes``: pack ``(shape, dtype name, C bytes)``."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            return _ndarray_to_bytes(arr.detach().cpu().numpy())
        shape, name = tuple(arr.shape), "bfloat16"
        buf = arr.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not supported")
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    parts = [_head(3, 0x90, 16, (None, 0xdc, 0xdd)), _pack_list(list(shape))]
    parts += [_pack(name), _pack(buf)]
    return b"".join(parts)


def _pack_list(items):
    return _head(len(items), 0x90, 16, (None, 0xdc, 0xdd)) + \
        b"".join(_pack(v) for v in items)


def _chunk(arr):
    """flax's ``_chunk``: a flat array split into ``MAX_CHUNK_SIZE`` pieces."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _nbytes(arr):
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _pack(v):
    t = type(v)
    if v is None:
        return b"\xc0"
    if t is bool:
        return b"\xc3" if v else b"\xc2"
    if t is int:
        return _pack_int(v)
    if t is float:
        return b"\xcb" + struct.pack(">d", v)
    if t is str:
        b = v.encode("utf-8")
        return _head(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb)) + b
    if t in (bytes, bytearray, memoryview):
        b = bytes(v)
        return _head(len(b), None, 0, (0xc4, 0xc5, 0xc6)) + b
    if t is dict:   # keys in flax's order: sorted, as a pytree flattens them
        parts = [_head(len(v), 0x80, 16, (None, 0xde, 0xdf))]
        for k in sorted(v):
            parts += [_pack(k), _pack(v[k])]
        return b"".join(parts)
    if t is list:
        return _pack_list(v)
    if isinstance(v, np.ndarray) or isinstance(v, torch.Tensor):
        return _pack_ext(_EXT_NDARRAY, _ndarray_to_bytes(v))
    if isinstance(v, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(v)))
    if t is complex:
        return _pack_ext(_EXT_COMPLEX, _pack_list([v.real, v.imag]))
    raise TypeError(f"msgpack: cannot serialize {t.__name__}")


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree):
    """flax ``msgpack_serialize``: a tree of dicts, lists, Python scalars,
    numpy arrays and scalars (and torch tensors, written as arrays) → bytes
    that ``flax.serialization.msgpack_restore`` reads."""
    return _pack(_chunk_leaves(tree))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _write(data, fpath, writer):
    mkdir_if_missing(os.path.dirname(fpath) or ".")
    tmp = fpath + ".tmp"
    writer(data, tmp)
    os.replace(tmp, fpath)


def save_checkpoint(state, is_best=False, fpath="checkpoint.pth.tar"):
    """Write ``state`` to ``fpath`` (through a temporary file, so a crash
    never leaves half a checkpoint) and copy it to ``model_best.pth.tar``
    beside it when ``is_best``."""
    _write(state, fpath, torch.save)
    if is_best:
        shutil.copy(fpath, os.path.join(os.path.dirname(fpath), "model_best.pth.tar"))


def load_checkpoint(fpath):
    """The dict ``save_checkpoint`` wrote, tensors on the CPU."""
    if not os.path.isfile(fpath):
        raise ValueError(f"=> No checkpoint found at '{fpath}'")
    state = torch.load(fpath, map_location="cpu", weights_only=True)
    print(f"=> Loaded checkpoint '{fpath}'")
    return state


def save_msgpack_checkpoint(tree, is_best=False, fpath="checkpoint.msgpack"):
    """The JAX package's ``save_checkpoint`` (serialization.py:31-41): the
    tree in flax msgpack to ``fpath`` through a temporary file, and a copy
    to ``model_best.msgpack`` beside it when ``is_best``."""
    def write(data, path):
        with open(path, "wb") as f:
            f.write(data)

    _write(msgpack_serialize(tree), fpath, write)
    if is_best:
        shutil.copy(fpath, os.path.join(os.path.dirname(fpath), "model_best.msgpack"))


def load_msgpack_checkpoint(fpath):
    """A flax msgpack checkpoint → its nested dict of numpy arrays and Python
    scalars (serialization.py:44-60 without a target)."""
    if not os.path.isfile(fpath):
        raise ValueError(f"=> No checkpoint found at '{fpath}'")
    with open(fpath, "rb") as f:
        tree = msgpack_restore(f.read())
    print(f"=> Loaded checkpoint '{fpath}'")
    return tree


def load_flax_state(model, variables, what="checkpoint"):
    """Load a flax variables tree (``{"params", "batch_stats"}``) into
    ``model`` through the converters, strictly, as flax's
    ``from_state_dict`` restores a target: a key the model has and the tree
    lacks, a key the model lacks, or a shape that differs raises
    ``ValueError`` naming them."""
    from ..models.convert import state_dict_from_flax

    try:
        sd = state_dict_from_flax(model, variables)
    except (KeyError, AttributeError, ValueError, RuntimeError) as e:
        raise ValueError(f"{what} does not match the model: {e}") from e
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shaped = sorted(k for k in set(sd) & set(own) if tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or unexpected or shaped:
        raise ValueError(f"{what} does not match the model: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}, mis-shaped {shaped[:8]}")
    model.load_state_dict(sd)
    return model


def load_weights(net, path):
    """Load the file at ``path`` into ``net``, strictly: the JAX package's
    ``.msgpack`` (its ``params`` and ``batch_stats``, serialization.py:
    44-60) through the converters, or the port's ``.pth``/``.pth.tar``
    (a state dict, or a checkpoint holding one under ``state_dict``).
    Returns the file's whole tree."""
    if path.endswith(".msgpack"):
        tree = load_msgpack_checkpoint(path)
        load_flax_state(net, tree, f"'{path}'")
    else:
        tree = load_checkpoint(path)
        net.load_state_dict(tree.get("state_dict", tree))
    return tree


def resume_checkpoint(fpath, model):
    """Load a whole checkpoint into ``model``, strictly (``load_weights``).
    Returns ``(epoch, best_mAP)``, 0 where the file has none."""
    tree = load_weights(model, fpath)
    return int(np.asarray(tree.get("epoch", 0))), float(np.asarray(tree.get("best_mAP", 0.0)))


def copy_state_dict(state_dict, model, strip=None):
    """Copy the entries of ``state_dict`` into ``model`` where the model has
    the key at the same shape, and skip the others, printing both counts
    (parity: serialization.py:63-91; CC/clustercontrast/utils/
    serialization.py:51-61). Keys starting with ``strip`` lose it first."""
    if strip:
        state_dict = {(k[len(strip):] if k.startswith(strip) else k): v
                      for k, v in state_dict.items()}
    own = model.state_dict()
    copied, skipped = {}, []
    for k, v in state_dict.items():
        v = torch.as_tensor(v)
        if k in own and tuple(v.shape) == tuple(own[k].shape):
            copied[k] = v
        else:
            skipped.append(k)
    model.load_state_dict(copied, strict=False)
    if skipped:
        print(f"copy_state_dict: skipped {len(skipped)} keys (missing/shape-mismatch)")
    print(f"copy_state_dict: copied {len(copied)} tensors")
    return model


def save_networks(nets, save_dir, which_epoch):
    """Each net's ``state_dict`` (on the CPU) to
    ``<save_dir>/{which_epoch}_net_{name}.pth`` (serialization.py:94-100)."""
    mkdir_if_missing(save_dir)
    for name, net in nets.items():
        sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        save_checkpoint(sd, fpath=os.path.join(save_dir, f"{which_epoch}_net_{name}.pth"))


def load_networks(nets, save_dir, which_epoch):
    """Load each net's file into it in place: the port's
    ``{which_epoch}_net_{name}.pth`` or the JAX package's ``.msgpack``
    (serialization.py:103-114), whichever exists; both at once raise, naming
    them. A missing file is skipped with a message and the net keeps its
    weights."""
    for name, net in nets.items():
        base = os.path.join(save_dir, f"{which_epoch}_net_{name}")
        found = [p for p in (base + ".pth", base + ".msgpack") if os.path.isfile(p)]
        if len(found) == 2:
            raise ValueError(f"load_networks: both {found[0]} and {found[1]} exist for "
                             f"net '{name}'; remove the one not to load")
        if not found:
            print(f"load_networks: no checkpoint for net '{name}' at {base}.pth or "
                  ".msgpack; keeping init")
            continue
        load_weights(net, found[0])
    return nets
