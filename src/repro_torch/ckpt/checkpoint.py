"""Pytree checkpoints in the JAX package's on-disk format.

Layout (the reference's ``ckpt/checkpoint.py``): ``<dir>/step_<N>/``
holds ``manifest.msgpack.<ext>`` — a msgpack map of the step, the tree
structure (for audit), each leaf's dtype name, shape and byte count, and
the caller's ``extra`` map — and ``buffers.bin.<ext>``, every leaf's raw
bytes (row-major, little-endian) one after another, in the reference's
leaf order (``train/flatten.py``: dict keys sorted, lists and tuples in
order, ``None`` an empty subtree). A checkpoint written by either package
restores in the other, bit for bit.

The port needs neither ``msgpack``, ``ml_dtypes`` nor ``zstandard``:

- it carries its own encoder and decoder for the msgpack subset a
  manifest uses (maps, strings, integers, lists, nil; also booleans,
  floats and byte strings in ``extra``), byte for byte what
  ``msgpack.packb`` writes;
- bfloat16 leaves go to and from torch through their 16-bit patterns, so
  the dtype name ``"bfloat16"`` needs no numpy extension;
- it writes gzip; it reads gzip, raw blobs and, when ``zstandard`` is
  installed, zstd blobs (the codec is found by the blob's magic bytes, as
  the reference does), and raises the reference's error for a zstd blob
  on a host without it.

Leaves restore onto the skeleton leaf's device, in the dtype the
checkpoint recorded; a Python number in the skeleton (the train state's
``step``) restores as a Python number.
"""
from __future__ import annotations

import gzip
import os
import re
import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.flatten import leaves, tree_unflatten

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_GZIP_MAGIC = b"\x1f\x8b"

# ---- the msgpack subset ---------------------------------------------------------


def packb(obj: Any) -> bytes:
    """msgpack encoding of ``obj`` (dict, str, int, list/tuple, None, bool,
    float, bytes), smallest form first, as ``msgpack.packb`` writes it."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A length header: the fix form up to ``fix_max``, else the 8-, 16- or
    32-bit form among ``codes`` (None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if 0 <= v < 0x80:
            out.append(v)
        elif -32 <= v < 0:
            out.append(v & 0xFF)
        elif v >= 0:
            for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                                   (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
                if v < lim:
                    out += struct.pack(fmt, code, v)
                    return
            raise OverflowError(f"msgpack: integer {v} too large")
        else:
            for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                                   (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
                if v >= -lim:
                    out += struct.pack(fmt, code, v)
                    return
            raise OverflowError(f"msgpack: integer {v} too small")
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object of the subset ``packb`` writes (strings as
    str, arrays as lists, as ``msgpack.unpackb`` returns them)."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
          0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _str(buf, pos, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _seq(buf, pos, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _LENGTHS:
        fmt = _LENGTHS[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if b in (0xD9, 0xDA, 0xDB):
            return _str(buf, pos, n)
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(buf[pos:pos + n]), pos + n
        return (_seq if b in (0xDC, 0xDD) else _map)(buf, pos, n)
    raise ValueError(f"msgpack: type byte 0x{b:02x} is outside the subset this reader knows")


def _str(buf, pos, n):
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _seq(buf, pos, n):
    items = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        items.append(item)
    return items, pos


def _map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


# ---- blobs ------------------------------------------------------------------------


def _decompress(blob: bytes) -> bytes:
    """Codec auto-detection by magic bytes (the on-disk format tag)."""
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise RuntimeError(
                "checkpoint is zstd-compressed but the zstandard package is "
                "not installed on this host") from None
        return zstandard.ZstdDecompressor().decompress(blob)
    if blob[:2] == _GZIP_MAGIC:
        return gzip.decompress(blob)
    return blob  # raw (uncompressed legacy blob)


def _write_tagged(path_base: str, data: bytes) -> None:
    """Write ``<path_base>.gz``, removing any stale sibling written under
    another codec, which a later restore would otherwise prefer."""
    with open(f"{path_base}.gz", "wb") as f:
        f.write(gzip.compress(data, compresslevel=6))
    for stale in (f"{path_base}.zst", path_base):
        if os.path.exists(stale):
            os.remove(stale)


def _read_tagged(path_base: str) -> bytes:
    """Read ``<path_base>.{zst,gz}`` (or bare), whichever exists."""
    for ext in ("zst", "gz", ""):
        p = f"{path_base}.{ext}" if ext else path_base
        if os.path.exists(p):
            with open(p, "rb") as f:
                return _decompress(f.read())
    raise FileNotFoundError(f"no checkpoint blob at {path_base}.(zst|gz)")


# ---- leaves -----------------------------------------------------------------------


def _leaf_bytes(leaf: Any) -> tuple[dict, bytes]:
    """(manifest entry, raw bytes) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, arr = "bfloat16", t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            name = str(arr.dtype)
    else:
        arr = np.asarray(leaf)
        name = str(arr.dtype)
    return ({"dtype": name, "shape": list(arr.shape), "nbytes": int(arr.nbytes)},
            arr.tobytes())


def _leaf_from(raw: bytes, meta: dict, like: Any) -> Any:
    """The leaf ``meta`` describes, as ``like`` holds leaves."""
    shape = tuple(meta["shape"])
    exp_shape = tuple(like.shape) if hasattr(like, "shape") else tuple(np.shape(like))
    if shape != exp_shape:
        raise ValueError(f"shape mismatch: ckpt {shape} vs skeleton {exp_shape}")
    name = meta["dtype"]
    arr = np.frombuffer(raw, dtype=np.int16 if name == "bfloat16" else np.dtype(name))
    arr = arr.reshape(shape).copy()
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(like.device)
    if isinstance(like, (bool, int, float)) and not isinstance(like, np.generic):
        return type(like)(arr.item())
    return arr


def _structure(tree: Any) -> str:
    """The tree's structure for the manifest (audit only: restores take the
    structure from the skeleton)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


# ---- the entry points ---------------------------------------------------------


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Write a checkpoint; returns its path."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    metas, blobs = [], []
    for leaf in leaves(tree):
        meta, blob = _leaf_bytes(leaf)
        metas.append(meta)
        blobs.append(blob)
    manifest = {
        "step": step,
        "treedef": _structure(tree),  # audit only; structure restored from skeleton
        "leaves": metas,
        "extra": extra or {},
    }
    _write_tagged(os.path.join(path, "manifest.msgpack"), packb(manifest))
    _write_tagged(os.path.join(path, "buffers.bin"), b"".join(blobs))
    return path


def restore_checkpoint(directory: str, step: int, skeleton: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``skeleton`` (shapes checked); returns
    (tree, extra)."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = unpackb(_read_tagged(os.path.join(path, "manifest.msgpack")))
    raw = _read_tagged(os.path.join(path, "buffers.bin"))
    like = leaves(skeleton)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, skeleton "
                         f"{len(like)} — structure changed since save")
    out, off = [], 0
    for leaf, meta in zip(like, manifest["leaves"]):
        n = meta["nbytes"]
        out.append(_leaf_from(raw[off:off + n], meta, leaf))
        off += n
    return tree_unflatten(skeleton, out), manifest["extra"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", name))]
    return max(steps) if steps else None
