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

A train step on ('data', 'model') ranks (tensor parallelism,
``train/train_step.py::_tp_step``) writes the one-process state:
``gather_tp_state`` brings the full leaves and the whole master vector
and moments to global rank 0, and ``shard_tp_state`` gives each rank its
shards and its ZeRO-1 part back, so a checkpoint of m model shards
restores in the one-process launcher, and the reverse. A segmented leaf
(Mamba2's ``in_proj``) is joined from its shards; with expert
parallelism the experts are gathered over the learners too, so the
checkpoint holds every expert, as the one-process EP launcher's does.
"""
from __future__ import annotations

import gzip
import os
import re
import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.flatten import (is_expert_path, leaf_paths, leaves, leaves_with_paths,
                                       tree_map_with_path, tree_unflatten)

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


# ---- train states of model-sharded ranks ---------------------------------------

_SLICED = ("master", "fm", "fv")  # the ZeRO-1 vectors a rank holds a part of


def one_process_size(sec_size: int, learners: int) -> int:
    """The one-process step's flat length: ``sec_size`` padded to n words."""
    return -(-int(sec_size) // learners) * learners


def _expert_rows(path: str, ring, ep: bool) -> int:
    """The ring ranks a leaf's dim 1 is split over: the learners for an
    expert leaf with expert parallelism, else 1."""
    return ring.size if ep and is_expert_path(path) else 1


def gather_full_leaf(x: torch.Tensor, sh, ring, tp, expert: bool = False
                     ) -> Optional[torch.Tensor]:
    """The full leaf of a model-sharded rank's shard ``x`` (``sh`` its
    ``LeafShard``) in host memory on global rank 0, None elsewhere: a split
    leaf gathered over the learner's model group along its split dim, one
    rank at a time, and joined (a segmented leaf's replicated segments
    rank 0's); an ``expert`` leaf (the rank holding its ring rank's experts)
    then over ring 0 along its expert dim. The ranks that take part call it
    in the same leaf order: learner 0's model group, and for an expert leaf
    every rank."""
    from repro_torch.dist import collectives
    if ring.rank != 0 and not expert:
        return None
    x = x.detach()
    if sh.split is None:
        part = x.cpu() if tp.rank == 0 else None
    else:  # shards padded to rank 0's length (uneven splits), trimmed on join
        part = collectives.gather_to_host(sh.split.pad(x, tp.size), 0, tp, axis=sh.dim)
        if part is not None:
            part = sh.join(sh.split.trim(list(part.chunk(tp.size, sh.dim))))
    if expert and tp.rank == 0:  # the learners' experts, over ring 0
        part = collectives.gather_to_host(part.to(x.device), 0, ring, axis=1)
    return part


def gather_tp_state(state: dict, layout: list, sec_size: int, ring, tp, world,
                    ep: bool = False) -> Optional[dict]:
    """The one-process train state of a model-sharded rank's ``state``, in
    host memory on global rank 0 (learner 0's model rank 0), None on the
    other ranks; every rank calls it. ``layout``: the rank's
    ``shard_layout`` of the whole parameter tree (the parameters' leaves
    and, by path, the moments'); ``ring``/``tp``/``world``: the learners'
    ring, the model group and the whole group (rank l·m + j); ``ep``: the
    model holds the ring rank's experts. Each leaf comes through
    ``gather_full_leaf``; the ZeRO-1 parts of the master vector, m and v over the
    whole group (rank order is (l, j), so the parts come back
    chunk-major), cut to the SAFE partition's words and padded to
    ``one_process_size`` (both layouts' pad words are zeros)."""
    from repro_torch.dist import collectives
    lead = world.rank == 0
    by_path = dict(zip(leaf_paths(state["params"]), layout))

    def gather_tree(tree):
        out = tree_map_with_path(lambda path, x: gather_full_leaf(
            x, by_path[path], ring, tp, _expert_rows(path, ring, ep) > 1), tree)
        return out if lead else None

    full = dict(state)
    full["params"] = gather_tree(state["params"])
    for key in ("sec_opt", "ep_opt"):
        if state.get(key) is not None:
            s = state[key]
            full[key] = type(s)(s.step, gather_tree(s.m), gather_tree(s.v))
    if state.get("sec_opt") is None:
        n, m = ring.size, tp.size
        size = one_process_size(sec_size, n)
        for k in _SLICED:
            parts = collectives.gather_to_host(state[k], 0, world)
            if lead:
                flat = parts.view(n, m, -1).transpose(0, 1).reshape(-1)[:sec_size]
                full[k] = torch.cat([flat, flat.new_zeros(size - sec_size)])
    return full if lead else None


def tp_skeleton(state: dict, layout: list, sec_size: int, ring, ep: bool = False) -> dict:
    """A host skeleton of the one-process state that a model-sharded
    rank's ``state`` restores from: full leaves (every expert with ``ep``),
    whole vectors."""
    by_path = dict(zip(leaf_paths(state["params"]), layout))

    def full(tree):
        def leaf(path, x):
            shape = list(by_path[path].shape)
            if _expert_rows(path, ring, ep) > 1:
                shape[1] *= ring.size
            return torch.zeros(shape, dtype=x.dtype)
        return tree_map_with_path(leaf, tree)
    out = dict(state)
    out["params"] = full(state["params"])
    for key in ("sec_opt", "ep_opt"):
        if state.get(key) is not None:
            s = state[key]
            out[key] = type(s)(s.step, full(s.m), full(s.v))
    if state.get("sec_opt") is None:
        for k in _SLICED:
            out[k] = torch.zeros(one_process_size(sec_size, ring.size), dtype=state[k].dtype)
    return out


def shard_tp_state(full: dict, state: dict, layout: list, sec_size: int, padded: int,
                   ring, tp, ep: bool = False) -> dict:
    """This rank's train state from a restored one-process ``full`` state:
    its shards of the leaves (of its experts with ``ep``), and its part of
    chunk j of the master vector and moments (the SAFE partition's words
    padded to ``padded``), on the devices of ``state``'s tensors."""
    by_path = dict(zip(leaf_paths(state["params"]), layout))

    def shards(tree, like):
        def leaf(path, x, y):
            rows = _expert_rows(path, ring, ep)
            if rows > 1:
                k = x.shape[1] // rows
                x = x[:, ring.rank * k:(ring.rank + 1) * k]
            return by_path[path].cut(x).to(y.device, copy=True).contiguous()
        return tree_unflatten(tree, [leaf(path, x, y) for (path, x), y in
                                     zip(leaves_with_paths(tree), leaves(like))])
    out = dict(full)
    out["params"] = shards(full["params"], state["params"])
    for key in ("sec_opt", "ep_opt"):
        if state.get(key) is not None:
            s, like = full[key], state[key]
            out[key] = type(s)(s.step, shards(s.m, like.m), shards(s.v, like.v))
    if state.get("sec_opt") is None:
        L = padded // tp.size
        part = L // ring.size
        lo = tp.rank * L + ring.rank * part
        for k in _SLICED:
            flat = torch.zeros(padded, dtype=full[k].dtype)
            flat[:sec_size] = full[k][:sec_size]
            out[k] = flat[lo:lo + part].to(state[k].device, copy=True)
    return out
