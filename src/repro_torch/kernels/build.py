"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, loaded with
``ctypes``. The libraries land in ``repro_torch/_build/<digest>/``, where
the digest covers every source and the compiler flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is built when
the package is imported: the first kernel launch, or an explicit
``build()``, does it.

Every kernel wrapper adds one to ``launches[name]`` where it launches its
kernel, and nowhere else, so a run can show which kernels it went
through. ``require_cuda``, ``stream_of`` and ``upload`` are the checks and
plumbing every wrapper shares.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _U32, _F32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                              ctypes.c_float, ctypes.c_int)

#: library name -> {C function: argtypes}. Every function returns the
#: cudaError_t of its launch as an int (0 = success); every library also
#: exports ``safe_error_string(err)``.
LIBRARIES = {
    "mask_add": {
        # x, out, n, k0, k1, base, start word, scale, device, stream
        "safe_mask_add": (_P, _P, _I64, _U32, _U32, _U32, _I64, _F32, _INT, _P),
    },
    "chain_combine": {
        # cipher, x, out, n, kin0, kin1, kout0, kout1, base, scale, device, stream
        "safe_chain_combine": (_P, _P, _P, _I64, _U32, _U32, _U32, _U32, _U32,
                               _F32, _INT, _P),
        # cipher, x, out, rows, n, host table[rows, 6], scale, device, stream
        "safe_chain_combine_batched": (_P, _P, _P, _I64, _I64, _P, _F32, _INT,
                                       _P),
    },
    "bon_mask": {
        # x, out, n, device table[m, 3], m, base, scale, device, stream
        "safe_bon_mask": (_P, _P, _I64, _P, _I64, _U32, _F32, _INT, _P),
    },
}

#: kernel launches by kernel name; see ``reset_launches``.
launches = {"mask_add": 0, "chain_combine": 0, "chain_combine_batched": 0,
            "bon_mask": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_dir() -> Path:
    """Build directory keyed by the digest of the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet.

    Returns {name: ptxas report} for the libraries compiled by this call.
    Raises RuntimeError with the compiler's output if any build fails.
    """
    names = list(LIBRARIES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc={proc.returncode}) ---\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
        (out_dir / f"{name}.log").write_text(text)
        reports[name] = text
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name``, built on first use."""
    build([name])
    lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    for fn, argtypes in LIBRARIES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.safe_error_string.argtypes = [ctypes.c_int]
    lib.safe_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.safe_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def require_cuda(t, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given) — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def upload(a, device) -> torch.Tensor:
    """A small host array on ``device`` without stalling the host: a CUDA
    copy goes from pinned memory, asynchronously (a copy from pageable
    memory would wait for the stream to drain)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


__all__ = ["build", "library", "check", "launches", "reset_launches",
           "nvcc_path", "build_dir", "require_cuda", "stream_of", "upload"]
