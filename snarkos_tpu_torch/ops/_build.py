"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/lib<name>-<digest>.so`` at the root of the checkout
(a directory ``.gitignore`` lists). The digest covers the source, every
header in ``csrc/`` and the compiler flags, so a library is rebuilt exactly
when what it was built from changes. ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them; ``load()`` builds on
first use. Nothing here runs when the module is imported.

Every C entry point takes device pointers, sizes and a CUDA stream, and
returns ``cudaGetLastError()`` after its launch; ``launch`` raises when that
is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
SOURCES = ("mont_mul", "g1_add", "seg_prefix", "bucket_scan_serial", "bucket_scan",
           "bucket_scan_fast", "jadd_scan", "ntt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    entry points never carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
            os.path.join(CSRC, f"{name}.cu")]:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> None:
    """Compile every library in ``names`` that is missing, one ``nvcc`` per
    source, all started together. The compiler's output (``-Xptxas -v``:
    registers, spills) is kept beside each library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        text, _ = proc.communicate()
        with open(out[:-3] + ".log", "w") as fh:
            fh.write(text)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_log(name: str) -> str:
    with open(lib_path(name)[:-3] + ".log") as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib


def entry(lib_name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C function ``symbol``: ``n_ptrs`` pointers, ``n_ints`` int64
    sizes, then the stream; returns an int error code. Bound once a
    (library, symbol): later calls return the same function object."""
    fn = _ENTRIES.get((lib_name, symbol))
    if fn is None:
        fn = getattr(load(lib_name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[(lib_name, symbol)] = fn
    return fn


def launch(fn, tensors, sizes, device: torch.device) -> None:
    """Call ``fn`` on the tensors' device pointers (None passes a null
    pointer), the sizes and the current stream; raise on a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*[None if t is None else t.data_ptr() for t in tensors], *sizes, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def check(t: torch.Tensor, shape: tuple, what: str, dtype=torch.int32) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    ``dtype`` (int32 unless said otherwise) and exactly ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
