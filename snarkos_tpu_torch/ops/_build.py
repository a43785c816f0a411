"""Build the CUDA sources under ``csrc/`` and the host engines under
``csrc/host/``, and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/lib<name>-<digest>.so`` at the root of the checkout
(a directory ``.gitignore`` lists). The digest covers the source, every
header in ``csrc/`` and the compiler flags, so a library is rebuilt exactly
when what it was built from changes. Each host engine, ``csrc/host/<name>.cpp``
(the pairing, the G1 engine and the Poseidon sponge of
``utils/native.py``), becomes ``build/host/lib<name>-<digest>.so`` by the
same rule, built with ``g++`` (else ``c++``) from ``PATH``. ``build()``
starts one compiler per missing library, ``nvcc`` and ``g++`` all at once,
and waits for them; ``load()`` and ``load_host()`` build on first use.
Nothing here runs when the module is imported.

Every C entry point takes device pointers, sizes and a CUDA stream, and
returns ``cudaGetLastError()`` after its launch; ``launch`` raises when that
is not 0. Each launch wrapper counts its launches (``counted``, ``count``)
in the registry of ``utils/tracing.py``, as ``launch.<wrapper>``.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import ExitStack

import torch

from snarkos_tpu_torch.utils import tracing

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
SOURCES = ("mont_mul", "g1_add", "seg_prefix", "bucket_scan_serial", "bucket_scan",
           "bucket_scan_fast", "jadd_scan", "ntt", "lane_scan", "window_tail", "fr_passes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CSRC = os.path.join(CSRC, "host")
HOST_BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "host")
HOST_SOURCES = ("pairing377", "g1_msm", "poseidon377")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
HOST_THREADED = ("g1_msm",)  # starts threads of its own: -pthread

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()
_ENTRY_LOCK = threading.Lock()


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


def _cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the host engines "
                           "build only on a machine with one")
    return path


def _digest(flags, files) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    files = sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [os.path.join(CSRC, f"{name}.cu")]
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(NVCC_FLAGS, files)}.so")


def host_flags(name: str) -> tuple:
    return HOST_FLAGS + (("-pthread",) if name in HOST_THREADED else ())


def host_lib_path(name: str) -> str:
    files = sorted(glob.glob(os.path.join(HOST_CSRC, "*.h"))) + [
        os.path.join(HOST_CSRC, f"{name}.cpp")]
    return os.path.join(HOST_BUILD_DIR, f"lib{name}-{_digest(host_flags(name), files)}.so")


def build(names=SOURCES, host=HOST_SOURCES) -> dict:
    """Compile every library in ``names`` (CUDA) and ``host`` (the host
    engines) that is missing, one compiler per source, all started together;
    return the seconds from the start to each compiler's exit, by source.
    The compiler's output (for nvcc, ``-Xptxas -v``: registers, spills) is
    kept beside each library as ``.log``. Processes that build at once take
    turns on a file lock in each build directory, the kernels' first: a
    later one finds the libraries the first built."""
    with ExitStack() as locks:
        jobs = []
        for srcs, build_dir, path_of, command in (
                (names, BUILD_DIR, lib_path,
                 lambda n, tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]),
                (host, HOST_BUILD_DIR, host_lib_path,
                 lambda n, tmp: [_cxx(), *host_flags(n), "-o", tmp,
                                 os.path.join(HOST_CSRC, f"{n}.cpp")])):
            if not srcs:
                continue
            os.makedirs(build_dir, exist_ok=True)
            lock = locks.enter_context(open(os.path.join(build_dir, ".lock"), "w"))
            fcntl.flock(lock, fcntl.LOCK_EX)
            for name in srcs:
                out = path_of(name)
                if not os.path.exists(out):
                    tmp = f"{out}.{os.getpid()}.tmp"
                    jobs.append((name, command(name, tmp), tmp, out))
        return _run(jobs)


def _run(jobs) -> dict:
    """Start every (name, command, output, library) job at once, its
    compiler's output into the library's ``.log``; move each finished
    library into place, and raise with the logs of those that failed."""
    t0 = time.perf_counter()
    running = []
    for name, cmd, tmp, out in jobs:
        with open(out[:-3] + ".log", "w") as log:
            running.append((name, cmd[-1], tmp, out,
                            subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    seconds, failed = {}, []
    while running:
        time.sleep(0.01)
        for job in [j for j in running if j[-1].poll() is not None]:
            running.remove(job)
            name, src, tmp, out, proc = job
            seconds[name] = time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(tmp, out)
                tracing.count("kernel.build")
                continue
            with open(out[:-3] + ".log") as fh:
                failed.append(f"--- {os.path.basename(src)} (exit {proc.returncode})\n"
                              + fh.read())
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    with open(lib_path(name)[:-3] + ".log") as fh:
        return fh.read()


def load_host(name: str) -> ctypes.CDLL:
    """The host engine ``name``, a new handle each call (``utils/native.py``
    keeps one). A missing engine builds with the others that are missing, so
    the first engine a process needs brings the rest: g++ takes ~20 s for
    the pairing engine, and the sources build side by side."""
    path = host_lib_path(name)
    if not os.path.exists(path):
        build((), HOST_SOURCES)
    return ctypes.CDLL(path)


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                build([name], ())
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib


def entry(lib_name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C function ``symbol``: ``n_ptrs`` pointers, ``n_ints`` int64
    sizes, then the stream; returns an int error code. Bound once a
    (library, symbol): later calls return the same function object."""
    fn = _ENTRIES.get((lib_name, symbol))
    if fn is None:
        lib = load(lib_name)
        with _ENTRY_LOCK:  # bound whole before another thread can call it
            fn = _ENTRIES.get((lib_name, symbol))
            if fn is None:
                fn = getattr(lib, symbol)
                fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_ints
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _ENTRIES[(lib_name, symbol)] = fn
    return fn


def counted(wrapper):
    """Give a launch wrapper its counters: ``wrapper.launches`` at 0 (its
    launches since a reader last set it to 0, as the chip check does a path)
    and ``launch.<name>`` in the registry at 0."""
    wrapper.launches = 0
    tracing.declare("launch." + wrapper.__name__)
    return wrapper


def count(wrapper) -> None:
    """One launch of ``wrapper``: ``wrapper.launches`` and the registry's
    ``launch.<name>``, under the registry's lock: validators that share a
    process launch from several executor threads at once."""
    with tracing.LOCK:
        wrapper.launches += 1
        tracing.count_locked("launch." + wrapper.__name__)


def launch_counts() -> dict:
    """The launches of each wrapper that has launched in this process, by
    the wrapper's name (what a node prints when it stops)."""
    return {name[len("launch."):]: n for name, n in tracing.counters("launch.").items() if n}


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
