"""Building, loading and counting the port's hand-written CUDA kernels.

Each kernel package keeps its CUDA C++ under ``csrc/``. A source is compiled
by ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds) and loaded with ``ctypes``.
Libraries are built at first use into ``<repo>/build/repro_torch/`` and
named by a hash of the source, the ``csrc`` headers it includes and the
flags, so an edited kernel or header is rebuilt and an unchanged one is
loaded as it is. ``build_all`` starts one ``nvcc`` per
missing library, all at once.

A wrapper given ``meta`` (or fake) tensors launches nothing: it returns
empty outputs of the kernel's shapes and dtypes, allocates the kernel's
per-call workspaces, and records the kernel's work (``record_work``, by
the formulas of ``kernels.work``) into every open ``WorkCount``; a CUDA
launch records the same while one is open, so a traced step and a run one
count a kernel's work alike (``launch.memstats``).

Nothing here runs at import time: this module imports on hosts with no
CUDA toolkit, where only the kernels' plain versions run.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build",
    "repro_torch"))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA "
                           "toolkit is needed to build the kernels")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: str) -> list:
    """``source`` and, depth first, every header it includes with
    ``#include "..."`` (resolved beside the including file), each once."""
    seen = []

    def visit(path):
        path = os.path.normpath(path)
        if path in seen:
            return
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            visit(os.path.join(os.path.dirname(path), name.decode()))
    visit(source)
    return seen


class LaunchCounter:
    """A plain count of kernel launches: a wrapper adds one where it
    launches its kernel, so a run can show that its path went through it.
    A wrapper may name the shape it launched at; ``shapes`` counts the
    launches by shape."""

    def __init__(self, name: str):
        self.name = name
        self._count = 0
        self._shapes: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def add(self, n: int = 1, shape: Optional[tuple] = None) -> None:
        """Count ``n`` more launches (at ``shape``, when given)."""
        with self._lock:
            self._count += n
            if shape is not None:
                key = tuple(shape)
                self._shapes[key] = self._shapes.get(key, 0) + n

    def reset(self) -> None:
        """Set the count back to 0."""
        with self._lock:
            self._count = 0
            self._shapes = {}

    @property
    def count(self) -> int:
        """Launches counted since the last reset."""
        with self._lock:
            return self._count

    @property
    def shapes(self) -> Dict[tuple, int]:
        """Launches since the last reset by the shape the wrapper named."""
        with self._lock:
            return dict(self._shapes)


class WorkCount:
    """The kernels' work while it is open (a context manager; counts may
    nest): FLOP and bytes by kernel name, as the wrappers record them
    (``record_work``), and the calls recorded."""

    def __init__(self):
        self.flops: Dict[str, float] = {}
        self.bytes: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def __enter__(self) -> "WorkCount":
        with _OPEN_LOCK:
            _OPEN_COUNTS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _OPEN_LOCK:
            _OPEN_COUNTS.remove(self)

    def add(self, name: str, nbytes: float, flops: float) -> None:
        """Count one call of kernel ``name``."""
        self.flops[name] = self.flops.get(name, 0.0) + float(flops)
        self.bytes[name] = self.bytes.get(name, 0.0) + float(nbytes)
        self.calls[name] = self.calls.get(name, 0) + 1

    @property
    def total_flops(self) -> float:
        """FLOP of every recorded call."""
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        """Bytes of every recorded call."""
        return sum(self.bytes.values())


_OPEN_COUNTS: list = []
_OPEN_LOCK = threading.Lock()


def record_work(name: str, work) -> None:
    """Add one call of kernel ``name`` to every open ``WorkCount``:
    ``work()`` gives its (bytes, FLOP), and is not called when no count is
    open."""
    if _OPEN_COUNTS:
        nbytes, flops = work()
        with _OPEN_LOCK:
            for count in _OPEN_COUNTS:
                count.add(name, nbytes, flops)


def is_abstract(t) -> bool:
    """True for a tensor with no data to launch on: ``meta``, or a
    ``FakeTensor`` (whose device names the card it stands for)."""
    global _is_fake
    if t.is_meta:
        return True
    if _is_fake is None:
        from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)


_is_fake = None


def misaligned(t, unit: int = 16) -> bool:
    """True where ``t``'s first element would not start on a ``unit``-byte
    boundary: its address on a tensor with data, its offset into its
    storage on an abstract one (the card's allocator hands out storages
    on 512-byte boundaries)."""
    if is_abstract(t):
        return (t.storage_offset() * t.element_size()) % unit != 0
    return t.data_ptr() % unit != 0


class KernelLibrary:
    """One ``csrc`` source built into a shared library and its C entry
    points, each declared as ``name -> (restype, [argtypes])``."""

    def __init__(self, name: str, source: str, signatures: Dict[str, tuple]):
        self.name = name
        self.source = source
        self.signatures = dict(signatures)
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        """Where the library for the current source, its included headers
        and the flags lives."""
        h = hashlib.sha256()
        for path in source_files(self.source):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")

    def _start(self) -> Optional[tuple]:
        """Start nvcc unless the library exists; returns (proc, tmp, t0)."""
        out = self.path
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                 self.source], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started: tuple) -> None:
        proc, tmp, t0 = started
        log, _ = proc.communicate()
        self.build_log = log
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {self.source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.path)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed; argtypes and restype
        are declared for every entry point."""
        with self._lock:
            if self._lib is None:
                started = self._start()
                if started is not None:
                    self._finish(started)
                lib = ctypes.CDLL(self.path)
                for fn, (restype, argtypes) in self.signatures.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = list(argtypes)
                self._lib = lib
            return self._lib


def build_all(libraries: Sequence[KernelLibrary]) -> None:
    """Build every library that is missing, one nvcc each, all started
    together, then load them all. Raises on the first failed build."""
    started = []
    for lib in libraries:
        with lib._lock:
            if lib._lib is None:
                s = lib._start()
                if s is not None:
                    started.append((lib, s))
    for lib, s in started:
        with lib._lock:
            lib._finish(s)
    for lib in libraries:
        lib.lib()


class StreamScratch:
    """A kernel's scratch per device and stream, kept between calls: an
    fp32 buffer and an int32 counter buffer that is zero when made. Calls
    on one stream run in order, so one buffer serves them all; a kernel
    that counts in it leaves every counter at 0 when it ends."""

    def __init__(self):
        self._bufs = {}
        self._lock = threading.Lock()

    def get(self, stream, floats: int, counters: int):
        """(fp32 buffer of at least ``floats``, zeroed int32 buffer of at
        least ``counters``) for ``stream`` (a ``torch.cuda.Stream``)."""
        key = (stream.device_index, stream.cuda_stream)
        have = self._bufs.get(key)
        if (have is not None and have[0].numel() >= floats
                and have[1].numel() >= counters):
            return have
        import torch
        with self._lock:
            have = self._bufs.get(key)
            floats = max(floats, have[0].numel() if have else 0)
            counters = max(counters, have[1].numel() if have else 0)
            with torch.cuda.stream(stream):
                have = (torch.empty(floats, dtype=torch.float32,
                                    device=stream.device),
                        torch.zeros(counters, dtype=torch.int32,
                                    device=stream.device))
            self._bufs[key] = have
            return have

    def drop(self, stream) -> None:
        """Forget ``stream``'s buffers (after a failed launch, whose
        counters may not be 0)."""
        with self._lock:
            self._bufs.pop((stream.device_index, stream.cuda_stream), None)


def device_scope(device):
    """``torch.cuda.device(device)`` where ``device`` is not the current
    card, else a no-op (entering a device scope costs microseconds of host
    time on every call)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
