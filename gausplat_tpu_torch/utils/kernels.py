"""Build, load and launch the hand-written CUDA kernels.

Each kernel library is one ``.cu`` file under ``gausplat_tpu_torch/csrc/``
(which may include the ``.cuh`` headers there) with a plain C interface:
every entry point takes raw device pointers and a CUDA stream, launches on
that stream and returns ``cudaGetLastError()``. At first use the file is
compiled with ``nvcc`` for ``sm_90a`` into ``build/gausplat_tpu_torch/`` at
the root of the checkout, under a name keyed by a hash of the source, the
headers and the flags, and loaded with ``ctypes``. The host C++ library of
:mod:`.native` goes through the same build and cache (:func:`load_library`)
with the host compiler.
Nothing is built when this module is imported, and nothing here falls back
to a plain version: a kernel that does not build, load or launch raises
:class:`~gausplat_tpu_torch.errors.KernelError`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from typing import Sequence

import torch

from ..errors import KernelError

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "gausplat_tpu_torch"

#: No ``--use_fast_math`` (it swaps ``expf`` for ``__expf``) and no FMA
#: contraction: both move rounding at the alpha, density and transmittance
#: thresholds of the rasterizer and flip rendered counts. ``-Xptxas -v``
#: only reports each kernel's registers, shared memory and spills (kept in
#: ``CudaKernel.build_log``).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

#: ctypes argument types used by the C entry points.
PTR = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
F32 = ctypes.c_float


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found on PATH or in /usr/local/cuda/bin")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class CudaKernel:
    """One C entry point of one ``.cu`` library, with a launch count.

    ``launches`` goes up by one for each successful call of the entry
    point, and nowhere else, so a caller can zero it, run a path, and see
    whether the path went through this kernel. A CUDA graph that holds the
    launch replays it without a call: :func:`captured_launches` takes the
    capture's calls off the counts and :func:`count_replay` adds them back
    at each replay. Entry points of one library
    built with the same flags share one build and one loaded library.
    ``info_entry`` names the library's launch-facts function for this entry
    point (see :meth:`launch_info`).
    """

    def __init__(
        self,
        source: str,
        entry: str,
        argtypes: Sequence,
        flags: Sequence[str] = NVCC_FLAGS,
        info_entry: str = "gs_kernel_info",
    ):
        self.source = CSRC_DIR / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.flags = tuple(flags)
        self.info_entry = info_entry
        self.launches = 0
        self.build_seconds = None
        self.build_log = None
        self._lib = None
        self._fn = None
        self._error_string = None
        _KERNELS.add(self)

    def with_flags(self, flags: Sequence[str]) -> "CudaKernel":
        """The same entry point built with other nvcc flags (its own count)."""
        return CudaKernel(self.source.name, self.entry, self.argtypes, flags, self.info_entry)

    def with_source_dir(self, directory) -> "CudaKernel":
        """The same entry point built from the copy of its source (and
        headers) in ``directory``, another tree's ``csrc`` (its own count)."""
        kernel = self.with_flags(self.flags)
        kernel.source = pathlib.Path(directory).resolve() / self.source.name
        return kernel

    def load(self):
        """Build the library if its hashed file is missing, then bind it."""
        if self._fn is None:
            start = time.perf_counter()
            lib, self.build_log = load_library(self.source, self.flags, find_nvcc)
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.gs_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._error_string = lib, fn, err
            self.build_seconds = time.perf_counter() - start
        return self._fn

    def launch(self, *args) -> None:
        code = self.load()(*args)
        if code != 0:
            raise KernelError(
                f"{self.entry} failed to launch: CUDA error {code} "
                f"({self._error_string(code).decode()})"
            )
        self.launches += 1

    def launch_info(self) -> dict:
        """Registers per thread, static shared memory per CTA, and resident
        CTAs per SM, as the library's ``info_entry`` reports them for this
        entry point's kernel on the current device."""
        self.load()
        names = ("registers", "shared_bytes", "blocks_per_sm")
        info = getattr(self._lib, self.info_entry)
        info.argtypes = [ctypes.POINTER(ctypes.c_int32)] * len(names)
        info.restype = ctypes.c_int
        values = [ctypes.c_int32() for _ in names]
        code = info(*(ctypes.byref(v) for v in values))
        if code != 0:
            raise KernelError(f"{self.info_entry} of {self.source.name}: CUDA error {code} "
                              f"({self._error_string(code).decode()})")
        return {name: v.value for name, v in zip(names, values)}


#: Every kernel made, so that a captured graph can count its launches.
_KERNELS: "weakref.WeakSet[CudaKernel]" = weakref.WeakSet()


@contextlib.contextmanager
def captured_launches():
    """Around the capture of a CUDA graph: yields a dict that holds, after
    the block, the launches of each kernel recorded into the graph. A
    capture runs nothing, so the block leaves every count as it was; pass
    the dict to :func:`count_replay` at each replay of the graph."""
    before = {k: k.launches for k in list(_KERNELS)}
    recorded = {}
    try:
        yield recorded
    finally:
        for k in list(_KERNELS):
            n = k.launches - before.get(k, 0)
            if n:
                recorded[k] = n
                k.launches -= n


def count_replay(recorded: dict) -> None:
    """Count one replay of a graph whose launches :func:`captured_launches`
    recorded."""
    for k, n in recorded.items():
        k.launches += n


#: Loaded libraries by path, with their build logs, and a lock per path so
#: that entry points of one library built at once run one compiler.
_LIBRARIES: dict = {}
_LIBRARY_LOCKS: dict = {}
_LIBRARIES_GUARD = threading.Lock()


def library_path(source: pathlib.Path, flags: Sequence[str], header_glob="*.cuh") -> pathlib.Path:
    """Where ``source`` built with ``flags`` lives: a name keyed by a hash of
    the source, the headers beside it that match ``header_glob`` (None: no
    headers) and the flags."""
    headers = b"" if header_glob is None else b"".join(
        h.read_bytes() for h in sorted(source.parent.glob(header_glob)))
    digest = hashlib.sha256(
        source.read_bytes() + headers + "\0".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def _build(compiler: str, source: pathlib.Path, flags: Sequence[str], out: pathlib.Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, str(source)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise KernelError(
                f"{pathlib.Path(compiler).name} failed ({done.returncode}) on {source.name}:\n"
                f"{' '.join(cmd)}\n{done.stdout}{done.stderr}"
            )
        os.replace(tmp, out)
        return done.stdout + done.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(source: pathlib.Path, flags: Sequence[str], find_compiler,
                 header_glob="*.cuh"):
    """The loaded library of ``source`` built with ``flags`` and its build log
    (None where the hashed file was already there), built once per process
    however many callers share it. ``find_compiler()`` names the compiler;
    it is asked only when a build is needed."""
    out = library_path(source, flags, header_glob)
    with _LIBRARIES_GUARD:
        lock = _LIBRARY_LOCKS.setdefault(out, threading.Lock())
    with lock:
        if out not in _LIBRARIES:
            log = None if out.exists() else _build(find_compiler(), source, flags, out)
            try:
                _LIBRARIES[out] = (ctypes.CDLL(str(out)), log)
            except OSError as e:
                raise KernelError(f"cannot load {out}: {e}") from e
        return _LIBRARIES[out]


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build and load ``kernels`` at once, one ``nvcc`` process per library."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(len(kernels), 1)) as pool:
        for future in [pool.submit(k.load) for k in kernels]:
            future.result()


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    """Check one kernel argument: a contiguous CUDA tensor of ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
