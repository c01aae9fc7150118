"""Build and load the hand-written CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file is compiled on its own, at first use, into
``build/kernels/<stem>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``). The hash covers the source bytes, those of the ``csrc/``
files it includes, and the compiler flags, so a changed source rebuilds
and an unchanged one is loaded as it is. The
sources expose a plain C interface; nothing here includes PyTorch's
headers, which keeps a build to seconds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. Pointers and the
stream are passed as ``ctypes.c_void_p`` (a plain int argtype would cut a
64-bit pointer).

``--use_fast_math`` is deliberately absent: it replaces ``expf``, and the
bitwise fused-vs-flat attention pin compares two kernels that must take
the same ``expf`` path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

import torch

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def build_dir() -> pathlib.Path:
    """``<checkout>/build/kernels``."""
    return _HERE.parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(src: pathlib.Path, seen: set | None = None) -> bytes:
    """``src``'s bytes followed by those of every file of ``csrc/`` it
    includes with quotes, recursively (each once)."""
    seen = set() if seen is None else seen
    seen.add(src)
    data = src.read_bytes()
    out = [data]
    for name in _INCLUDE.findall(data):
        dep = CSRC / name.decode()
        if dep.exists() and dep not in seen:
            out.append(_source_bytes(dep, seen))
    return b"".join(out)


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(_source_bytes(src) + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source that has no up-to-date library, all at once.

    One ``nvcc`` process per source, started together and waited on
    together. Returns ``{stem: library path}``; raises with the compiler's
    output if any build fails.
    """
    out, procs = {}, []
    for src in sources():
        dst = _target(src)
        out[src.stem] = dst
        if dst.exists():
            continue
        dst.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=dst.parent)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, dst, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, dst, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            pathlib.Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, dst)              # atomic: readers never see a half file
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    lib = _libs.get(stem)
    if lib is None:
        src = CSRC / f"{stem}.cu"
        dst = _target(src)
        if not dst.exists():
            build_all()
        lib = ctypes.CDLL(str(dst))
        _libs[stem] = lib
    return lib


def bind(stem: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C function ``name`` of library ``stem`` with its argtypes set
    (looked up once per process)."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(load(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(stem, name)] = fn
    return fn


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {code})")


class LaunchCount:
    """Plain launch counter of one kernel wrapper.

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that a path really went through the kernel.
    """

    __slots__ = ("name", "n")

    def __init__(self, name: str):
        self.name = name
        self.n = 0


#: every kernel's counter, by kernel name
COUNTERS: dict[str, LaunchCount] = {}


def counter(name: str) -> LaunchCount:
    c = COUNTERS.get(name)
    if c is None:
        c = COUNTERS[name] = LaunchCount(name)
    return c


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.n = 0


def counts() -> dict[str, int]:
    return {k: c.n for k, c in COUNTERS.items()}


_C = torch._C  # the CUDA bindings exist only in a CUDA build: read at call


def stream_ptr(index: int) -> int:
    """The raw ``cudaStream_t`` of device ``index``'s current stream (the
    capture stream inside a CUDA graph capture), read without building a
    ``torch.cuda.Stream``."""
    return _C._cuda_getCurrentRawStream(index)


def launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` on device ``index``'s current stream. The
    device is entered only when it is not the current one already, which
    spares the common call a device switch in and out. Returns ``fn``'s
    code for :func:`check`."""
    if index == _C._cuda_getDevice():
        return fn(*args, stream_ptr(index))
    with torch.cuda.device(index):
        return fn(*args, stream_ptr(index))


VP, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_float)
