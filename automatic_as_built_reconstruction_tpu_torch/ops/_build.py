"""Build ``csrc/*.cu`` with nvcc into shared libraries and load them.

Each source has a plain C interface (pointers, ints and a stream), so it
compiles in seconds with no PyTorch headers and binds through ``ctypes``.
Libraries go to ``_build/`` inside this package (listed in ``.gitignore``),
named by a hash of the source and flags, so an edited source rebuilds and
an unchanged one is reused.  Nothing is downloaded.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

``-fmad=false`` keeps every multiply and add rounded separately, as the
plain PyTorch versions round them, so a kernel and its plain version
differ only by the device's ``sinf``/``cosf``.  No ``--use_fast_math``.

Host code (``csrc/*.cpp``: the rulebook builder of the input pipeline) is
built the same way by the host compiler nvcc drives, ``g++``, at first
use (:func:`load_host`):

    g++ -O3 -std=c++17 -shared -fPIC -o _build/lib<name>-<hash>.so
        csrc/<name>.cpp
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise KernelBuildError("nvcc not found (PATH, /usr/local/cuda/bin)")


def cxx_path() -> str:
    """The host C++ compiler: ``g++`` on PATH, as nvcc finds it."""
    for cand in (shutil.which("g++"), "/usr/bin/g++"):
        if cand and Path(cand).exists():
            return cand
    raise KernelBuildError("g++ not found (PATH, /usr/bin)")


def sources() -> List[str]:
    """Names of the kernels in ``csrc/`` (file stems)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def lib_path(name: str, suffix: str = ".cu") -> Path:
    """Where the library of ``csrc/<name><suffix>`` is (or will be)
    built: named by a hash of the source and the flags."""
    src = (CSRC_DIR / f"{name}{suffix}").read_bytes()
    flags = NVCC_FLAGS if suffix == ".cu" else CXX_FLAGS
    digest = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build_all(names=None) -> Dict[str, dict]:
    """Compile every (or the named) kernel source, one nvcc per source,
    all started together.  Returns ``{name: {"seconds", "log"}}`` with
    nvcc's output (``-Xptxas -v``: registers, spills); seconds is 0.0
    when an up-to-date library was already there.  Raises on any
    failure with nvcc's output."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, result = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            result[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc rc={proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return result


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = lib_path(name)
    if not path.exists():
        build_all([name])
    return ctypes.CDLL(str(path))


_HOST_LOCK = threading.Lock()


@functools.cache
def _load_host(name: str) -> ctypes.CDLL:
    out = lib_path(name, ".cpp")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run(
            [cxx_path(), *CXX_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"host build of {name}.cpp failed (g++ "
                                   f"rc={proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, built
    with g++ first if needed (one build however many threads ask).
    Raises :class:`KernelBuildError` with the compiler's output when the
    build fails."""
    with _HOST_LOCK:
        return _load_host(name)


@functools.cache
def function(name: str, symbol: str, argtypes: tuple):
    """The C launch function ``symbol`` of ``csrc/<name>.cu``, typed:
    pointers and the stream as ``c_void_p`` (a plain int would be cut to
    32 bits), returning the ``cudaError_t`` of the launch as an int."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
