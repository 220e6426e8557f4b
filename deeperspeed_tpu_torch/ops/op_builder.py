"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout (the
directory beside this package; ``.gitignore`` lists it). The library's
file name carries a hash of the source, of the local headers it includes
(``#include "x.cuh"``, followed into the headers) and of the flags, so an
edited source or header builds anew and an unchanged one loads from the
cache. Nothing is built
when a module is imported: the first kernel launch calls ``load``, and
``build_all`` builds several sources at once (one ``nvcc`` each, all
started together) ahead of the first launch.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
as ``/usr/local/cuda/bin/nvcc``. Each build is the port's backend compile
for the monitor (``monitor.watchdog.note_compile``: the ``xla_compile``
instant the goodput and request ledgers read).

The host libraries of the offload engine (``csrc/host/<name>.cpp``: the
AVX Adam and wire codec ``ds_cpu_adam``, the NVMe I/O ``ds_aio``) are
plain C++ for the CPU. ``load_host`` builds them the same way into the
same cache, with ``$CXX`` when it is set, else the first of ``g++``,
``c++`` and ``clang++`` that builds them, and the reference's flags
(``-O3 -std=c++17 -fPIC -shared -pthread``, plus ``-march=native
-fopenmp`` for the Adam). A toolchain without OpenMP builds the Adam
without ``-fopenmp``, with a warning (``build_info[...]["openmp"]`` says
which); a
library no compiler builds raises with the compilers' output. The hash
also covers the compiler and the CPU's feature flags, since
``-march=native`` code is only good on the CPU it was built for.
"""

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

from ..monitor.watchdog import note_compile
from ..utils.logging import logger

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# the host libraries: name -> (extra compile flags, link flags)
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
HOST_LIBRARIES = {
    "ds_cpu_adam": (("-march=native", "-fopenmp"), ("-lgomp",)),
    "ds_aio": ((), ()),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": compile time in this process (0.0 on a cache hit),
#          "ptxas": nvcc's -Xptxas -v report, "path": the library}
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header, each once, in the order they are met."""
    found: List[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo.extend(path.parent / m.group(1).decode()
                    for m in _LOCAL_INCLUDE.finditer(path.read_bytes()))
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        # a build earlier in this process keeps its record
        if build_info.get(name, {}).get("path") != str(out):
            build_info[name] = {"seconds": 0.0, "ptxas": "", "path": str(out)}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info[name] = {"seconds": seconds, "ptxas": proc.stderr,
                        "path": str(out)}
    note_compile(seconds, f"{name}.cu")
    return out


def build_all(names) -> None:
    """Build ``csrc/<name>.cu`` for every name, the ``nvcc`` processes
    running side by side; a source already built loads from the cache.
    Raises the first build error."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(_build, n) for n in names]:
            fut.result()


def load(name: str,
         signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C function to ``(argtypes, restype)``; they
    are declared once, when the library is first loaded."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


# ------------------------------------------------------------------ #
# host libraries (C++ for the CPU)
# ------------------------------------------------------------------ #


def find_cxx() -> List[str]:
    """The host compilers to try, in order: ``$CXX`` alone when it is set,
    else those of ``g++``, ``c++`` and ``clang++`` on ``PATH``."""
    env = os.environ.get("CXX")
    names = [env] if env else ["g++", "c++", "clang++"]
    found = []
    for name in names:
        path = shutil.which(name)
        if path and os.path.realpath(path) not in map(os.path.realpath,
                                                      found):
            found.append(path)
    if not found:
        raise RuntimeError(
            "no C++ compiler found ($CXX, g++, c++, clang++): the host "
            "libraries of the offload engine cannot be built")
    return found


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.processor()


def host_command(name: str, cxx: str, out: Path,
                 openmp: bool = True) -> List[str]:
    extra, link = HOST_LIBRARIES[name]
    if not openmp:
        extra = tuple(f for f in extra if f != "-fopenmp")
        link = tuple(f for f in link if f != "-lgomp")
    return [cxx, *HOST_CXX_FLAGS, *extra,
            str(CSRC_DIR / "host" / f"{name}.cpp"), "-o", str(out), *link]


def host_library_path(name: str, cxx: str, openmp: bool = True) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC_DIR / "host" / f"{name}.cpp").read_bytes())
    digest.update(" ".join(host_command(name, cxx, Path("x"),
                                        openmp)).encode())
    digest.update(platform.machine().encode() + _cpu_flags().encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _host_variants(name: str) -> List[Tuple[str, bool]]:
    """(compiler, OpenMP) builds in order of preference: every compiler
    with the reference's flags, then, for a library that takes OpenMP,
    the first compiler without it (a toolchain without libgomp: the
    library's OpenMP loop, ds_adam_step's, then runs on one thread)."""
    cxxs = find_cxx()
    variants = [(c, True) for c in cxxs]
    if "-fopenmp" in HOST_LIBRARIES[name][0]:
        variants.append((cxxs[0], False))
    return variants


def _warn_without_openmp(name: str, cxx: str) -> None:
    logger.warning(
        f"host/{name}.cpp: {cxx} builds no OpenMP here (no libgomp), so the "
        f"library's OpenMP loops run on one thread: a departure from the "
        f"reference's flags (ROADMAP.md section 3)")


def _build_host(name: str) -> Path:
    variants = _host_variants(name)
    for cxx, openmp in variants:
        out = host_library_path(name, cxx, openmp)
        if out.exists():
            if build_info.get(name, {}).get("path") != str(out):
                build_info[name] = {"seconds": 0.0, "ptxas": "",
                                    "path": str(out), "openmp": openmp,
                                    "compiler": cxx}
                if not openmp:
                    _warn_without_openmp(name, cxx)
            return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for cxx, openmp in variants:
        out = host_library_path(name, cxx, openmp)
        # a private temporary name, then os.replace: several processes
        # (test workers, ranks) may build the same library at once
        tmp = out.with_name(f"{out.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        cmd = host_command(name, cxx, tmp, openmp)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
            continue
        os.replace(tmp, out)
        build_info[name] = {"seconds": seconds, "ptxas": "",
                            "path": str(out), "openmp": openmp,
                            "compiler": cxx}
        note_compile(seconds, f"host/{name}.cpp")
        if not openmp:
            _warn_without_openmp(name, cxx)
        return out
    raise RuntimeError(f"failed to build host/{name}.cpp:\n"
                       + "\n".join(errors))


def load_host(name: str,
              signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The loaded host library ``csrc/host/<name>.cpp``, built on first
    use; ``signatures`` as ``load`` takes them. A failed build raises with
    the compiler's output."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build_host(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
