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
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

from ..monitor.watchdog import note_compile

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

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
