"""Build and load the hand-written CUDA kernels of this package.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``ops/_build/`` (named by a
hash of the source and the local headers it includes, so an edited source
or header rebuilds) and loaded with
``ctypes``.  Nothing is built at import time: the first call that launches
a kernel builds it.  A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_libs: dict[str, ctypes.CDLL] = {}
_mu = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source "
                       "at first use and need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str, csrc: str = CSRC) -> list[str]:
    """``csrc/<name>.cu`` and every file under ``csrc`` that it includes
    with ``#include "..."``, directly or through another such file, in the
    order first reached."""
    seen: list[str] = []
    todo = [os.path.join(csrc, f"{name}.cu")]
    while todo:
        path = os.path.normpath(todo.pop(0))
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(dep):
                todo.append(dep)
    return seen


def library_path(name: str, csrc: str = CSRC) -> str:
    """The library's path, named by a hash of the source, every local
    header it includes and the flags: an edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name, csrc):
        with open(path, "rb") as f:
            h.update(os.path.relpath(path, csrc).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _mu:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
