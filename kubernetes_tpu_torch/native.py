"""ctypes bridge to the host helpers in C and C++ under ``csrc/``.

Three helpers, all host code (they never touch the card):

- ``labelmatch.cpp``: the interned selector/labelmap matcher behind
  ``MatchEngine``, which the tensorizer uses to count existing pods per
  spread selector and per affinity term;
- ``fastcopy.c``: a deep copy of JSON-shaped data through the CPython API,
  which the store uses on every read, write and watch emit;
- ``pause.c``: the per-pod sandbox process a kubelet starts with real
  sandboxes (``kubelet/runtime.py`` ``ProcessSandboxManager``), an
  executable rather than a library.

Each is built with the host C/C++ compiler at first use into ``_build/``
beside this file (gitignored), under a name that carries a hash of the
source and the command, so an edited source rebuilds; nothing is built at
import time.  Where a build fails, the pure-Python version serves instead:
``helpers()`` says which one each helper is.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sysconfig
import threading
from typing import Optional, Sequence

import numpy as np

from .api.selectors import Requirement

logger = logging.getLogger("kubernetes_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST, OP_GT, OP_LT, OP_EQ = range(7)
_OP_BY_NAME = {"In": OP_IN, "NotIn": OP_NOT_IN, "Exists": OP_EXISTS,
               "DoesNotExist": OP_DOES_NOT_EXIST, "Gt": OP_GT, "Lt": OP_LT}


def _compile(name: str, cmd: list[str], src: str, filename: str = "lib{name}-{key}.so"
             ) -> Optional[str]:
    """Compile ``src`` with ``cmd`` into ``_build/lib<name>-<hash>.so`` (or
    ``filename``) unless it is there; returns the path, or None where the
    build fails.  The rename is atomic, so concurrent processes never load
    a half-written library."""
    with open(src, "rb") as f:
        key = hashlib.sha256(" ".join(cmd).encode() + b"\0" + f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, filename.format(name=name, key=key))
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(cmd + [src, "-o", tmp], check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native build of %s failed (%s); using the Python version", src, e)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


# -- labelmatch --------------------------------------------------------------

_lib = None
_lib_failed = False
_lib_mu = threading.Lock()


def get_lib():
    """The loaded matcher library, or None (the Python version serves)."""
    global _lib, _lib_failed
    with _lib_mu:
        if _lib is not None or _lib_failed:
            return _lib
        so = _compile("labelmatch", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"],
                      os.path.join(CSRC, "labelmatch.cpp"))
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(so)
        lib.lm_new.restype = ctypes.c_void_p
        lib.lm_free.argtypes = [ctypes.c_void_p]
        lib.lm_add_labelmap.restype = ctypes.c_int32
        lib.lm_add_labelmap.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32]
        lib.lm_new_selector.restype = ctypes.c_int32
        lib.lm_new_selector.argtypes = [ctypes.c_void_p]
        lib.lm_sel_add_req.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                                       ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.c_int32]
        lib.lm_match_matrix.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        lib.lm_match_any.argtypes = list(lib.lm_match_matrix.argtypes)
        _lib = lib
        return _lib


def _carr_str(items: Sequence[str]):
    arr = (ctypes.c_char_p * max(len(items), 1))()
    for i, s in enumerate(items):
        arr[i] = s.encode()
    return arr


class MatchEngine:
    """Interned selector/labelmap matcher: labelmaps and selectors are
    registered once and referred to by integer id.  Native where the
    library built, else a Python loop over the same semantics."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.lm_new() if self._lib else None
        self._py_labelmaps: list[dict] = []
        self._py_selectors: list[list] = []

    def close(self) -> None:
        if self._lib and self._h:
            self._lib.lm_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    @property
    def native(self) -> bool:
        return self._h is not None

    def add_labelmap(self, labels: dict) -> int:
        if self._h:
            keys = _carr_str(list(labels.keys()))
            vals = _carr_str([str(v) for v in labels.values()])
            return self._lib.lm_add_labelmap(self._h, keys, vals, len(labels))
        self._py_labelmaps.append(dict(labels))
        return len(self._py_labelmaps) - 1

    def add_selector(self, requirements: list[tuple[str, str, list[str]]]) -> int:
        """requirements: [(key, op_name, values)]; op "Eq" = key=value."""
        if self._h:
            sid = self._lib.lm_new_selector(self._h)
            for key, op_name, values in requirements:
                op = OP_EQ if op_name == "Eq" else _OP_BY_NAME[op_name]
                self._lib.lm_sel_add_req(self._h, sid, key.encode(), op, _carr_str(values),
                                         len(values))
            return sid
        self._py_selectors.append(list(requirements))
        return len(self._py_selectors) - 1

    def add_simple_selector(self, selector: dict) -> int:
        return self.add_selector([(k, "Eq", [str(v)]) for k, v in selector.items()])

    def add_label_selector(self, sel) -> int:
        """From an ``api.selectors.LabelSelector``."""
        reqs = [(k, "Eq", [str(v)]) for k, v in sel.match_labels.items()]
        reqs += [(r.key, r.operator, list(r.values)) for r in sel.match_expressions]
        return self.add_selector(reqs)

    def match_matrix(self, selector_ids: Sequence[int], labelmap_ids: Sequence[int]) -> np.ndarray:
        ns, nl = len(selector_ids), len(labelmap_ids)
        out = np.zeros((ns, nl), dtype=np.uint8)
        if ns == 0 or nl == 0:
            return out.astype(bool)
        if self._h:
            sarr = (ctypes.c_int32 * ns)(*selector_ids)
            larr = (ctypes.c_int32 * nl)(*labelmap_ids)
            self._lib.lm_match_matrix(self._h, sarr, ns, larr, nl,
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            return out.astype(bool)
        for i, sid in enumerate(selector_ids):
            for j, lid in enumerate(labelmap_ids):
                out[i, j] = self._py_match(sid, lid)
        return out.astype(bool)

    def match_any(self, selector_ids: Sequence[int], labelmap_ids: Sequence[int]) -> np.ndarray:
        nl = len(labelmap_ids)
        out = np.zeros(nl, dtype=np.uint8)
        if nl == 0 or len(selector_ids) == 0:
            return out.astype(bool)
        if self._h:
            sarr = (ctypes.c_int32 * len(selector_ids))(*selector_ids)
            larr = (ctypes.c_int32 * nl)(*labelmap_ids)
            self._lib.lm_match_any(self._h, sarr, len(selector_ids), larr, nl,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            return out.astype(bool)
        for j, lid in enumerate(labelmap_ids):
            out[j] = any(self._py_match(sid, lid) for sid in selector_ids)
        return out.astype(bool)

    def _py_match(self, sid: int, lid: int) -> bool:
        labels = self._py_labelmaps[lid]
        for key, op_name, values in self._py_selectors[sid]:
            if op_name == "Eq":
                if labels.get(key) != values[0]:
                    return False
            elif not Requirement(key, op_name, list(values)).matches(labels):
                return False
        return True


# -- fastcopy ----------------------------------------------------------------

_fc_fn = None
_fc_failed = False
_fc_mu = threading.Lock()


def get_fastcopy():
    """The native deep copy (PyObject -> PyObject), or None.  It calls the
    CPython API, so it is loaded with ``ctypes.PyDLL`` (the GIL held) and
    its build key carries the interpreter's ABI tag; a self-check runs
    before the store is given it."""
    global _fc_fn, _fc_failed
    with _fc_mu:
        if _fc_fn is not None or _fc_failed:
            return _fc_fn
        tag = sysconfig.get_config_var("SOABI") or "py"
        include = sysconfig.get_paths()["include"]
        so = _compile(f"fastcopy-{tag}", ["gcc", "-O2", "-shared", "-fPIC", f"-I{include}"],
                      os.path.join(CSRC, "fastcopy.c"))
        fn = None
        if so is not None:
            lib = ctypes.PyDLL(so)
            lib.fc_deepcopy.restype = ctypes.py_object
            lib.fc_deepcopy.argtypes = [ctypes.py_object]
            fn = lib.fc_deepcopy
            probe = {"a": [1, {"b": "c"}], "d": None}
            got = fn(probe)
            if not (got == probe and got is not probe and got["a"] is not probe["a"]
                    and got["a"][1] is not probe["a"][1]):
                logger.warning("native fastcopy failed its self-check; using the Python version")
                fn = None
        _fc_fn = fn
        _fc_failed = fn is None
        return _fc_fn


# -- pause -------------------------------------------------------------------

_pause_failed = False


def pause_binary() -> Optional[str]:
    """Path to the pause executable (``csrc/pause.c``), built on first use
    into ``_build/ktpu-pause-<hash>``; None where no C toolchain builds it
    (sandboxes then stay process-less).  A failure is remembered, so a
    fleet of kubelets does not start the compiler once a kubelet."""
    global _pause_failed
    if _pause_failed:
        return None
    src = os.path.join(CSRC, "pause.c")
    # -static fails where no static libc is installed
    out = (_compile("pause", ["gcc", "-O2", "-static"], src, "ktpu-{name}-{key}")
           or _compile("pause", ["gcc", "-O2"], src, "ktpu-{name}-{key}"))
    if out is None:
        _pause_failed = True
    return out


def helpers() -> dict:
    """Which version of each host helper serves in this process:
    ``"native"`` or ``"python"`` (building them on first call)."""
    return {"matcher": "native" if get_lib() is not None else "python",
            "fastcopy": "native" if get_fastcopy() is not None else "python"}
