"""ctypes binding for the C++ batch-assembly core (native/loader_core.cpp;
the port's own copy of visdial_tpu/data/native.py).

The Python implementations in loader.py are the behavioral reference; these
bindings are drop-in fast paths (tests assert byte-identical output).  At
first use this module compiles native/loader_core.cpp with g++ straight into
build/visdial_tpu_torch/native/ at the root of the checkout (git-ignored;
keyed by a hash of the source), never through native/Makefile, whose target
lives in the JAX package.  Where g++ is missing or the build fails,
`available()` is False and callers take the numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "loader_core.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "visdial_tpu_torch", "native")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_lib = None
_tried = False

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def _build() -> str | None:
    """Path of the compiled core, compiling it first if needed; None where
    there is no source or no g++, or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if not os.path.exists(_SOURCE) or cxx is None:
        return None
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(_CXXFLAGS).encode() + f.read())
    lib = os.path.join(_BUILD_DIR, f"libvisdial_native_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    tmp = None
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    except (OSError, subprocess.SubprocessError):
        if tmp and os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.vd_right_align.argtypes = [_i32p, _i32p, _i32p, _i64, _i64]
    lib.vd_hist_concat.argtypes = [_i32p] * 7 + [_i64] * 6
    lib.vd_facts.argtypes = [_i32p] * 8 + [_i64] * 6
    lib.vd_gather_options.argtypes = [_i32p] * 3 + [_i64] * 4
    for fn in (lib.vd_right_align, lib.vd_hist_concat, lib.vd_facts,
               lib.vd_gather_options):
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def right_align(seq: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    seq = np.asarray(seq)
    L = seq.shape[-1]
    flat = _c(seq.reshape(-1, L))
    lens = _c(np.asarray(lengths).reshape(-1))
    out = np.empty_like(flat)
    _load().vd_right_align(flat, lens, out, flat.shape[0], L)
    return out.reshape(seq.shape)


def hist_concat(cap, cap_len, ques, ques_len, ans, ans_len, Lh: int):
    """Right-aligned LF history (B, R, Lh) from left-aligned components."""
    cap, ques, ans = _c(cap), _c(ques), _c(ans)
    B, R, Lq = ques.shape
    La, Lc = ans.shape[-1], cap.shape[-1]
    out = np.empty((B, R, Lh), np.int32)
    _load().vd_hist_concat(cap, _c(cap_len), ques, _c(ques_len),
                           ans, _c(ans_len), out, B, R, Lc, Lq, La, Lh)
    return out


def facts(cap, cap_len, ques, ques_len, ans, ans_len, Lf: int):
    """Right-aligned fact slots (B, R, Lf) + lengths (B, R)."""
    cap, ques, ans = _c(cap), _c(ques), _c(ans)
    B, R, Lq = ques.shape
    La, Lc = ans.shape[-1], cap.shape[-1]
    out = np.empty((B, R, Lf), np.int32)
    out_len = np.empty((B, R), np.int32)
    _load().vd_facts(cap, _c(cap_len), ques, _c(ques_len), ans, _c(ans_len),
                     out, out_len, B, R, Lc, Lq, La, Lf)
    return out, out_len


def gather_options(opt_list: np.ndarray, opt_inds: np.ndarray) -> np.ndarray:
    """opt_list[opt_inds] without numpy fancy-indexing overhead."""
    opt_list = _c(opt_list)
    opt_inds_c = _c(opt_inds)
    La = opt_list.shape[-1]
    flat = opt_inds_c.reshape(-1)
    out = np.empty((flat.shape[0], La), np.int32)
    _load().vd_gather_options(opt_list, flat, out, flat.shape[0], 1,
                              opt_list.shape[0], La)
    return out.reshape(opt_inds_c.shape + (La,))
