"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources have a plain C interface and are compiled by nvcc (one process
per .cu file, all started together, then one link) into one shared
library, loaded with ctypes (no PyTorch headers, so a build takes seconds).
The library lands in build/visdial_tpu_torch/<hash>/ at the root of the
checkout, keyed by a hash of the sources and the flags, so a changed source
rebuilds and an unchanged one loads the existing library.

Importing this module needs no nvcc and no GPU; `library()` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from ..utils import trace

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "visdial_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_SIGNATURES = {
    # dtype, x, mask, w, b, h0c, h, c, hs, cs, N, T, Ep, Kx, KW, H, tile,
    # stream
    "vd_lstm_layer_fwd": [_i] + [_p] * 9 + [_i] * 7 + [_p],
    # the same with the rows a cluster in place of tile
    "vd_lstm_layer_fwd_resident": [_i] + [_p] * 9 + [_i] * 7 + [_p],
    # Kx, H, T
    "vd_lstm_resident_clusters": [_i] * 3,
    # dtype, x, hprev, cprev, mask, w, wh, b, ghs, dh, dc, dhp, dgp, N, T, Ep,
    # Kx, KW, H, S, tile, stream
    "vd_lstm_layer_bwd": [_i] + [_p] * 12 + [_i] * 8 + [_p],
    # dtype, q, slots, valid, valid's batch and row strides, out, B, R, S,
    # H, cl, stream
    "vd_attention": [_i] + [_p] * 3 + [_ll] * 2 + [_p] + [_i] * 5 + [_p],
    # dtype, route, q, slots, valid, its batch and row strides, w, bias, mem,
    # out, B, R, S, H, cl, ks, stream
    "vd_attention_fusion": [_i] * 2 + [_p] * 3 + [_ll] * 2 + [_p] * 4
                           + [_i] * 6 + [_p],
    # dtype, B, R, S, H, cl
    "vd_fusion_stream_fits": [_i] * 6,
    # dtype, x, wk, b, tgt, part, logp, lse, NT, Hp, V, tiles_per_split,
    # splits, stream
    "vd_lm_score": [_i] + [_p] * 7 + [_i] * 5 + [_p],
    # dtype, x, wk, b, tgt, lse, g, dlog, NT, Hp, V, stream
    "vd_lm_dlogits": [_i] + [_p] * 7 + [_i] * 3 + [_p],
}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "visdial_tpu_torch are built at first use")


def library_path() -> str:
    """Path of the built library, building it first if needed."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libvisdial_kernels.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("".join(logs))
    failed = [log for p, log in zip(procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    with trace.span("kernels.load"):
        lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vd_error_string.argtypes = [ctypes.c_int]
    lib.vd_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().vd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the pointer the C side takes."""
    return torch.cuda.current_stream(t.device).cuda_stream
