"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process for sm_90a
(all started together), and the objects are linked into one shared
library with a plain C interface, at first use, into
`build/torch_kernels/` at the repository root (git-ignored). The
library name carries a hash of the sources and flags, so an edit
rebuilds it. The wrappers bind the entry points with ctypes (`entry`):
tensor pointers and the CUDA stream go in as `c_void_p` (`VP`), ints as
`c_int` (`CI`), and every entry point returns `cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

VP, CI = ctypes.c_void_p, ctypes.c_int

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def sources() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(
            glob.glob(os.path.join(SRC_DIR, "*.cuh"))
            + glob.glob(os.path.join(SRC_DIR, "*.inc"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, "pcamv_kernels_%s.so" % h.hexdigest()[:16])


def _check_build(cmd, rc, err) -> None:
    if rc != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                           % (rc, " ".join(cmd), err))


def build() -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path."""
    global build_seconds
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    t0 = time.time()
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources():
        obj = "%s.%s.o" % (tmp, os.path.basename(src))
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for cmd, proc in procs:
        err = proc.communicate()[1]
        _check_build(cmd, proc.returncode, err)
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    r = subprocess.run(link, capture_output=True, text=True)
    _check_build(link, r.returncode, r.stderr)
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)
    build_seconds = time.time() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib


_entries = {}


def entry(name: str, argtypes):
    """The library's entry point `name` bound to `argtypes`, returning
    its CUDA error code (bound once a process: a wrapper's host time
    is part of every launch)."""
    key = (name, tuple(argtypes))
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[key] = fn
    return fn


def stream(t) -> ctypes.c_void_p:
    """The current CUDA stream of `t`'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, name: str) -> None:
    """Raise if an entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, rc))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_tensor(fn: str, name: str, t, dtype, shape) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError("%s: %s is not a CUDA tensor" % (fn, name))
    if t.dtype != dtype:
        raise TypeError("%s: %s dtype %s, expected %s"
                        % (fn, name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: %s shape %s, expected %s"
                         % (fn, name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s: %s is not contiguous" % (fn, name))
