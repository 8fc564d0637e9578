"""Build and bind the port's CUDA kernels.

The sources in ``reid_gan_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
ctypes. The build runs at first use, one ``nvcc`` per source in parallel and
then one link, into ``reid_gan_torch/build/`` under a name that hashes the
sources and flags, so a changed source is never served a stale library.
Nothing is built or imported from CUDA when this module is imported.

Each entry point is a :class:`CudaKernel`: it launches on the caller's
stream, raises if the C function reports a CUDA error, and counts its
launches in a plain integer (``launches``), so a run can show which kernels
its path went through.
"""

import ctypes
import glob
import hashlib
import os
import os.path as osp
import subprocess
import tempfile
import threading
import time

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(_PKG, "build")
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")


class KernelLibrary:
    """The loaded library, with the compiler's output (``-Xptxas -v``
    register and shared-memory report) and the build's wall time (0 when a
    library built from the same sources was already there)."""

    def __init__(self, path, log, seconds):
        self.path = path
        self.log = log
        self.seconds = seconds
        self.cdll = ctypes.CDLL(path)
        self.cdll.reid_cuda_error_string.argtypes = [ctypes.c_int]
        self.cdll.reid_cuda_error_string.restype = ctypes.c_char_p

    def error_string(self, code):
        return self.cdll.reid_cuda_error_string(code).decode()


_lib = None
_lib_lock = threading.Lock()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return osp.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    srcs = sorted(glob.glob(osp.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(osp.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, headers


def _library_path(srcs, headers):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + headers:
        h.update(osp.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return osp.join(BUILD_DIR, f"libreid_kernels_{h.hexdigest()[:16]}.so")


def _build(srcs, lib_path):
    """Compile every source at once (one nvcc each), then link. Waits for
    every compiler process before raising on a failure."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = osp.join(tmp, osp.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [s for s, p in zip(srcs, procs) if p.returncode != 0]
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = osp.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp_lib],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return log + link.stdout


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            srcs, headers = _sources()
            path = _library_path(srcs, headers)
            t0 = time.perf_counter()
            log = "" if osp.exists(path) else _build(srcs, path)
            _lib = KernelLibrary(path, log, time.perf_counter() - t0)
        return _lib


class CudaKernel:
    """One C entry point of the library: ``symbol(*args, stream)``."""

    def __init__(self, name, symbol, argtypes, source, replaces):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # the stream
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args, device):
        import torch

        lib = load_library()
        if self._fn is None:
            fn = getattr(lib.cdll, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({lib.error_string(rc)})")
        self.launches += 1


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

EVAL_TRANSFORM = CudaKernel(
    "eval_transform", "reid_eval_transform",
    [_P, _P, _L, _I, _F, _F, _F, _F, _F, _F],
    source="reid_gan_torch/csrc/eval_transform.cu",
    replaces="reid_gan_tpu/ops/transforms.py:137")
GEM_BN_L2N = CudaKernel(
    "gem_bn_l2n", "reid_gem_bn_l2n",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F],
    source="reid_gan_torch/csrc/gem_bn_l2n.cu",
    replaces="reid_gan_tpu/models/pooling.py:18")
RANK_STATS = CudaKernel(
    "rank_stats", "reid_rank_stats",
    [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    source="reid_gan_torch/csrc/rank_stats.cu",
    replaces="reid_gan_tpu/engine/metrics.py:213")

KERNELS = (EVAL_TRANSFORM, GEM_BN_L2N, RANK_STATS)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.name: k.launches for k in KERNELS}
