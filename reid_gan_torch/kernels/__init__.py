"""Build and bind the port's CUDA kernels.

The sources in ``reid_gan_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
ctypes. The build runs at first use, one ``nvcc`` per source in parallel and
then one link, into ``reid_gan_torch/build/`` under a name that hashes the
sources and flags, so a changed source is never served a stale library.
Nothing is built or imported from CUDA when this module is imported.

Each kernel is a :class:`CudaKernel` with one C entry point, or two (forward
and backward) for a kernel with a gradient: a call launches on the caller's
stream, raises if the C function reports a CUDA error (a ValueError for
``cudaErrorInvalidValue``, which a C entry returns for sizes it refuses, a
RuntimeError for any other), and counts its launches per phase in plain
integers (``launches``), so a run can show which kernels its path went
through. A kernel that needs device scratch has a C
query that returns its size (``scratch_size``), so its block geometry is
stated in the source alone.
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
CUDA_ERROR_INVALID_VALUE = 1      # cudaErrorInvalidValue: sizes a C entry refuses
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


class _Entry:
    """One C function of the library, bound at first use: a launch
    ``symbol(*args, stream)`` that returns a CUDA error code, or (with
    ``stream=False``) a query that returns ``restype``."""

    def __init__(self, symbol, argtypes, restype=ctypes.c_int, stream=True):
        self.symbol = symbol
        self.argtypes = list(argtypes) + ([ctypes.c_void_p] if stream else [])
        self.restype = restype
        self._fn = None

    def bind(self):
        lib = load_library()
        if self._fn is None:
            fn = getattr(lib.cdll, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = self.restype
            self._fn = fn
        return lib, self._fn

    def launch(self, args, device):
        import torch

        lib, fn = self.bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(*args, stream)
        if rc != 0:
            error = ValueError if rc == CUDA_ERROR_INVALID_VALUE else RuntimeError
            raise error(f"{self.symbol}: CUDA error {rc} ({lib.error_string(rc)})")


class CudaKernel:
    """A kernel of the port: its forward entry (``kernel(*args, device=)``)
    and, for a kernel with a gradient, its backward entry
    (``kernel.backward(*args, device=)``). ``launches`` counts the calls of
    each phase that reached the card. ``scratch``: the symbol of the C query
    that sizes the kernel's scratch, from ``scratch_args`` int arguments."""

    def __init__(self, name, symbol, argtypes, source, replaces, backward=None,
                 scratch=None, scratch_args=2):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.entries = {"forward": _Entry(symbol, argtypes)}
        if backward is not None:
            self.entries["backward"] = _Entry(*backward)
        self.launches = dict.fromkeys(self.entries, 0)
        self.scratch = None if scratch is None else _Entry(
            scratch, [ctypes.c_int] * scratch_args, ctypes.c_longlong, stream=False)

    def scratch_size(self, *args):
        """Elements of scratch the C entry needs for these sizes."""
        return self.scratch.bind()[1](*args)

    def _launch(self, phase, args, device):
        self.entries[phase].launch(args, device)
        self.launches[phase] += 1

    def __call__(self, *args, device):
        self._launch("forward", args, device)

    def backward(self, *args, device):
        self._launch("backward", args, device)


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
    [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I],
    source="reid_gan_torch/csrc/rank_stats.cu",
    replaces="reid_gan_tpu/engine/metrics.py:213")
TRAIN_AUGMENT = CudaKernel(
    "train_augment", "reid_train_augment",
    [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F],
    source="reid_gan_torch/csrc/train_augment.cu",
    replaces="reid_gan_tpu/ops/transforms.py:152",
    scratch="reid_train_augment_scratch", scratch_args=1)
GEM_POOL = CudaKernel(
    "gem_pool", "reid_gem_pool_forward",
    [_P, _P, _P, _P, _I, _I, _I, _F],
    source="reid_gan_torch/csrc/gem_pool.cu",
    replaces="reid_gan_tpu/models/pooling.py:18",
    backward=("reid_gem_pool_backward",
              [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F]),
    scratch="reid_gem_pool_backward_scratch")
INFONCE = CudaKernel(
    "infonce", "reid_infonce_forward",
    [_P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    source="reid_gan_torch/csrc/infonce.cu",
    replaces="reid_gan_tpu/ops/cluster_memory.py:58",
    backward=("reid_infonce_backward",
              [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _I, _P, _P]),
    scratch="reid_infonce_scratch", scratch_args=5)
BANK_FOLD = CudaKernel(
    "bank_fold", "reid_bank_fold",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I],
    source="reid_gan_torch/csrc/bank_fold.cu",
    replaces="reid_gan_tpu/ops/cluster_memory.py:103")

KNN_TOPK = CudaKernel(
    "knn_topk", "reid_knn_topk",
    [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    source="reid_gan_torch/csrc/knn_topk.cu",
    replaces="reid_gan_tpu/ops/distance.py:118",
    scratch="reid_knn_topk_scratch")

GAN_INPUT = CudaKernel(
    "gan_input", "reid_gan_input",
    [_P, _P, _L, _L],
    source="reid_gan_torch/csrc/gan_input.cu",
    replaces="reid_gan_tpu/ops/transforms.py:161")
POSE_MAPS = CudaKernel(
    "pose_maps", "reid_pose_maps",
    [_P, _P, _P, _I, _I, _I, _I, _F],
    source="reid_gan_torch/csrc/pose_maps.cu",
    replaces="reid_gan_tpu/ops/pose.py:42")
GAN_FEAT_L2N = CudaKernel(
    "gan_feat_l2n", "reid_gan_feat_l2n",
    [_P, _P, _L, _I, _I],
    source="reid_gan_torch/csrc/gan_feat_l2n.cu",
    replaces="reid_gan_tpu/models/resnet.py:186")

DIFF_TRANSFORM = CudaKernel(
    "diff_transform", "reid_diff_transform",
    [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F],
    source="reid_gan_torch/csrc/diff_transform.cu",
    replaces="reid_gan_tpu/ops/transforms.py:171")

POSE_PEAKS = CudaKernel(
    "pose_peaks", "reid_pose_peaks",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I],
    source="reid_gan_torch/csrc/pose_peaks.cu",
    replaces="reid_gan_tpu/ops/pose.py:63")
FD_AUGMENT = CudaKernel(
    "fd_augment", "reid_fd_augment",
    [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F],
    source="reid_gan_torch/csrc/fd_augment.cu",
    replaces="reid_gan_tpu/engine/fdgan.py:37")

KERNELS = (EVAL_TRANSFORM, GEM_BN_L2N, RANK_STATS, TRAIN_AUGMENT, GEM_POOL,
           INFONCE, BANK_FOLD, KNN_TOPK, GAN_INPUT, POSE_MAPS, GAN_FEAT_L2N,
           DIFF_TRANSFORM, POSE_PEAKS, FD_AUGMENT)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = dict.fromkeys(k.entries, 0)


def launch_counts():
    """Launches per kernel, all phases together."""
    return {k.name: sum(k.launches.values()) for k in KERNELS}


def phase_launch_counts():
    """Launches per kernel and phase, e.g. ``gem_pool.backward``."""
    return {f"{k.name}.{phase}": n for k in KERNELS for phase, n in k.launches.items()}
