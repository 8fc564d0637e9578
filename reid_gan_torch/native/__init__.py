"""ctypes bindings to the port's copy of the host C++ clustering code
(``reidnative.cc``: DBSCAN, the sparse k-reciprocal Jaccard, Infomap; port
of ``reid_gan_tpu/native/__init__.py``).

The library is built at first use with ``g++`` (the flags of
``reid_gan_tpu/native/Makefile``) into ``reid_gan_torch/build/`` under a name
that hashes the source and flags, so a changed source is never served a
stale library. A failed build raises; nothing falls back.
"""

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import tempfile
import threading

import numpy as np

_DIR = osp.dirname(osp.abspath(__file__))
SOURCE = osp.join(_DIR, "reidnative.cc")
BUILD_DIR = osp.join(osp.dirname(_DIR), "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-march=x86-64-v3")

_lib = None
_lib_lock = threading.Lock()


def _library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"libreidnative_{h.hexdigest()[:16]}.so")


def _build(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = osp.join(tmp, "lib.so")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-shared", SOURCE, "-o", tmp_lib],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}")
        os.replace(tmp_lib, path)


def ensure_built():
    """Build (if needed) and load the library; cached per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not osp.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
        i32p, i64p, f32p = (ctypes.POINTER(t) for t in (i32, i64, f32))
        lib.reid_dbscan.argtypes = [f32p, i32, f32, i32, i32p]
        lib.reid_dbscan.restype = None
        lib.reid_jaccard_minsum.argtypes = [i64p, i32p, f32p, i64p, i32p, f32p,
                                            i32, i32, f32p]
        lib.reid_jaccard_minsum.restype = None
        lib.reid_infomap.argtypes = [i32, i64, i32p, i32p, f32p, ctypes.c_double,
                                     i64, i32p]
        lib.reid_infomap.restype = i32
        lib.reid_kreciprocal_v.argtypes = [i32p, i32, i32, f32p, i32, i32, i32,
                                           i32p, f32p, i32p]
        lib.reid_kreciprocal_v.restype = i32
        lib.reid_kreciprocal_v_dist.argtypes = [i32p, i32, i32, f32p, i32, i32,
                                                i32p, f32p, i32p]
        lib.reid_kreciprocal_v_dist.restype = i32
        lib.reid_query_expand.argtypes = [i32p, f32p, i32p, i32, i32p, i32, i32,
                                          i32, i32, i32p, f32p, i32p]
        lib.reid_query_expand.restype = i32
        _lib = lib
        return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dbscan_native(dist, eps, min_samples=4):
    """DBSCAN over a dense (n, n) distance matrix → labels (n,) int32, −1 =
    noise."""
    lib = ensure_built()
    dist = np.ascontiguousarray(dist, np.float32)
    n = dist.shape[0]
    if dist.shape != (n, n):
        raise ValueError(f"dbscan_native takes a square matrix, got {dist.shape}")
    labels = np.empty(n, np.int32)
    lib.reid_dbscan(_ptr(dist, ctypes.c_float), n, float(eps), int(min_samples),
                    _ptr(labels, ctypes.c_int32))
    return labels


def _minsum(lib, indptr, indices, data, n, m):
    """Jaccard min-sum of V given as CSR (indptr, indices, data) → dense
    (m, n) float32, negatives clipped by the C function."""
    from scipy import sparse

    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    csc = sparse.csr_matrix((data, indices, indptr), shape=(n, n)).T.tocsr()  # CSR of Vᵀ
    out = np.empty((m, n), np.float32)
    lib.reid_jaccard_minsum(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_float),
        _ptr(np.ascontiguousarray(csc.indptr, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(csc.indices, np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(csc.data, np.float32), ctypes.c_float),
        n, m, _ptr(out, ctypes.c_float))
    return out


def jaccard_minsum_native(V, query_num=None):
    """V: dense (n, n) float32, mostly zeros → Jaccard rows (m, n). No path
    of the port calls this dense entry (they build V sparse and call
    ``jaccard_minsum_rows_native``); it is bound so that every entry of the
    library is held against the JAX package's in the tests."""
    from scipy import sparse

    lib = ensure_built()
    n = V.shape[0]
    csr = sparse.csr_matrix(np.asarray(V, np.float32))
    return _minsum(lib, csr.indptr, csr.indices, csr.data, n,
                   n if query_num is None else int(query_num))


def _kreciprocal_rows(lib, rank, k1, k2, call):
    """Retry and k2 query expansion around the two V builders.
    ``call(cap, idx, w, cnt)`` runs the C builder and returns the largest row
    it needed; rows past ``cap`` are cut, so a larger need is retried."""
    n, rank_w = rank.shape
    half = int(np.around(k1 / 2))
    cap = min(n, (min(k1, rank_w - 1) + 1) * (min(half, rank_w - 1) + 2))
    while True:
        idx = np.empty((n, cap), np.int32)
        w = np.empty((n, cap), np.float32)
        cnt = np.empty(n, np.int32)
        need = call(cap, idx, w, cnt)
        if need <= cap:
            break
        cap = need
    if k2 <= 1:
        return idx, w, cnt
    cap_out = min(n, int(k2) * cap)
    while True:
        idx2 = np.empty((n, cap_out), np.int32)
        w2 = np.empty((n, cap_out), np.float32)
        cnt2 = np.empty(n, np.int32)
        need = lib.reid_query_expand(
            _ptr(idx, ctypes.c_int32), _ptr(w, ctypes.c_float),
            _ptr(cnt, ctypes.c_int32), cap, _ptr(rank, ctypes.c_int32), rank_w, n,
            int(k2), cap_out, _ptr(idx2, ctypes.c_int32), _ptr(w2, ctypes.c_float),
            _ptr(cnt2, ctypes.c_int32))
        if need <= cap_out:
            break
        cap_out = need
    return idx2, w2, cnt2


def kreciprocal_v_native(initial_rank, feats, k1, k2):
    """Sparse k-reciprocal soft-assignment V with k2 query expansion, never
    dense (faiss_rerank.py:43-93). ``initial_rank``: (n, rank_w) int32 kNN
    table, self first; ``feats``: (n, d) float32, L2-normalised. Returns
    padded rows (idx (n, cap) int32, w (n, cap) float32, cnt (n,) int32)."""
    lib = ensure_built()
    rank = np.ascontiguousarray(initial_rank, np.int32)
    f = np.ascontiguousarray(feats, np.float32)
    n, rank_w = rank.shape
    if f.shape[0] != n:
        raise ValueError(f"kreciprocal_v_native: {n} rank rows, {f.shape[0]} features")

    def call(cap, idx, w, cnt):
        return lib.reid_kreciprocal_v(
            _ptr(rank, ctypes.c_int32), n, rank_w, _ptr(f, ctypes.c_float),
            f.shape[1], int(k1), cap, _ptr(idx, ctypes.c_int32),
            _ptr(w, ctypes.c_float), _ptr(cnt, ctypes.c_int32))

    return _kreciprocal_rows(lib, rank, k1, k2, call)


def kreciprocal_v_dist_native(initial_rank, dist, k1, k2):
    """The same sparse V, weighted exp(−dist[i, j]) from a dense (n, n)
    distance matrix: the eval re-ranking flavour (rerank.py:55-71)."""
    lib = ensure_built()
    rank = np.ascontiguousarray(initial_rank, np.int32)
    d = np.ascontiguousarray(dist, np.float32)
    n, rank_w = rank.shape
    if d.shape != (n, n):
        raise ValueError(f"kreciprocal_v_dist_native: dist {d.shape}, rank rows {n}")

    def call(cap, idx, w, cnt):
        return lib.reid_kreciprocal_v_dist(
            _ptr(rank, ctypes.c_int32), n, rank_w, _ptr(d, ctypes.c_float),
            int(k1), cap, _ptr(idx, ctypes.c_int32), _ptr(w, ctypes.c_float),
            _ptr(cnt, ctypes.c_int32))

    return _kreciprocal_rows(lib, rank, k1, k2, call)


def jaccard_minsum_rows_native(idx, w, cnt, query_num=None):
    """Jaccard min-sum over padded sparse rows (the ``kreciprocal_v_*``
    output) → dense (m, n) float32, negatives clipped."""
    lib = ensure_built()
    n, cap = idx.shape
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(cnt.astype(np.int64), out=indptr[1:])
    mask = np.arange(cap)[None, :] < cnt[:, None]
    return _minsum(lib, indptr, idx[mask], w[mask], n,
                   n if query_num is None else int(query_num))


def infomap_native(src, dst, weight, n, tau=0.15, seed=0):
    """Directed weighted edge list → (labels (n,) int32, number of
    modules)."""
    lib = ensure_built()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    weight = np.ascontiguousarray(weight, np.float32)
    labels = np.empty(n, np.int32)
    k = lib.reid_infomap(int(n), int(len(src)), _ptr(src, ctypes.c_int32),
                         _ptr(dst, ctypes.c_int32), _ptr(weight, ctypes.c_float),
                         float(tau), int(seed), _ptr(labels, ctypes.c_int32))
    return labels, int(k)
