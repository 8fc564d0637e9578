"""Variants of K2 (``reid_gan_torch/csrc/gem_bn_l2n.cu``) and K7
(``reid_gan_torch/csrc/bank_fold.cu``) timed in turns on the card.

Each variant is the kernel's source with a small patch, built with ``nvcc``
into a library of its own under ``reid_gan_torch/build/fold_pool_probe/``
and called through the same C entry as the kernel. For each shape the
script checks the kernel and every variant against the plain version, times
each twice in turns (A B .. B A) with CUDA events, and says whether each
writes the kernel's bits. Variants:

- K2 ``cluster8`` and ``cluster16``: clusters of at most 8 blocks (a
  portable size; at C 2048 each block takes two chunks of 128 channels, one
  after the other) or 16 at every N, where the kernel takes 16 while the
  grid fits the card at once and 8 past it;
- K2 ``bounds8``: the launch bound of 8 blocks an SM (32 registers)
  instead of 6 (40 registers);
- K2 ``no_cluster_sum``: timing only, the norm is wrong: each block scales
  by its own partial, a block barrier in place of the cluster's two, so the
  difference is what the cluster's sum costs;
- K7 ``threads256`` and ``threads512``: 256 or 512 threads a block (D /
  256 or D / 512 elements of the row a thread, 8 or 16 warps a reduction)
  instead of 128;
- K7 ``gram``: the chain in Gram form, for each block of up to 16 staged
  rows: the Gram matrix of the row and the rows (a warp a pair), a scalar
  recurrence over the fold's coefficients in one thread (each step's norm
  from the Gram entries), then one pass forming the row as a linear
  combination; other arithmetic than the plain fold's, so it is held to
  the plain fold's tolerance, not to its bits; ``gram512`` and
  ``gram1024`` the same with 512 or 1,024 threads (16 or 32 warps for the
  Gram's pairs);
- K7 ``rsqrt`` and ``no_shuffle``: timing only, each takes a piece out of
  the chain's step to show what it costs: ``rsqrtf`` for the step's two
  IEEE ``1 / sqrtf`` (other bits), or the reduction's warp shuffles left
  out (wrong sums);
- K7 ``smem100`` and ``smem48``: 100 or 48 KiB of dynamic shared memory
  instead of 216 (at D 2048, 10 or 4 staged rows, so 16 slots stream in
  halves), to show what the large allocation costs at launch.

Beside them, ``baseline`` times a one-element ``add_`` the same way: the
floor of the method (the launch and the events).

``--phases`` builds both kernels once more with ``clock64`` counters and
prints the mean cycles of a working block in its phases (K2: its chunks,
the cluster barrier, the scale and store; K7: set-up, the chain with its
waits for the staged rows, and the refills, and the cycles a chain step)
and the global timer from the first block's start to the last block's
end.

Shapes: K2 at (256, 2048, 16, 8) and (16, 2048, 16, 8); K7 at 16 labels x
16 and one label 256 deep, D 2048, and the joint fold of both banks.

Run on a machine with an H100:

    python scripts/torch_fold_pool_probe.py [--phases]
"""

import argparse
import ctypes
import os
import os.path as osp
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = osp.join(ROOT, "reid_gan_torch", "csrc")
BUILD = osp.join(ROOT, "reid_gan_torch", "build", "fold_pool_probe")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _sub(src, old, new):
    if old not in src:
        raise ValueError(f"the kernel source has no {old[:60]!r}")
    return src.replace(old, new)


def _cluster(size):
    def variant(src):
        return _sub(src, "? kBusyCluster : kMaxCluster;", f"? {size} : {size};")
    return variant


def _threads(n):
    def variant(src):
        return _sub(src, "constexpr int kThreads = 128;", f"constexpr int kThreads = {n};")
    return variant


def bounds8(src):
    return _sub(src, "constexpr int kBlocksPerSm = 6; ", "constexpr int kBlocksPerSm = 8; ")


def no_cluster_sum(src):
    """Timing only (the norm is wrong): each block scales by its own
    partial, with a block barrier in place of the cluster's two."""
    src = _sub(src, "  cluster.sync();   // every block's", "  __syncthreads();   // every block's")
    src = _sub(src, "lane < csize ? *cluster.map_shared_rank(&partial, lane) : 0.0f;",
               "partial;")
    src = _sub(src, "  cluster_arrive();   // this", "  // this")
    return _sub(src, "  cluster_wait();   // no block", "  // no block")


def rsqrt(src):
    """Timing only (other bits): rsqrtf for the chain's two 1 / sqrtf."""
    src = _sub(src, "  const float inv = 1.0f / sqrtf(tot.x + 1e-24f);",
               "  const float inv = rsqrtf(tot.x + 1e-24f);")
    return _sub(src, "    const float r = normalize ? 1.0f / sqrtf(sx + 1e-12f) : 1.0f;",
                "    const float r = normalize ? rsqrtf(sx + 1e-12f) : 1.0f;")


def _smem(kib):
    def variant(src):
        return _sub(src, "constexpr int kSmemBytes = 216 * 1024; ",
                    f"constexpr int kSmemBytes = {kib} * 1024; ")
    return variant


def no_shuffle(src):
    """Timing only (wrong sums): the chain's reduction without its shuffles."""
    return _sub(src, "for (int o = reid::kWarp / 2; o > 0; o >>= 1) {", "for (int o = 0; o > 0; o >>= 1) {")


GRAM = r"""// The chain in Gram form: for a block of q <= 16 staged rows, the Gram
// matrix of the row v0 and the rows x_1 .. x_q (a warp a pair), a scalar
// recurrence in one thread over the fold's coefficients, with each step's
// norm |a m + b xh|^2 = a^2 |m|^2 + 2 a b <m, xh> + b^2 |xh|^2 from the
// Gram entries, then one pass: row = c_0 v0 + sum_k c_k r_k x_k.
constexpr int kGram = 17;

template <int kPer>
__device__ __forceinline__ void chain_gram(float (&row)[kPer], const float* rows_s, float* v0,
                                           int m, int D, bool normalize, float a, float b) {
  __shared__ float G[kGram][kGram];
  __shared__ float coef[kGram], rk[kGram];
  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;
  for (int k0 = 0; k0 < m; k0 += kGram - 1) {
    const int q = min(kGram - 1, m - k0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d < D) v0[d] = row[j];
    }
    __syncthreads();
    const int pairs = (q + 1) * (q + 2) / 2;
    for (int p = warp; p < pairs; p += kWarps) {
      int i = 0, rem = p;
      while (rem >= q + 1 - i) {
        rem -= q + 1 - i;
        ++i;
      }
      const int j = i + rem;
      const float4* u = reinterpret_cast<const float4*>(
          i == 0 ? v0 : rows_s + static_cast<size_t>(k0 + i - 1) * D);
      const float4* v = reinterpret_cast<const float4*>(
          j == 0 ? v0 : rows_s + static_cast<size_t>(k0 + j - 1) * D);
      float dot = 0.0f;
      for (int e = lane; e < D / 4; e += reid::kWarp) {
        const float4 x = u[e], y = v[e];
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      dot = reid::warp_sum(dot);
      if (lane == 0) {
        G[i][j] = dot;
        G[j][i] = dot;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float c[kGram], r[kGram];
      c[0] = 1.0f;
      r[0] = 1.0f;
      float n2 = G[0][0];
#pragma unroll
      for (int k = 1; k < kGram; ++k) {
        c[k] = 0.0f;
        r[k] = k <= q && normalize ? 1.0f / sqrtf(G[k][k] + 1e-12f) : 1.0f;
      }
#pragma unroll
      for (int k = 1; k < kGram; ++k) {
        if (k <= q) {
          float dot = c[0] * G[0][k];
#pragma unroll
          for (int i = 1; i < k; ++i) dot += c[i] * r[i] * G[i][k];
          dot *= r[k];
          const float x2 = r[k] * r[k] * G[k][k];
          const float u2 = a * a * n2 + 2.0f * a * b * dot + b * b * x2;
          const float inv = 1.0f / sqrtf(u2 + 1e-24f);
#pragma unroll
          for (int i = 0; i < k; ++i) c[i] *= a * inv;
          c[k] = b * inv;
          n2 = u2 * inv * inv;
        }
      }
#pragma unroll
      for (int k = 0; k < kGram; ++k) {
        coef[k] = c[k];
        rk[k] = r[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d < D) {
        float acc = coef[0] * row[j];
        for (int k = 1; k <= q; ++k)
          acc += coef[k] * (rk[k] * rows_s[static_cast<size_t>(k0 + k - 1) * D + d]);
        row[j] = acc;
      }
    }
    __syncthreads();   // v0 and G are written again by the next block of rows
  }
}

"""


def gram(src):
    """The optional probe: the chain in Gram form (GRAM)."""
    src = _sub(src, "// kPer: elements of a row a thread", GRAM + "// kPer: elements of a row a thread")
    return _sub(src, "chain(row, rows_s, bars_s, phase[buf], m, D, normalize, a, b, scratch, parity);",
                "for (int k = 0; k < m; ++k) wait_row(bars_s + k, phase[buf]);\n"
                "      chain_gram(row, rows_s, old_row, m, D, normalize, a, b);")


CLOCK = r"""__device__ unsigned long long g_clk[16];

extern "C" int reid_probe_clock(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    z[14] = ~0ull;
    return static_cast<int>(cudaMemcpyToSymbol(g_clk, z, sizeof(z)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk)));
}

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

namespace {
"""


def k2_phases(src):
    """clock64 at a block's start, after its chunks (stream and tail), after
    the cluster barrier and at its end, summed over blocks; the first
    block's start and the last block's end on the global timer."""
    src = _sub(src, "namespace {\n", CLOCK)
    src = _sub(src, "  namespace cg = cooperative_groups;\n",
               "  namespace cg = cooperative_groups;\n  const long long q0 = clock64();\n"
               "  if (threadIdx.x == 0) atomicMin(&g_clk[14], gtime());\n")
    src = _sub(src, "  if (threadIdx.x < kChunk) {\n    ss = reid::warp_sum(ss);",
               "  const long long q1 = clock64();\n  if (threadIdx.x < kChunk) {\n"
               "    ss = reid::warp_sum(ss);")
    src = _sub(src, "  float inv = 0.0f;\n", "  const long long q2 = clock64();\n  float inv = 0.0f;\n")
    return _sub(src, "  cluster_wait();   // no block leaves while another may still read its partial\n",
                "  cluster_wait();   // no block leaves while another may still read its partial\n"
                "  if (threadIdx.x == 0) {\n    atomicAdd(&g_clk[0], q1 - q0);\n"
                "    atomicAdd(&g_clk[1], q2 - q1);\n    atomicAdd(&g_clk[2], clock64() - q2);\n"
                "    atomicAdd(&g_clk[7], 1ull);\n    atomicMax(&g_clk[15], gtime());\n  }\n")


def k7_phases(src):
    """clock64 in a working block: set-up (first window, row load, copies
    issued), the chain (its waits for the staged rows included) and the
    refills, summed over blocks, with the steps taken; the first block's
    start and the last block's end on the global timer."""
    src = _sub(src, "namespace {\n", CLOCK)
    src = _sub(src, "  const bool second = banks == 2",
               "  if (threadIdx.x == 0) atomicMin(&g_clk[14], gtime());\n  const bool second = banks == 2")
    src = _sub(src, "  if (__syncthreads_or(earlier)) return;\n",
               "  if (__syncthreads_or(earlier)) return;\n"
               "  long long q0 = clock64(), qc = 0, qr = 0, qa = 0, qb = 0, qs = 0;\n")
    src = _sub(src, "  int parity = 0;\n", "  const long long q1 = clock64();\n  int parity = 0;\n")
    src = _sub(src, "    uint64_t* const bars_s = bars + buf * half;\n",
               "    uint64_t* const bars_s = bars + buf * half;\n    qb = clock64();\n")
    src = _sub(src, "    // this buffer is read: refill it",
               "    qa = clock64();\n    qc += qa - qb;\n    qs += m;\n    qb = qa;\n"
               "    // this buffer is read: refill it")
    src = _sub(src, "    if (!ring) break;\n", "    qr += clock64() - qb;\n    if (!ring) break;\n")
    return _sub(src, "    if (d < D) my[d] = row[j];\n  }\n}\n",
                "    if (d < D) my[d] = row[j];\n  }\n"
                "  if (threadIdx.x == 0) {\n    atomicAdd(&g_clk[0], q1 - q0);\n"
                "    atomicAdd(&g_clk[3], qc);\n    atomicAdd(&g_clk[4], qr);\n"
                "    atomicAdd(&g_clk[5], clock64() - q0);\n    atomicAdd(&g_clk[6], qs);\n"
                "    atomicAdd(&g_clk[7], 1ull);\n    atomicMax(&g_clk[15], gtime());\n  }\n}\n")


K2_VARIANTS = {"cluster8": _cluster(8), "cluster16": _cluster(16), "bounds8": bounds8,
               "no_cluster_sum": no_cluster_sum}
K7_VARIANTS = {"threads256": _threads(256), "threads512": _threads(512), "gram": gram,
               "gram512": lambda src: gram(_threads(512)(src)),
               "gram1024": lambda src: gram(_threads(1024)(src)),
               "rsqrt": rsqrt, "no_shuffle": no_shuffle, "smem100": _smem(100),
               "smem48": _smem(48)}
PHASES = {"gem_bn_l2n.cu": k2_phases, "bank_fold.cu": k7_phases}


def build(name, source, text):
    os.makedirs(BUILD, exist_ok=True)
    cu = osp.join(BUILD, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = osp.join(BUILD, f"lib{name}.so")
    from torch.utils.cpp_extension import CUDA_HOME

    p = subprocess.run([osp.join(CUDA_HOME, "bin", "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared",
                        "-I", CSRC, cu, "-o", so], capture_output=True, text=True)
    if p.returncode:
        print(f"[build] {name}: nvcc failed, left out\n{p.stdout}{p.stderr}")
        return source, name, None
    lib = ctypes.CDLL(so)
    if source.endswith("gem_bn_l2n.cu"):
        lib.reid_gem_bn_l2n.argtypes = [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P]
    else:
        lib.reid_bank_fold.argtypes = [_P] * 5 + [_I] * 5 + [_F] * 2 + [_I, _P]
    if source.startswith("phases:"):
        lib.reid_probe_clock.argtypes = [_P, _I]
    return source, name, lib


def _rc(rc, symbol):
    if rc:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")


def k2_call(lib, fmap, p, gamma, mean, var):
    n, c, h, w = fmap.shape
    out = torch.empty((n, c), device="cuda")
    _rc(lib.reid_gem_bn_l2n(fmap.data_ptr(), p.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
                            var.data_ptr(), out.data_ptr(), n, h * w, c, 1e-6, 1e-5,
                            torch.cuda.current_stream().cuda_stream), "reid_gem_bn_l2n")
    return out


def k7_call(lib, state, x, y, gan_x=None):
    bank, gan = state.features, state.gan_features if gan_x is not None else None
    _rc(lib.reid_bank_fold(bank.data_ptr(), x.data_ptr(), None if gan is None else gan.data_ptr(),
                           None if gan is None else gan_x.data_ptr(), y.data_ptr(), x.shape[0],
                           bank.shape[0], bank.shape[1], 0 if gan is None else gan.shape[0],
                           0 if gan is None else gan.shape[1], 0.2, 0.8, 0,
                           torch.cuda.current_stream().cuda_stream), "reid_bank_fold")
    return state


def _in_turns(libs, fn, label, check):
    """Times fn(lib) for every library twice, in turns; prints each one's
    times, its error (check) and whether it writes the kernel's bits."""
    import chip_smoke as cs

    names = list(libs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cs.device_ms(lambda: fn(libs[name]), reps=10))
    first = None
    for name in names:
        err, bits = check(libs[name])
        first = bits if first is None else first
        same = all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                   for u, v in zip(bits, first))
        print(f"[probe] {label} {name}: ms {times[name][0]:.4f}, {times[name][1]:.4f}; "
              f"max_abs_err {err:.3g}; the kernel's bits: {same}")


def baseline():
    import chip_smoke as cs

    t = torch.zeros(1, device="cuda")
    ms = [cs.device_ms(lambda: t.add_(1.0), reps=10) for _ in range(2)]
    print(f"[probe] baseline, a one-element add_: ms {ms[0]:.4f}, {ms[1]:.4f}")


def probe_k2(libs):
    from reid_gan_torch.models.pooling import gem_bn_l2n_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    c = 2048
    p = torch.tensor([3.0], device="cuda")
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    mean = torch.rand(c, device="cuda", generator=g) * 0.2
    var = torch.rand(c, device="cuda", generator=g) + 0.5
    for n in (256, 16):
        fmap = torch.relu(torch.rand((n, c, 16, 8), device="cuda", generator=g) * 2.0 - 0.3)
        fmap = fmap.contiguous(memory_format=torch.channels_last)
        args = (fmap, p, gamma, mean, var)
        ref = gem_bn_l2n_plain(*args)

        def check(lib):
            out = k2_call(lib, *args)
            torch.cuda.synchronize()
            return float((out - ref).abs().max()), (out,)

        _in_turns(libs, lambda lib: k2_call(lib, *args), f"K2 N {n}", check)


def probe_k7(libs):
    from reid_gan_torch.ops.cluster_memory import init_memory, update_memory_plain

    g = torch.Generator(device="cuda").manual_seed(7)
    b, d, nv, k_pad = 256, 2048, 700, 768
    centers = torch.nn.functional.normalize(torch.randn((nv, d), device="cuda", generator=g), dim=1)
    gan_centers = torch.randn((nv, d), device="cuda", generator=g)
    ids = torch.randperm(nv, device="cuda", generator=g)[:16]
    y = ids.repeat_interleave(16)[torch.randperm(b, device="cuda", generator=g)]
    y = y.to(torch.int32).contiguous()
    x = centers[y.long()] + 0.3 * torch.randn((b, d), device="cuda", generator=g)
    gx = gan_centers[y.long()] + torch.randn((b, d), device="cuda", generator=g)
    one = torch.full_like(y, int(ids[0]))
    for label, yy, gan in (("K7 16 x 16", y, None), ("K7 joint 16 x 16", y, gx),
                           ("K7 one label 256 deep", one, None)):
        def fresh():
            return init_memory(centers, k_pad=k_pad, device="cuda",
                               gan_centroids=None if gan is None else gan_centers)

        ref = update_memory_plain(fresh(), x, yy, gan_x=gan)
        timed = fresh()

        def check(lib):
            out = k7_call(lib, fresh(), x, yy, gan)
            torch.cuda.synchronize()
            err = float((out.features - ref.features).abs().max())
            if gan is not None:
                err = max(err, float((out.gan_features - ref.gan_features).abs().max()))
            return err, (out.features, out.gan_features)

        _in_turns(libs, lambda lib: k7_call(lib, timed, x, yy, gan), label, check)


def _phase_call(lib, fn, labels, cycles_to):
    """Runs fn(lib) once after a warm call with the counters zeroed, then
    prints the counters' means over the working blocks."""
    fn(lib)
    torch.cuda.synchronize()
    clk = (ctypes.c_ulonglong * 16)()
    _rc(lib.reid_probe_clock(ctypes.cast(clk, ctypes.c_void_p), 1), "reid_probe_clock")
    fn(lib)
    torch.cuda.synchronize()
    _rc(lib.reid_probe_clock(ctypes.cast(clk, ctypes.c_void_p), 0), "reid_probe_clock")
    blocks = max(clk[7], 1)
    means = ", ".join(f"{name} {clk[i] / blocks:.0f}" for i, name in labels)
    extra = cycles_to(clk) if cycles_to else ""
    print(f"[phases] {means} cycles a working block ({clk[7]} blocks){extra}; first block's "
          f"start to last block's end {(clk[15] - clk[14]) / 1e3:.2f} us")


def report_phases(libs):
    """The K2 and K7 kernels with clock64 counters (``--phases``)."""
    k2, k7 = libs.get("gem_bn_l2n.cu"), libs.get("bank_fold.cu")
    g = torch.Generator(device="cuda").manual_seed(2)
    c = 2048
    p = torch.tensor([3.0], device="cuda")
    bn = [torch.rand(c, device="cuda", generator=g) + 0.5 for _ in range(3)]
    for n in (256, 16):
        fmap = torch.relu(torch.rand((n, c, 16, 8), device="cuda", generator=g) * 2.0 - 0.3)
        fmap = fmap.contiguous(memory_format=torch.channels_last)
        print(f"[phases] K2 N {n}:")
        _phase_call(k2, lambda lib: k2_call(lib, fmap, p, *bn),
                    ((0, "chunks (stream and tail)"), (1, "cluster barrier"), (2, "scale and store")),
                    None)
    from reid_gan_torch.ops.cluster_memory import init_memory

    b, d, nv = 256, 2048, 700
    centers = torch.nn.functional.normalize(torch.randn((nv, d), device="cuda", generator=g), dim=1)
    ids = torch.randperm(nv, device="cuda", generator=g)[:16]
    y = ids.repeat_interleave(16)[torch.randperm(b, device="cuda", generator=g)]
    y = y.to(torch.int32).contiguous()
    x = centers[y.long()] + 0.3 * torch.randn((b, d), device="cuda", generator=g)
    for label, yy in (("16 x 16", y), ("one label 256 deep", torch.full_like(y, int(ids[0])))):
        state = init_memory(centers, k_pad=768, device="cuda")
        print(f"[phases] K7 {label}:")
        _phase_call(k7, lambda lib: k7_call(lib, state, x, yy),
                    ((0, "set-up"), (3, "chain"), (4, "refills"), (5, "whole block")),
                    lambda clk: f"; {clk[3] / max(clk[6], 1):.0f} cycles a chain step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true",
                    help="the kernels' block phases in cycles (clock64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fold_pool_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    jobs = []
    for source, variants in (("gem_bn_l2n.cu", K2_VARIANTS), ("bank_fold.cu", K7_VARIANTS)):
        with open(osp.join(CSRC, source)) as fh:
            src = fh.read()
        jobs.append((source, f"{source[:-3]}_kernel", src))
        jobs += [(source, f"{source[:-3]}_{v}", fn(src)) for v, fn in variants.items()]
        if args.phases:
            jobs.append(("phases:" + source, f"{source[:-3]}_phases", PHASES[source](src)))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build(job[1], job[0], job[2]), jobs))
    libs = {source: {name: lib for s, name, lib in built if s == source and lib is not None}
            for source in ("gem_bn_l2n.cu", "bank_fold.cu")}
    if args.phases:
        report_phases({s[len("phases:"):]: lib for s, _, lib in built
                       if s.startswith("phases:") and lib is not None})
    baseline()
    probe_k2(libs["gem_bn_l2n.cu"])
    probe_k7(libs["bank_fold.cu"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
