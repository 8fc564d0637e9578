"""Variants of K8 (``reid_gan_torch/csrc/knn_topk.cu``) timed in turns on the card.

Each variant is the kernel's source with a small patch, built with ``nvcc``
into a library of its own under ``reid_gan_torch/build/knn_probe/`` and
called through the same C entry as K8. For each shape the script checks the
kernel as it is against the plain kNN, then times every variant twice in
turns (A B C .. C B A) with CUDA events and says whether each writes the
same bits as the kernel. Variants:

- ``both_triangles``: the same step kernel over all T steps, each block
  taking only the direct side of its pair (the full N x N of products on
  wgmma, no mailbox), against the circulant schedule's T / 2 steps that
  send each pair's transposed side to its owner;
- ``chunk32``, ``chunk64``, ``chunk256``, ``chunk2048``: the tensor cores'
  accumulator restarted every 32, 64, 256 or 2048 of D instead of 128;
- ``ring2``: a 2-slot cp.async ring (one stage in flight) instead of 3;
- ``lists_in_scratch``: k <= 64 with the lists in scratch and a warp's
  registers (as k <= 128), not in shared memory;
- ``stage64``: stages of 64 of D (a 2-slot ring, lists in scratch: shared
  memory holds no more);
- ``overlap``: stage j's products kept running on the tensor cores while the
  threads split stage j + 1 into a second set of parts (B's in shared
  memory, A's in registers) and copy stage j + 2; the same arithmetic.

``--phases`` builds the kernel once more with ``clock64`` counters and
prints the mean cycles of a block's step in its phases (lists and mailbox,
product, keys and selection, emission and lists back) and, within the
product, of a stage's wait for its copies, its split and barriers, and its
products on the tensor cores, summed over the stages.

Run on a machine with an H100 (``--big`` adds N 32,621):

    python scripts/torch_knn_probe.py [--variants a,b] [--big] [--phases]
"""

import argparse
import ctypes
import os
import os.path as osp
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = osp.join(ROOT, "reid_gan_torch", "csrc")
BUILD = osp.join(ROOT, "reid_gan_torch", "build", "knn_probe")


def _sub(src, old, new):
    if old not in src:
        raise ValueError(f"the kernel source has no {old[:60]!r}")
    return src.replace(old, new)


def both_triangles(src):
    src = _sub(src, "bool emits(int d, int T) { return d >= 1 && !(T % 2 == 0 && d == T / 2); }",
               "bool emits(int, int) { return false; }")
    return _sub(src, "const int T = tiles_of(n), last = T / 2;",
                "const int T = tiles_of(n), last = T - 1;")


def _chunk(stages):
    def variant(src):
        return _sub(src, "constexpr int kChunkStages = 4; ",
                    f"constexpr int kChunkStages = {stages}; ")
    return variant


def ring2(src):
    return _sub(src, "constexpr int kStages = 3; ", "constexpr int kStages = 2; ")


def lists_in_scratch(src):
    src = _sub(src, "constexpr int kListFloats = kTile * kSharedK;",
               "constexpr int kListFloats = 0;")
    return _sub(src, "auto kernel = k <= kSharedK ? knn_step_kernel<kShared>",
                "auto kernel = k < 1 ? knn_step_kernel<kShared>")


def stage64(src):
    src = _sub(src, "constexpr int kBK = 32; ", "constexpr int kBK = 64; ")
    src = _sub(src, "constexpr int kStages = 3; ", "constexpr int kStages = 2; ")
    src = _sub(src, "constexpr int kChunkStages = 4; ", "constexpr int kChunkStages = 2; ")
    return lists_in_scratch(src)


OVERLAP_CONSTANTS = r"""constexpr int kRing = 3;                      // cp.async ring of raw stages

// shared memory: the ring of raw A and B tiles (the key tile reuses it), two
// buffers of B's hi and lo parts, the lists (kShared), the rows' k-th pairs,
// the norms. A tile of a stage is 128 rows x 32 floats in wgmma's
// no-swizzle K-major layout: core matrix (row / 8, col / 4), 8 rows x 16
// bytes, at ((row / 8) * 8 + col / 4) * 128 bytes.
constexpr int kPartFloats = kTile * kBK;
constexpr int kRingFloats = kRing * 2 * kPartFloats;
constexpr int kListFloats = kTile * kSharedK;
static_assert(kTile * kKeyStride <= kRingFloats, "the key tile fits the ring");
constexpr int kSmemBytes =
    (kRingFloats + 4 * kPartFloats + 2 * kListFloats + 2 * kTile + 2 * kTile) * 4;

"""

OVERLAP_PRODUCT = r"""// Stage j of the product into a ring slot (A then B, each in the core-matrix
// layout): rows a0.. of A and b0.. of B, D columns j * kBK onwards, zeros
// past n rows and past dim. Copy i of a thread is row (w % 16) * 8 + lane %
// 8, column group (w / 16) * 4 + lane / 8, w = warp + 8 i: a warp reads 8
// rows x 64 contiguous bytes, and the 8 lanes of a quarter-warp fill one
// core matrix.
__device__ __forceinline__ void load_stage(float* slot, const float* __restrict__ x, int n,
                                           int dim, int a0, int b0, int j) {
  const int lane = threadIdx.x % reid::kWarp;
#pragma unroll
  for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
    const int w = threadIdx.x / reid::kWarp + kWarps * i;
    const int row = (w % 16) * 8 + lane % 8, kq = (w / 16) * 4 + lane / 8;
    const int col = j * kBK + kq * 4;
    const int at = ((row / 8) * 8 + kq) * (kCoreBytes / 4) + (row % 8) * 4;
    const bool va = col < dim && a0 + row < n, vb = col < dim && b0 + row < n;
    reid::cp_async16(slot + at, va ? x + static_cast<size_t>(a0 + row) * dim + col : x, va);
    reid::cp_async16(slot + kPartFloats + at,
                     vb ? x + static_cast<size_t>(b0 + row) * dim + col : x, vb);
  }
}

// Splits a landed stage (x = hi + lo, hi rounded to tf32, wgmma_tf32.cuh):
// B into its hi and lo parts (bh, bl: the same layout as the slot), and
// this warp's fragments of A into ah, al (a k = 8 step s: A(m, k) at (m, k)
// = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), m from the warp's first
// row 16 * warp, g = lane / 4, t = lane % 4).
__device__ __forceinline__ void split_stage(const float* slot, float* bh, float* bl,
                                            uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
  for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
    const int e = (threadIdx.x + i * kThreads) * 4;
    const float4 v = *reinterpret_cast<const float4*>(slot + kPartFloats + e);
    uint4 h, l;
    reid::split_tf32(v.x, h.x, l.x);
    reid::split_tf32(v.y, h.y, l.y);
    reid::split_tf32(v.z, h.z, l.z);
    reid::split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(bh + e) = h;
    *reinterpret_cast<uint4*>(bl + e) = l;
  }
  const int warp = threadIdx.x / reid::kWarp, lane = threadIdx.x % reid::kWarp;
  const float* a = slot + (2 * warp * 8) * (kCoreBytes / 4) + (lane / 4) * 4 + lane % 4;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // i = 0..3: (row group, column group) offsets (0, 0), (1, 0), (0, 1), (1, 1)
      const int core = (i % 2) * 8 + 2 * s + i / 2;
      reid::split_tf32(a[core * (kCoreBytes / 4)], ah[s][i], al[s][i]);
    }
}

// tot (this warpgroup's 64 x 128 share of the tile) = A . B^T over all of
// dim, A the 128 rows from a0, B those from b0, in fp32 at 3xTF32 accuracy:
// per k = 8 step three wgmma add lo.hi, hi.lo, hi.hi (the small terms
// first), A's parts from registers, B's from shared memory (A from shared
// memory too would double the tensor cores' shared-memory reads, which at
// tf32 are then near the SM's 128 bytes a cycle). The raw tiles arrive
// through a ring of kRing slots; while the tensor cores run stage j, the
// threads split stage j + 1 into the other set of parts (B's buffer, A's
// registers) and start the copy of stage j + 2. Each chunk of kChunkStages
// stages starts its accumulator afresh and ends by adding it to tot; nothing
// else touches the accumulator while a product runs.
__device__ __forceinline__ void tile_product(float (&tot)[64], float* smem,
                                             const float* __restrict__ x, int n, int dim,
                                             int a0, int b0) {
  float* ring = smem;
  float* parts = ring + kRingFloats;   // (B hi, B lo) x 2 buffers
  const int stages = ceil_div(dim, kBK);
  // descriptors in 16-byte units from the parts' base: a part is kPartFloats
  // / 4 units; a k = 8 step is two core matrices
  constexpr int kPart16 = kPartFloats / 4, kCore16 = kCoreBytes / 16;
  const uint64_t parts_desc = reid::smem_desc(parts, kCoreBytes, 8 * kCoreBytes);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    tot[i] = 0.0f;
  }
  uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) {
    if (j < stages) load_stage(ring + j * 2 * kPartFloats, x, n, dim, a0, b0, j);
    reid::cp_async_commit();
  }
  reid::cp_async_wait<kRing - 2>();
  __syncthreads();   // stage 0 has landed for all
  split_stage(ring, parts, parts + kPartFloats, ah[0], al[0]);
  reid::fence_proxy_async();
  __syncthreads();
  // stage j: the products on its parts, then stage j + 1's split
  auto stage = [&](int j, auto parity) {
    constexpr int p = decltype(parity)::value;
    const uint64_t bh_desc = parts_desc + p * 2 * kPart16;
    reid::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t bh = bh_desc + 2 * s * kCore16, bl = bh + kPart16;
      reid::wgmma_tf32(acc, al[p][s], bh);
      reid::wgmma_tf32(acc, ah[p][s], bl);
      reid::wgmma_tf32(acc, ah[p][s], bh);
    }
    reid::wgmma_commit();
    if (j + 1 < stages) {
      reid::cp_async_wait<kRing - 3>();   // stage j + 1 has landed for this thread,
      reid::wgmma_wait<1>();              // this warpgroup's stage j - 1 is done
      reid::pin(ah[1 - p]);               // (its A registers stay live until here),
      reid::pin(al[1 - p]);
      __syncthreads();                    // and both for all: parts (1 - p) are free
      if (j + kRing - 1 < stages)
        load_stage(ring + ((j + kRing - 1) % kRing) * 2 * kPartFloats, x, n, dim, a0, b0,
                   j + kRing - 1);
      reid::cp_async_commit();
      float* next = parts + (1 - p) * 2 * kPartFloats;
      split_stage(ring + ((j + 1) % kRing) * 2 * kPartFloats, next, next + kPartFloats,
                  ah[1 - p], al[1 - p]);
      reid::fence_proxy_async();
      __syncthreads();                    // stage j + 1's parts visible to the tensor cores
    }
  };
  for (int c = 0; c < stages; c += kChunkStages) {
    const int c_end = min(stages, c + kChunkStages);
    reid::pin(acc);
    for (int j = c; j < c_end; j += 2) {   // c is even: stage j's parts are set j % 2
      stage(j, std::integral_constant<int, 0>());
      if (j + 1 < c_end) stage(j + 1, std::integral_constant<int, 1>());
    }
    reid::wgmma_wait<0>();
    reid::pin(acc);
    reid::pin(ah[0]);
    reid::pin(al[0]);
    reid::pin(ah[1]);
    reid::pin(al[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      tot[i] += acc[i];
      acc[i] = 0.0f;
    }
  }
  __syncthreads();   // every warpgroup is done with the ring: the key tile may reuse it
}

"""


def overlap(src):
    a = src.index("// shared memory: the ring of raw A and B tiles")
    b = src.index("__host__ __device__ constexpr int ceil_div")
    src = src[:a] + OVERLAP_CONSTANTS + src[b:]
    a = src.index("// Splits one stage's raw B tile")
    b = src.index("// Filters the key tile's 128 candidates")
    src = src[:a] + OVERLAP_PRODUCT + src[b:]
    src = _sub(src, "float* lkey = smem + kRingFloats + 2 * kPartFloats;",
               "float* lkey = smem + kRingFloats + 4 * kPartFloats;")
    return _sub(src, '#include <stdint.h>\n', '#include <stdint.h>\n\n#include <type_traits>\n')


VARIANTS = {"both_triangles": both_triangles, "chunk32": _chunk(1), "chunk64": _chunk(2),
            "chunk256": _chunk(8), "chunk2048": _chunk(64), "ring2": ring2,
            "lists_in_scratch": lists_in_scratch, "stage64": stage64, "overlap": overlap}


def phases(src):
    """The kernel with clock64 counters summed into a device array (read by
    reid_knn_clock): a block's product phases and step phases."""
    src = _sub(src, "namespace {\n\nusing reid::kCoreBytes;",
               "__device__ unsigned long long g_clk[8];\nnamespace {\n\nusing reid::kCoreBytes;")
    src = _sub(src, "  for (int j = 0; j < stages; ++j) {\n    reid::cp_async_wait<kStages - 2>();\n"
               "    __syncthreads();   // stage j has landed for all; slot (j - 1) % kStages is free\n",
               "  long long c_wait = 0, c_split = 0, c_mma = 0, c0;\n"
               "  for (int j = 0; j < stages; ++j) {\n    c0 = clock64();\n"
               "    reid::cp_async_wait<kStages - 2>();\n"
               "    __syncthreads();   // stage j has landed for all; slot (j - 1) % kStages is free\n"
               "    c_wait += clock64() - c0;\n    c0 = clock64();\n")
    src = _sub(src, "    reid::pin(acc);\n    reid::wgmma_fence();\n",
               "    c_split += clock64() - c0;\n    c0 = clock64();\n"
               "    reid::pin(acc);\n    reid::wgmma_fence();\n")
    src = _sub(src, "    reid::pin(ah);\n    reid::pin(al);\n",
               "    reid::pin(ah);\n    reid::pin(al);\n    c_mma += clock64() - c0;\n")
    src = _sub(src, "  __syncthreads();   // every warp is done with the ring: the key tile may reuse it\n}",
               "  __syncthreads();   // every warp is done with the ring: the key tile may reuse it\n"
               "  if (threadIdx.x == 0) {\n    atomicAdd(&g_clk[0], (unsigned long long)c_wait);\n"
               "    atomicAdd(&g_clk[1], (unsigned long long)c_split);\n"
               "    atomicAdd(&g_clk[2], (unsigned long long)c_mma);\n  }\n}")
    src = _sub(src, "  const int rows = min(kTile, n - q0);\n",
               "  const int rows = min(kTile, n - q0);\n"
               "  const long long s0 = clock64();\n  long long s1 = s0, s2 = s0, s3 = s0;\n")
    src = _sub(src, "  if (dist >= 0) {\n    const int J = (I + dist) % T, g0 = J * kTile;",
               "  s1 = clock64();\n  if (dist >= 0) {\n    const int J = (I + dist) % T, g0 = J * kTile;")
    src = _sub(src, "    tile_product(tot, smem, x, n, dim, q0, g0);   // its barriers publish qn, gn\n",
               "    tile_product(tot, smem, x, n, dim, q0, g0);   // its barriers publish qn, gn\n"
               "    s2 = clock64();\n")
    src = _sub(src, "    if (emit) {   // rows of J x candidates of I",
               "    s3 = clock64();\n    if (emit) {   // rows of J x candidates of I")
    src = _sub(src, "      part_idx[static_cast<size_t>(q0) * k + e] = lidx[r * kSharedK + s];\n    }\n  }\n}",
               "      part_idx[static_cast<size_t>(q0) * k + e] = lidx[r * kSharedK + s];\n    }\n  }\n"
               "  if (threadIdx.x == 0) {\n    const long long s4 = clock64();\n"
               "    atomicAdd(&g_clk[3], (unsigned long long)(s1 - s0));\n"
               "    atomicAdd(&g_clk[4], (unsigned long long)(s2 - s1));\n"
               "    atomicAdd(&g_clk[5], (unsigned long long)(s3 - s2));\n"
               "    atomicAdd(&g_clk[6], (unsigned long long)(s4 - s3));\n"
               "    atomicAdd(&g_clk[7], 1ull);\n  }\n}")
    return src + ('\nextern "C" int reid_knn_clock(unsigned long long* out, int reset) {\n'
                  '  if (reset) {\n    const unsigned long long z[8] = {};\n'
                  '    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof z);\n  }\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_clk, 8 * sizeof(unsigned long long));\n}\n')


def report_phases(lib, feats, shapes):
    lib.reid_knn_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * 8)()
    for n, k, l2 in shapes:
        run(lib, feats[n], k, l2)
        torch.cuda.synchronize()
        lib.reid_knn_clock(out, 1)
        run(lib, feats[n], k, l2)
        torch.cuda.synchronize()
        lib.reid_knn_clock(out, 0)
        c = [v / out[7] for v in list(out)[:7]]
        print(f"[phases] N {n} {'l2' if l2 else 'ip'} k {k}: cycles a block-step: lists and "
              f"mailbox {c[3]:.0f}, product {c[4]:.0f} (stage waits {c[0]:.0f}, splits and "
              f"barriers {c[1]:.0f}, tensor cores {c[2]:.0f}), keys and selection {c[5]:.0f}, "
              f"emission and lists back {c[6]:.0f}; {out[7]} block-steps")


def build(name, text):
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
        return name, None, []
    regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in (p.stdout + p.stderr).splitlines()
                   if "Used " in ln and "registers" in ln})
    lib = ctypes.CDLL(so)
    lib.reid_knn_topk.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
    lib.reid_knn_topk_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.reid_knn_topk_scratch.restype = ctypes.c_longlong
    return name, lib, regs


def run(lib, f, k, l2):
    n, d = f.shape
    size = lib.reid_knn_topk_scratch(n, k)
    norms = torch.empty(n, device="cuda")
    pk = torch.empty(size, device="cuda")
    pi = torch.empty(size, dtype=torch.int32, device="cuda")
    vals = torch.empty((n, k), device="cuda")
    idx = torch.empty((n, k), dtype=torch.int32, device="cuda")
    rc = lib.reid_knn_topk(f.data_ptr(), n, d, k, l2, norms.data_ptr(), pk.data_ptr(),
                           pi.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"reid_knn_topk: CUDA error {rc}")
    return vals, idx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--big", action="store_true", help="also N 32,621 (MSMT17's train set)")
    ap.add_argument("--phases", action="store_true",
                    help="the kernel's block-step cycles by phase (clock64)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_knn_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from reid_gan_torch.ops.distance import knn_search_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    with open(osp.join(CSRC, "knn_topk.cu")) as fh:
        src = fh.read()
    texts = {"kernel": src}
    texts.update({v: VARIANTS[v](src) for v in args.variants.split(",") if v})
    if args.phases:
        texts["phases"] = phases(src)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(*kv), texts.items()))
    libs = {name: lib for name, lib, _ in built if lib is not None}
    clocked = libs.pop("phases", None)
    for name, lib, regs in built:
        if lib is not None:
            print(f"[build] {name}: registers {', '.join(regs)}")
    g = torch.Generator(device="cuda").manual_seed(8)
    shapes = [(12936, 30, 1), (12936, 128, 1), (12936, 15, 0)]
    if args.big:
        shapes.append((32621, 30, 1))
    feats = {n: cs._train_features(g, n) for n in sorted({s[0] for s in shapes})}
    if clocked is not None:
        report_phases(clocked, feats, shapes)
        print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for n, k, l2 in shapes:
        f, metric = feats[n], "l2" if l2 else "ip"
        ref = run(libs["kernel"], f, k, l2)
        pv, pi = knn_search_plain(f, k, metric)
        err = float(np.abs(ref[0].cpu().numpy() - pv).max())
        print(f"[probe] N {n} {metric} k {k}: the kernel's max_abs_err against the plain kNN "
              f"{err:.3g}")
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cs.device_ms(lambda: run(libs[name], f, k, l2), reps=5))
        for name in libs:
            v, i = run(libs[name], f, k, l2)
            torch.cuda.synchronize()
            same = bool(torch.equal(v.view(torch.int32), ref[0].view(torch.int32))
                        and torch.equal(i, ref[1]))
            verr = float(np.abs(v.cpu().numpy() - pv).max())
            swaps = int((i.cpu().numpy() != pi).sum())
            print(f"[probe] N {n} {metric} k {k} {name}: ms {times[name][0]:.4f}, "
                  f"{times[name][1]:.4f}; max_abs_err {verr:.3g}, {swaps} entries off the "
                  f"plain order; the kernel's bits: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
