"""Variants of K1 (``reid_gan_torch/csrc/eval_transform.cu``) and K12
(``reid_gan_torch/csrc/diff_transform.cu``) timed in turns on the card.

Each variant is the kernel's source with a small patch, built with ``nvcc``
into a library of its own under ``reid_gan_torch/build/transform_probe/``
and called through the same C entry as the kernel. For each shape the
script checks the kernel and every variant against the plain version, times
each twice in turns (A B .. B A) with CUDA events, and says whether each
writes the kernel's bits; it prints each build's SASS instruction count
(``cuobjdump``). Variants:

- K1 ``plain_stores``: the output written with plain stores instead of
  streaming ones (st.global.cs, evict first);
- K1 ``unroll4`` and ``unroll16``: 4 or 16 chunks (loads in flight) a lane
  a step instead of 8;
- K1 ``loads16``: chunks of 16 bytes (one 16-byte load a lane, its 16
  outputs 64 or 32 bytes a lane apart in the warp's stores) instead of 4;
- K1 ``groups48``: a thread takes three consecutive 16-byte chunks (a
  48-byte group: loads 48 bytes and stores 192 or 96 bytes a lane apart);
- K12 ``band1`` to ``band32``: that many output rows a block at every
  shape, where the kernel takes the most (up to 16) that still gives every
  SM two blocks (8 at the hard-mix step's 16 images: 512 blocks);
- K12 ``ieee_div``: the normalisation as an IEEE division instead of the
  corrected product (the same bits);
- K12 ``threads128`` and ``threads512``: 128 or 512 threads a block
  instead of 256.

``--phases`` builds K12 once more with ``clock64`` counters and bands of 8
rows, and prints, at 16 images (512 blocks) and at one (32 blocks), the
mean cycles of a block in its phases (the copy issued, the taps formed,
the copy's wait, the H pass, the W pass and its stores) and the global
timer from the first block's start to the last block's end.

Beside them, ``baseline`` times a one-element ``add_`` the same way: the
floor of the method (the launch and the events).

Shapes: K1 at (256, 256, 128, 3) uint8 to bf16 and to fp32; K12 at (16, 3,
128, 64) to 256x128.

Run on a machine with an H100:

    python scripts/torch_transform_probe.py [--phases]
"""

import argparse
import ctypes
import os
import os.path as osp
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = osp.join(ROOT, "reid_gan_torch", "csrc")
BUILD = osp.join(ROOT, "reid_gan_torch", "build", "transform_probe")
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _sub(src, old, new):
    if old not in src:
        raise ValueError(f"the kernel source has no {old[:60]!r}")
    return src.replace(old, new)


def plain_stores(src):
    return _sub(src, "constexpr bool kStream = true;", "constexpr bool kStream = false;")


def _set(**constants):
    """The named constexpr ints of the kernel set to other values."""
    def variant(src):
        for name, value in constants.items():
            src = re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
            if f"constexpr int {name} = {value};" not in src:
                raise ValueError(f"the kernel source has no constexpr int {name}")
        return src
    return variant


def _band(rows):
    def variant(src):
        return _sub(src, "geo.band = pick_band(N, OH, sms);", f"geo.band = {rows};")
    return variant


def ieee_div(src):
    """The normalisation as an IEEE division (the same bits)."""
    return _sub(src, "v[k] = reid::std_quotient(a[k], nm.std[k % 3], nm.inv[k % 3]);",
                "v[k] = __fdiv_rn(a[k], nm.std[k % 3]);")


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


def k12_phases(src):
    """clock64 of thread 0 of each block at its start, once it has issued
    the copy, once it has formed its taps, after the copy's wait and
    barrier, after the H pass's barrier and at its end, summed over blocks;
    the first block's start and the last block's end on the global timer."""
    src = _sub(src, "namespace {\n", CLOCK)
    src = _sub(src, "  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;\n",
               "  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;\n"
               "  const long long q0 = clock64();\n"
               "  if (threadIdx.x == 0) atomicMin(&g_clk[14], gtime());\n")
    src = _sub(src, "    reid::cp_async_commit();\n  }\n",
               "    reid::cp_async_commit();\n  }\n  const long long qa = clock64();\n")
    src = _sub(src, "  if (whole) {\n    reid::cp_async_wait<0>();",
               "  const long long q1 = clock64();\n  if (whole) {\n    reid::cp_async_wait<0>();")
    src = _sub(src, "  __syncthreads();\n\n  // H pass",
               "  __syncthreads();\n  const long long q2 = clock64();\n\n  // H pass")
    src = _sub(src, "  __syncthreads();\n\n  // W pass",
               "  __syncthreads();\n  const long long q3 = clock64();\n\n  // W pass")
    return _sub(src, "  }\n}\n\n// Output rows a block",
                "  }\n"
                "  if (threadIdx.x == 0) {\n    atomicAdd(&g_clk[0], qa - q0);\n"
                "    atomicAdd(&g_clk[4], q1 - qa);\n"
                "    atomicAdd(&g_clk[1], q2 - q1);\n    atomicAdd(&g_clk[2], q3 - q2);\n"
                "    atomicAdd(&g_clk[3], clock64() - q3);\n    atomicAdd(&g_clk[7], 1ull);\n"
                "    atomicMax(&g_clk[15], gtime());\n  }\n}\n\n// Output rows a block")


K1_VARIANTS = {"plain_stores": plain_stores, "unroll4": _set(kUnroll=4), "unroll16": _set(kUnroll=16),
               "loads8": _set(kVec=8), "loads16": _set(kVec=16),
               "groups48": _set(kVec=16, kUnroll=3, kLaneStep=3, kChunkStep=1)}
K12_VARIANTS = {**{f"band{b}": _band(b) for b in (1, 2, 4, 8, 16, 32)}, "ieee_div": ieee_div,
                "threads128": _set(kThreads=128), "threads512": _set(kThreads=512)}
SOURCES = {"eval_transform.cu": K1_VARIANTS, "diff_transform.cu": K12_VARIANTS}


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
    sass = subprocess.run([osp.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", so],
                          capture_output=True, text=True).stdout
    print(f"[build] {name}: {len(re.findall(r'^ +/[*][0-9a-f]{4}[*]/', sass, re.M))} SASS "
          "instructions")
    lib = ctypes.CDLL(so)
    if source == "eval_transform.cu":
        lib.reid_eval_transform.argtypes = [_P, _P, _L, _I] + [_F] * 6 + [_P]
    else:
        lib.reid_diff_transform.argtypes = [_P, _P] + [_I] * 5 + [_F] * 8 + [_P]
    if name.endswith("_phases"):
        lib.reid_probe_clock.argtypes = [_P, _I]
    return source, name, lib


def _rc(rc, symbol):
    if rc:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")


def k1_call(lib, u8, dtype):
    from reid_gan_torch.ops.transforms import IMAGENET_MEAN, IMAGENET_STD

    n, h, w, c = u8.shape
    out = torch.empty((n, c, h, w), dtype=dtype, device="cuda", memory_format=torch.channels_last)
    _rc(lib.reid_eval_transform(u8.data_ptr(), out.data_ptr(), u8.numel(),
                                int(dtype == torch.bfloat16), *IMAGENET_MEAN, *IMAGENET_STD,
                                torch.cuda.current_stream().cuda_stream), "reid_eval_transform")
    return out


def k12_call(lib, img, oh, ow):
    from reid_gan_torch.ops.transforms import IMAGENET_MEAN, IMAGENET_STD, _inv_scale

    n, c, h, w = img.shape
    out = torch.empty((n, c, oh, ow), device="cuda", memory_format=torch.channels_last)
    _rc(lib.reid_diff_transform(img.data_ptr(), out.data_ptr(), n, h, w, oh, ow,
                                _inv_scale(h, oh), _inv_scale(w, ow), *IMAGENET_MEAN,
                                *IMAGENET_STD, torch.cuda.current_stream().cuda_stream),
        "reid_diff_transform")
    return out


def _in_turns(libs, fn, ref, label):
    """Times fn(lib) for every library twice, in turns; prints each one's
    times, its error against ref and whether it writes the kernel's bits."""
    import chip_smoke as cs

    names = list(libs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cs.device_ms(lambda: fn(libs[name]), reps=10))
    first = None
    for name in names:
        out = fn(libs[name])
        torch.cuda.synchronize()
        bits = out.view(torch.int16 if out.dtype == torch.bfloat16 else torch.int32)
        first = bits if first is None else first
        err = float((out.float() - ref.float()).abs().max())
        print(f"[probe] {label} {name}: ms {times[name][0]:.4f}, {times[name][1]:.4f}; "
              f"max_abs_err {err:.3g}; the kernel's bits: {bool(torch.equal(bits, first))}")


def baseline():
    import chip_smoke as cs

    t = torch.zeros(1, device="cuda")
    ms = [cs.device_ms(lambda: t.add_(1.0), reps=10) for _ in range(2)]
    print(f"[probe] baseline, a one-element add_: ms {ms[0]:.4f}, {ms[1]:.4f}")


def probe_k1(libs):
    from reid_gan_torch.ops.transforms import eval_transform_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (256, 256, 128, 3), dtype=torch.uint8, device="cuda", generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        ref = eval_transform_plain(u8, dtype)
        _in_turns(libs, lambda lib: k1_call(lib, u8, dtype), ref, f"K1 {dtype}")


def probe_k12(libs):
    from reid_gan_torch.ops.transforms import diff_transform_plain

    g = torch.Generator(device="cuda").manual_seed(12)
    img = torch.tanh(2 * torch.randn((16, 3, 128, 64), device="cuda", generator=g))
    ref = diff_transform_plain(img, 256, 128)
    _in_turns(libs, lambda lib: k12_call(lib, img, 256, 128), ref, "K12 16 x 128x64 -> 256x128")


def report_phases(lib):
    """K12 with clock64 counters (``--phases``), bands of 8 rows: a block's
    phases in cycles and the kernel's span on the global timer, for the
    hard-mix step's 16 images (512 blocks) and for one image (32 blocks, at
    most one an SM)."""
    g = torch.Generator(device="cuda").manual_seed(12)
    for n in (16, 1):
        img = torch.tanh(2 * torch.randn((n, 3, 128, 64), device="cuda", generator=g))
        k12_call(lib, img, 256, 128)
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 16)()
        _rc(lib.reid_probe_clock(ctypes.cast(clk, ctypes.c_void_p), 1), "reid_probe_clock")
        k12_call(lib, img, 256, 128)
        torch.cuda.synchronize()
        _rc(lib.reid_probe_clock(ctypes.cast(clk, ctypes.c_void_p), 0), "reid_probe_clock")
        blocks = max(clk[7], 1)
        names = ((0, "copy issued"), (4, "taps formed"), (1, "copy's wait and barrier"),
                 (2, "H pass and barrier"), (3, "W pass and stores"))
        means = ", ".join(f"{name} {clk[i] / blocks:.0f}" for i, name in names)
        print(f"[phases] K12 N {n}: {means} cycles a block ({clk[7]} blocks); first block's "
              f"start to last block's end {(clk[15] - clk[14]) / 1e3:.2f} us")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true",
                    help="K12's block phases in cycles (clock64) and its span")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_transform_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    jobs = []
    for source, variants in SOURCES.items():
        with open(osp.join(CSRC, source)) as fh:
            src = fh.read()
        jobs.append((source, f"{source[:-3]}_kernel", src))
        jobs += [(source, f"{source[:-3]}_{v}", fn(src)) for v, fn in variants.items()]
        if args.phases and source == "diff_transform.cu":
            jobs.append((source, "diff_transform_phases", k12_phases(_band(8)(src))))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build(job[1], job[0], job[2]), jobs))
    libs = {source: {name: lib for s, name, lib in built
                     if s == source and lib is not None and not name.endswith("_phases")}
            for source in SOURCES}
    baseline()
    if args.phases:
        report_phases(next(lib for _, name, lib in built if name == "diff_transform_phases"))
    probe_k1(libs["eval_transform.cu"])
    probe_k12(libs["diff_transform.cu"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
