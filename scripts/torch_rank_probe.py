"""Variants of K3 (``reid_gan_torch/csrc/rank_stats.cu``) timed in turns on
the card.

Each variant is the kernel's source with a small patch, built with ``nvcc``
into a library of its own under ``reid_gan_torch/build/rank_probe/`` and
called through the same C entry as the kernel. For each shape the script
checks the kernel and every variant against the plain version (match
counts and first bins equal), times each twice in turns (A B .. B A) with
CUDA events, and says whether each gives the kernel's bits. Variants:

- ``rows8``: 8 query rows a block at first match instead of 4 (one
  block an SM instead of two); ``rows2``: 2 rows at first match, 4 for all
  shots (instead of 8);
- ``warps8``, ``warps32``: 8 or 32 warps a block instead of 16 (32 with 4
  rows for all shots);
- ``linear``: an entry is bucketed by counting the staged distances below
  it (one compare each) instead of by binary search;
- ``loads4``: 4-byte copies of the distances, a lane on every 32nd column,
  instead of 16-byte copies of 4 neighbouring columns;
- ``cap32``: 32 same-id entries staged a round instead of 64 (half the
  counters' shared memory; rows with more take rounds);

and, to split the time (their results are not K3's): ``nothing``, no scan
and no pass (the launch, the set-up, the writes); ``scan_only``, the
same-id scan alone; ``no_loads``, distances made in registers instead of
copied; ``no_search``, every bucket taken as the last one without reading the
staged distances; ``no_atomics``, the buckets found but not counted.

``--phases`` builds K3 once more with ``clock64`` counters and prints a
block's mean cycles in the same-id scan, the staging of the matches, the
count pass and the sums.

Beside them, ``baseline`` times a one-element ``add_`` the same way: the
floor of the method (the launch and the events).

Shapes: a 1,024-query chunk against Market-1501's gallery (15,913 images,
751 ids, 6 cameras) first-match, and all-shots (top 100) with the separate
camera set; a 1,024-query chunk against MSMT17's (82,161 images, 3,060
ids, 15 cameras) first-match; all from ``chip_smoke._market_block``.

Run on a machine with an H100:

    python scripts/torch_rank_probe.py [--phases]
"""

import argparse
import ctypes
import math
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
BUILD = osp.join(ROOT, "reid_gan_torch", "build", "rank_probe")
_P, _I = ctypes.c_void_p, ctypes.c_int


def _set(**constants):
    """The named constexpr ints of the kernel set to other values."""
    def variant(src):
        for name, value in constants.items():
            src = re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
            if f"constexpr int {name} = {value};" not in src:
                raise ValueError(f"the kernel source has no constexpr int {name}")
        return src
    return variant


def linear(src):
    old = "constexpr bool kLinearSearch = false;"
    if old not in src:
        raise ValueError(f"the kernel source has no {old!r}")
    return src.replace(old, "constexpr bool kLinearSearch = true;")


def _sub(*pairs):
    """Each (old, new) pair of text replaced, or a single pair as two args."""
    if len(pairs) == 2 and isinstance(pairs[0], str):
        pairs = (pairs,)

    def variant(src):
        for old, new in pairs:
            if old not in src:
                raise ValueError(f"the kernel source has no {old[:60]!r}")
            src = src.replace(old, new)
        return src
    return variant


CLOCK = r"""__device__ unsigned long long g_clk[8];

extern "C" int reid_probe_clock(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_clk, z, sizeof(z)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk)));
}

namespace {
"""


def phases(src):
    """clock64 of thread 0 of each block at its start, after the same-id
    scan, before and after the count pass (the last round's) and at its end,
    summed over blocks."""
    for old, new in (
            ("namespace {\n", CLOCK),
            ("  if (row0 >= a.q) return;\n",
             "  if (row0 >= a.q) return;\n  const long long q0 = clock64();\n"
             "  long long q2 = 0, q3 = 0;\n"),
            ("  int max_nc = 0;\n", "  const long long q1 = clock64();\n  int max_nc = 0;\n"),
            ("    // ---- 2. one pass over the rows", "    q2 = clock64();\n    // ---- 2. one pass over the rows"),
            ("    // ---- 3. prefix sums over the buckets",
             "    q3 = clock64();\n    // ---- 3. prefix sums over the buckets"),
            ("  if (row_warp && lane == 0) {\n    a.ap[row]",
             "  if (tid == 0) {\n    atomicAdd(&g_clk[0], q1 - q0);\n"
             "    atomicAdd(&g_clk[1], q2 - q1);\n    atomicAdd(&g_clk[2], q3 - q2);\n"
             "    atomicAdd(&g_clk[3], clock64() - q3);\n    atomicAdd(&g_clk[7], 1ull);\n  }\n"
             "  if (row_warp && lane == 0) {\n    a.ap[row]")):
        if old not in src:
            raise ValueError(f"the kernel source has no {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


VARIANTS = {"rows8": _set(kRowsFirst=8), "rows2": _set(kRowsFirst=2, kRowsAll=4),
            "warps8": _set(kWarps=8), "warps32": _set(kWarps=32, kRowsAll=4),
            "linear": linear, "loads4": _set(kVec=1), "cap32": _set(kCap=32),
            "nothing": _sub(("for (int s0 = warp; s0 < steps;", "for (int s0 = warp; s0 < 0;"),
                            ("const int rounds = (max_nc + kCap - 1) / kCap;", "const int rounds = 0;")),
            "scan_only": _sub("const int rounds = (max_nc + kCap - 1) / kCap;",
                              "const int rounds = 0;"),
            "no_loads": _sub(("reid::cp_async16(buf + k * kStep + 4 * lane, ok ? p + column(s, 0) : a.d, ok);",
                              "reid::cp_async16(buf + k * kStep + 4 * lane, a.d, false);"),
                             ("            x[k][e] = buf[k * kStep + (kVec == 4 ? 4 * lane + e : e * reid::kWarp + lane)];",
                              "            x[k][e] = 0.25f * k + 1e-3f * (s % 997) + e;")),
            "no_search": _sub("for (int h = v.pow2 >> 1; h > 0; h >>= 1) b += rs.sd[b + h - 1] < xe ? h : 0;",
                              "for (int h = v.pow2 >> 1; h > 0; h >>= 1) b += h;"),
            "no_atomics": _sub("red_add_if(cnt + reid::kWarp * b, match ? kMatch : 1u, on);",
                               "red_add_if(cnt, b, on && b == 1 << 30);")}


def build(name, text):
    os.makedirs(BUILD, exist_ok=True)
    cu = osp.join(BUILD, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = osp.join(BUILD, f"lib{name}.so")
    from torch.utils.cpp_extension import CUDA_HOME

    p = subprocess.run([osp.join(CUDA_HOME, "bin", "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared",
                        "-I", CSRC, cu, "-o", so],
                       capture_output=True, text=True)
    if p.returncode:
        print(f"[build] {name}: nvcc failed, left out\n{p.stdout}{p.stderr}")
        return name, None
    log = p.stdout + p.stderr
    regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
    spills = sorted(set(re.findall(r"(\d+ bytes spill stores, \d+ bytes spill loads)", log)))
    sass = subprocess.run([osp.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", so],
                          capture_output=True, text=True).stdout
    print(f"[build] {name}: registers {', '.join(regs)}; {'; '.join(spills)}; "
          f"{len(re.findall(r'^ +/[*][0-9a-f]{4}[*]/', sass, re.M))} SASS instructions")
    lib = ctypes.CDLL(so)
    lib.reid_rank_stats.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 4 + [_I, _P]
    if name == "phases":
        lib.reid_probe_clock.argtypes = [_P, _I]
    return name, lib


def call(lib, args, sep, topk):
    d, qid, qcam, gid, gcam = args
    q, n = d.shape
    ap = torch.empty(q, device="cuda")
    first = torch.empty(q, dtype=torch.int32, device="cuda")
    nm = torch.empty(q, dtype=torch.int32, device="cuda")
    hist = torch.empty((q, topk), device="cuda") if topk else None
    rc = lib.reid_rank_stats(d.data_ptr(), qid.data_ptr(), qcam.data_ptr(), gid.data_ptr(),
                             gcam.data_ptr(), q, n, int(sep), ap.data_ptr(), first.data_ptr(),
                             nm.data_ptr(), hist.data_ptr() if topk else None, topk,
                             torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"reid_rank_stats: CUDA error {rc}")
    return (ap, first, nm) + ((hist,) if topk else ())


def _in_turns(libs, args, sep, topk, label):
    """Times every library twice, in turns; prints each one's times, whether
    its counts and bins equal the plain version's and whether it gives the
    kernel's bits."""
    import chip_smoke as cs
    from reid_gan_torch.engine.metrics import rank_stats_plain

    ref = rank_stats_plain(*args, separate_camera_set=sep, allshots_topk=topk)
    names = list(libs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        try:
            times[name].append(cs.device_ms(lambda: call(libs[name], args, sep, topk), reps=10))
        except RuntimeError as exc:
            times[name].append(float("nan"))
            print(f"[probe] {label} {name}: {exc}")
    kernel = None
    for name in names:
        if math.isnan(times[name][0]):
            continue
        out = call(libs[name], args, sep, topk)
        torch.cuda.synchronize()
        kernel = kernel or out
        right = torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        err = max(float((a - b).abs().max()) for a, b in zip(out[::3], ref[::3]))
        bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(out, kernel))
        print(f"[probe] {label} {name}: ms {times[name][0]:.4f}, {times[name][1]:.4f}; counts "
              f"and bins equal plain: {right}; max_abs_err {err:.3g}; the kernel's bits: {bits}")


def baseline():
    import chip_smoke as cs

    t = torch.zeros(1, device="cuda")
    ms = [cs.device_ms(lambda: t.add_(1.0), reps=10) for _ in range(2)]
    print(f"[probe] baseline, a one-element add_: ms {ms[0]:.4f}, {ms[1]:.4f}")


def report_phases(lib, args, label):
    """The ``phases`` build: a block's mean cycles in the same-id scan, the
    matches' staging, the count pass and the sums, at first match."""
    call(lib, args, False, 0)
    torch.cuda.synchronize()
    clk = (ctypes.c_ulonglong * 8)()
    for reset in (1, None, 0):
        if reset is None:
            call(lib, args, False, 0)
            torch.cuda.synchronize()
            continue
        rc = lib.reid_probe_clock(ctypes.cast(clk, ctypes.c_void_p), reset)
        if rc:
            raise RuntimeError(f"reid_probe_clock: CUDA error {rc}")
    blocks = max(clk[7], 1)
    names = ("same-id scan", "staging", "count pass", "sums")
    print(f"[phases] {label}: " + ", ".join(f"{name} {clk[i] / blocks:.0f}"
                                             for i, name in enumerate(names))
          + f" cycles a block ({clk[7]} blocks)")


def chunk_args(g, **shape):
    import chip_smoke as cs
    from reid_gan_torch.ops.distance import squared_euclidean

    qf, gf, qid, qcam, gid, gcam = cs._market_block(g, False, **shape)
    return (squared_euclidean(qf[:1024], gf), qid[:1024].contiguous(),
            qcam[:1024].contiguous(), gid, gcam)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true",
                    help="a block's cycles by phase (clock64), at first match")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rank_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    with open(osp.join(CSRC, "rank_stats.cu")) as fh:
        src = fh.read()
    jobs = [("kernel", src)] + [(name, fn(src)) for name, fn in VARIANTS.items()]
    if args.phases:
        jobs.append(("phases", phases(src)))
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = {name: lib for name, lib in pool.map(lambda job: build(*job), jobs)
                if lib is not None}
    clock = libs.pop("phases", None)
    baseline()
    g = torch.Generator(device="cuda").manual_seed(12)
    market = chunk_args(g)
    if clock is not None:
        report_phases(clock, market, "Market 1024x15913")
    _in_turns(libs, market, False, 0, "Market 1024x15913 first match")
    _in_turns(libs, market, True, 100, "Market 1024x15913 all-shots + separate cameras")
    del market
    msmt = chunk_args(g, m=1024, n=82161, ids=3060, cams=15)
    if clock is not None:
        report_phases(clock, msmt, "MSMT17 1024x82161")
    _in_turns(libs, msmt, False, 0, "MSMT17 1024x82161 first match")
    return 0


if __name__ == "__main__":
    sys.exit(main())
