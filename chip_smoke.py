"""On-card smoke run of the PyTorch/CUDA port (``reid_gan_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each ended by ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without printing a result:

1. the card's name and power limit (``nvidia-smi``) and the kernel build
   (``nvcc`` for sm_90a from ``reid_gan_torch/csrc``; ptxas report);
2. every kernel of the eval path against its plain PyTorch version at the
   slice's shapes: K1 ``eval_transform`` and K2 ``gem_bn_l2n`` at batch 256
   of 256x128, K3 ``rank_stats`` at Market-1501's eval shape (3,368 queries
   x 15,913 gallery, 751 ids, 6 cameras, 2048-d features from a seed), once
   more with duplicated gallery rows for exact ties; max error, tolerance,
   the kernel's and the plain version's device time, and the bound;
3. the main path: ``Evaluator(FeatureExtractor(resnet50)).evaluate`` (the
   call ``cli/test.py`` makes) on an in-memory uint8 eval set made with numpy
   from a seed (1,024 queries + 3,072 gallery, 256x128, batch 256; random
   ResNet-50 with GeM and last stride 1). Launch counts are zeroed just
   before and read just after; every kernel must have launched. Then a warm
   extraction pass is timed, another is traced with ``torch.profiler``
   (device time by kernel, idle share), one batch of features is held
   against the same model through the plain versions, and the rank metrics
   against the plain rank pass;
4. a JSON line with every kernel's launches, error, times and bound;
5. the last line: ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores


def device_ms(fn, reps=10, lead_cycles=20_000_000):
    """Device time of ``fn`` per call, from CUDA events around each call.
    A sleep kernel ahead of each call keeps the card busy while the host
    enqueues, so host launch overhead stays out of the measurement."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from reid_gan_torch import kernels

    lib = kernels.load_library()
    print(f"[build] {lib.path} in {lib.seconds:.1f} s")
    for line in lib.log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"[ptxas] {line.strip()}")


def check_k1(report):
    from reid_gan_torch.ops.transforms import eval_transform, eval_transform_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (256, 256, 128, 3), dtype=torch.uint8,
                       device="cuda", generator=g)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -6)):
        out = eval_transform(u8, 256, 128, dtype)
        ref = eval_transform_plain(u8, dtype)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.stride() == ref.stride(),
              "K1 layout differs from the plain version")
        errs[dtype] = float((out.float() - ref.float()).abs().max())
        # fp32: both divide in fp32 (torch's CUDA scalar division may
        # multiply by the reciprocal: 1 ulp). bf16: one bf16 step at |x| < 4
        # where an fp32 ulp crosses a rounding boundary.
        print(f"[K1] eval_transform {dtype}: max_abs_err {errs[dtype]:.3g} "
              f"(tol {tol:.3g})")
        check(errs[dtype] <= tol, f"K1 {dtype} error {errs[dtype]} > {tol}")
    ms = device_ms(lambda: eval_transform(u8, 256, 128, torch.bfloat16))
    plain = device_ms(lambda: eval_transform_plain(u8, torch.bfloat16))
    b, by = bound_ms(u8.numel() * (1 + 2), 3 * u8.numel())
    print(f"[K1] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by})")
    report["eval_transform"] = dict(max_abs_err=errs[torch.bfloat16], ms=ms,
                                    plain_ms=plain, bound_ms=b, bound_by=by)


def check_k2(report):
    from reid_gan_torch.models.pooling import gem_bn_l2n, gem_bn_l2n_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    n, c, h, w = 256, 2048, 16, 8
    fmap = torch.rand((n, c, h, w), device="cuda", generator=g) * 2.0
    fmap = torch.relu(fmap - 0.3).contiguous(memory_format=torch.channels_last)
    p = torch.tensor([3.0], device="cuda")
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    mean = torch.rand(c, device="cuda", generator=g) * 0.2
    var = torch.rand(c, device="cuda", generator=g) + 0.5
    out = gem_bn_l2n(fmap, p, gamma, mean, var)
    ref = gem_bn_l2n_plain(fmap, p, gamma, mean, var)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-5   # unit vectors; powf vs torch.pow and the sum order
    print(f"[K2] gem_bn_l2n: max_abs_err {err:.3g} (tol {tol:.3g})")
    check(err <= tol, f"K2 error {err} > {tol}")
    ms = device_ms(lambda: gem_bn_l2n(fmap, p, gamma, mean, var))
    plain = device_ms(lambda: gem_bn_l2n_plain(fmap, p, gamma, mean, var))
    b, by = bound_ms(4 * (fmap.numel() + 3 * c + 1 + n * c), 3 * fmap.numel())
    print(f"[K2] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by})")
    report["gem_bn_l2n"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=b, bound_by=by)


def _market_block(g, ties):
    """Market-1501 eval shape from a seed: 751 ids, 6 cameras, identity
    centroids plus noise, L2-normalised 2048-d features. The noise puts the
    block's mAP near one half, so matches land at every rank and each AP is
    a sum of unequal precision terms."""
    m, n, ids, cams, dim = 3368, 15913, 751, 6, 2048
    centers = torch.randn((ids, dim), device="cuda", generator=g)
    qid = torch.randint(0, ids, (m,), device="cuda", generator=g, dtype=torch.int32)
    gid = torch.randint(0, ids, (n,), device="cuda", generator=g, dtype=torch.int32)
    qcam = torch.randint(0, cams, (m,), device="cuda", generator=g, dtype=torch.int32)
    gcam = torch.randint(0, cams, (n,), device="cuda", generator=g, dtype=torch.int32)
    qf = centers[qid.long()] + 3.5 * torch.randn((m, dim), device="cuda", generator=g)
    gf = centers[gid.long()] + 3.5 * torch.randn((n, dim), device="cuda", generator=g)
    if ties:   # every odd gallery row duplicates the even row before it
        gf[1::2], gid[1::2], gcam[1::2] = gf[0::2][:n // 2], gid[0::2][:n // 2], \
            gcam[0::2][:n // 2]
    qf = torch.nn.functional.normalize(qf, dim=1)
    gf = torch.nn.functional.normalize(gf, dim=1)
    return qf, gf, qid, qcam, gid, gcam


def check_k3(report):
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain
    from reid_gan_torch.ops.distance import squared_euclidean

    g = torch.Generator(device="cuda").manual_seed(3)
    chunk = 1024
    tol = 1e-5   # fp32 AP sums (plain) against double sums (kernel)
    worst = 0.0
    for ties in (False, True):
        qf, gf, qid, qcam, gid, gcam = _market_block(g, ties)
        m, n = qf.shape[0], gf.shape[0]
        err, n_tied, first, ap_sum, n_valid = 0.0, 0, None, 0.0, 0
        for s in range(0, m, chunk):
            e = min(s + chunk, m)
            pad = chunk - (e - s)     # rank_metrics_features' sentinel padding
            q = torch.nn.functional.pad(qf[s:e], (0, 0, 0, pad))
            sent = torch.full((pad,), torch.iinfo(torch.int32).min,
                              dtype=torch.int32, device="cuda")
            qi, qc = torch.cat([qid[s:e], sent]), torch.cat([qcam[s:e], sent])
            d = squared_euclidean(q, gf)
            if ties:   # exact ties whatever the product's summation order
                d[:, 1::2] = d[:, 0::2][:, :n // 2]
                n_tied += int((d[:, 1::2] == d[:, 0::2][:, :n // 2]).sum())
            ap, fb, nm = rank_stats(d, qi, qc, gid, gcam)
            ap_r, fb_r, nm_r = rank_stats_plain(d, qi, qc, gid, gcam)
            torch.cuda.synchronize()
            check(torch.equal(nm, nm_r), "K3 match counts differ")
            check(torch.equal(fb, fb_r), "K3 first-match bins differ")
            err = max(err, float((ap - ap_r).abs().max()))
            ap_sum += float(ap_r[nm_r > 0].double().sum())
            n_valid += int((nm_r > 0).sum())
            first = first or (d, qi, qc, gid, gcam)
        label = "exact ties" if ties else "distinct"
        print(f"[K3] rank_stats {m}x{n} ({label}, {n_tied} tied pairs, "
              f"mAP {ap_sum / n_valid:.4f}): bins and counts equal, "
              f"AP max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"K3 AP error {err} > {tol}")
        check(not ties or n_tied > 0, "K3 tie case has no ties")
        worst = max(worst, err)
        if not ties:
            timed = first
    d = timed[0]
    ms = device_ms(lambda: rank_stats(*timed))
    plain = device_ms(lambda: rank_stats_plain(*timed), reps=3)
    q_, n_ = d.shape
    b, by = bound_ms(4 * (q_ * n_ + 2 * q_ + 2 * n_ + 3 * q_), 2 * q_ * n_)
    print(f"[K3] per {q_}-query chunk of the distinct case: ms {ms:.4f} "
          f"plain_ms {plain:.4f} bound_ms {b:.4f} ({by})")
    report["rank_stats"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                                bound_ms=b, bound_by=by)


def _eval_set(seed=0, n_ids=256, n_query=1024, n_gallery=3072, h=256, w=128,
              batch=256):
    """In-memory uint8 eval set: per-identity base colour plus noise, ids
    spread evenly over query and gallery, 6 cameras."""
    rng = np.random.default_rng(seed)
    n = n_query + n_gallery
    pids = np.arange(n) % n_ids
    cams = rng.integers(0, 6, n)
    base = rng.integers(0, 256, (n_ids, 3)).astype(np.int16)
    imgs = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        noise = rng.integers(-40, 40, (e - s, h, w, 3), dtype=np.int16)
        imgs[s:e] = np.clip(base[pids[s:e]][:, None, None] + noise, 0, 255)
    fnames = [f"{pids[i]:04d}_c{cams[i] + 1}_{i:06d}.jpg" for i in range(n)]
    items = [(fnames[i], int(pids[i]), int(cams[i])) for i in range(n)]
    batches = [{"img": imgs[s:s + batch], "fname": fnames[s:s + batch],
                "pid": pids[s:s + batch]} for s in range(0, n, batch)]
    return batches, items[:n_query], items[n_query:]


def _plain_rank_metrics(x, y, query, gallery, topk=100):
    """The main path's rank metrics through the plain rank pass."""
    from reid_gan_torch.engine.metrics import rank_stats_plain
    from reid_gan_torch.ops.distance import squared_euclidean

    ids = lambda items, k: torch.tensor([it[k] for it in items],  # noqa: E731
                                        dtype=torch.int32, device="cuda")
    d = squared_euclidean(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    ap, fb, nm = rank_stats_plain(d, ids(query, 1), ids(query, 2),
                                  ids(gallery, 1), ids(gallery, 2))
    has = nm > 0
    hist = torch.bincount(fb[has & (fb < topk)].long(), minlength=topk).double()
    valid = int(has.sum())
    return hist.cpu().numpy().cumsum() / valid, float(ap[has].double().sum()) / valid


# Device work by kind, matched on kernel names in this order
PROFILE_GROUPS = (
    ("K1 eval_transform", ("eval_transform_kernel",)),
    ("K2 gem_bn_l2n", ("gem_bn_l2n_kernel",)),
    ("batchnorm", ("bn_fw",)),
    ("host-to-device copy", ("Memcpy HtoD",)),
    ("convolution", ("xmma", "gemm", "conv", "implicit")),
    ("elementwise (ReLU, add, casts)", ("elementwise_kernel",)),
)


def profile_extraction(extractor, batches):
    """One more extraction pass under ``torch.profiler``: device time by
    kernel and the share of the window (first device event to last) in
    which the card ran nothing."""
    from torch.profiler import ProfilerActivity, profile

    from reid_gan_torch.engine.evaluators import extract_features

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        extract_features(extractor, batches)
        torch.cuda.synchronize()
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA))
    if not dev:
        print("[profile] the profiler saw no device events: breakdown not measured")
        return
    busy, reach, by_name = 0.0, dev[0][0], {}
    for start, end, name in dev:
        busy += max(0.0, end - max(start, reach))   # union of the intervals
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    span = reach - dev[0][0]
    print(f"[profile] extraction: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms window, idle share {1 - busy / span:.4f}")
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {group}: {us / busy:.2%} ({us / 1e3:.3f} ms)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] {us / busy:7.2%} {us / 1e3:9.3f} ms  {name[:110]}")


def phase_main_path(counts):
    from reid_gan_torch import kernels
    from reid_gan_torch.engine.evaluators import (
        Evaluator,
        FeatureExtractor,
        extract_features,
    )
    from reid_gan_torch.engine.metrics import rank_metrics_features
    from reid_gan_torch.models import create
    from reid_gan_torch.models.pooling import gem_bn_l2n_plain
    from reid_gan_torch.models.resnet import ResNetBackbone
    from reid_gan_torch.ops.transforms import eval_transform_plain

    torch.backends.cudnn.allow_tf32 = True   # as cli/test.py sets it
    batches, query, gallery = _eval_set()
    torch.manual_seed(0)
    model = create("resnet50")               # GeM, last stride 1, fp32
    extractor = FeatureExtractor(model, height=256, width=128, batch_size=256,
                                 device="cuda")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, mAP = Evaluator(extractor).evaluate(batches, query, gallery,
                                                cmc_flag=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update(kernels.launch_counts())
    n_img = len(query) + len(gallery)
    print(f"[main] Evaluator.evaluate on {n_img} images (1st run, cuDNN cold): "
          f"{wall:.2f} s; mAP {mAP:.4f} top-1 {scores[0]:.4f} "
          f"top-5 {scores[4]:.4f} top-10 {scores[9]:.4f}")
    print(f"[main] launches: {counts}")
    check(all(v > 0 for v in counts.values()), f"a kernel did not launch: {counts}")
    check(0.0 <= mAP <= 1.0 and np.all(np.diff(scores) >= 0), "bad metrics")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    features, _ = extract_features(extractor, batches)
    torch.cuda.synchronize()
    ext = time.perf_counter() - t0
    print(f"[main] extraction (warm): {n_img / ext:.1f} img/s")
    profile_extraction(extractor, batches)
    x = np.stack([features[f] for f, _, _ in query])
    y = np.stack([features[f] for f, _, _ in gallery])
    norms = np.linalg.norm(np.concatenate([x, y]), axis=1)
    check(x.shape == (len(query), 2048) and np.all(np.isfinite(x))
          and np.all(np.isfinite(y)) and np.all(np.abs(norms - 1) < 1e-4),
          "features are not finite unit vectors of width 2048")

    # one batch through the plain versions of K1 and K2 on the card
    img = torch.from_numpy(batches[0]["img"]).cuda()
    with torch.inference_mode():
        xin = eval_transform_plain(img, torch.bfloat16).float()
        fmap = ResNetBackbone.forward(extractor.model, xin)
        bn = extractor.model.feat_bn
        ref = gem_bn_l2n_plain(fmap, extractor.model.gap.p, bn.weight,
                               bn.running_mean, bn.running_var)
    got = torch.from_numpy(np.stack([features[f] for f in batches[0]["fname"]])).cuda()
    err = float((got - ref).abs().max())
    tol = 1e-4   # K2's sum order; a pixel where K1's bf16 rounding differs
    print(f"[main] batch 0 features vs plain K1/K2 path: max_abs_err {err:.3g} "
          f"(tol {tol:.3g})")
    check(err <= tol, f"main-path features differ from the plain path: {err}")

    cmc_k, map_k = rank_metrics_features(
        x, y, [p for _, p, _ in query], [p for _, p, _ in gallery],
        [c for _, _, c in query], [c for _, _, c in gallery], device="cuda")
    cmc_p, map_p = _plain_rank_metrics(x, y, query, gallery)
    print(f"[main] rank metrics kernel vs plain: mAP {map_k:.6f} vs {map_p:.6f}, "
          f"top-1 {cmc_k[0]:.6f} vs {cmc_p[0]:.6f}")
    check(np.array_equal(cmc_k, cmc_p) and abs(map_k - map_p) <= 1e-6,
          "rank metrics differ from the plain rank pass")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from reid_gan_torch import kernels

    t_start = time.perf_counter()
    phase_device()
    report = {}
    check_k1(report)
    check_k2(report)
    check_k3(report)
    torch.cuda.synchronize()
    counts = {}
    phase_main_path(counts)
    torch.cuda.synchronize()
    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         **report[k.name], "library_ms": None}
        for k in kernels.KERNELS]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
