"""On-card smoke run of the PyTorch/CUDA port (``reid_gan_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each ended by ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without printing a result:

1. the card's name and power limit (``nvidia-smi``) and the kernel build
   (``nvcc`` for sm_90a from ``reid_gan_torch/csrc``, one process per
   source; ptxas report);
2. every kernel against its plain PyTorch version at the main paths'
   shapes, with max error, tolerance, the kernel's and the plain version's
   device time, and the bound: K1 ``eval_transform`` and K2 ``gem_bn_l2n``
   at batch 256 of 256x128; K3 ``rank_stats`` at Market-1501's eval shape
   (3,368 queries x 15,913 gallery, 751 ids, 6 cameras, 2048-d), once more
   with exact ties; K4 ``train_augment`` at 256 x 256x128; K5 ``gem_pool``
   forward and backward (d map and dp) at (256, 2048, 16, 8); K6
   ``infonce`` forward and backward at B 256 x D 2048 against banks of 768
   rows (700 live) and 30,720 rows (30,000 live); K7 ``bank_fold``, plain
   and hard, on a 16 x 16 P×K batch;
3. the eval main path: ``Evaluator(FeatureExtractor(resnet50)).evaluate``
   (the call ``cli/test.py`` makes) on an in-memory uint8 eval set made with
   numpy from a seed (1,024 queries + 3,072 gallery, 256x128, batch 256;
   random ResNet-50 with GeM and last stride 1). Launch counts are zeroed
   just before and read just after; K1-K3 must have launched. Then a warm
   extraction pass is timed, another is traced with ``torch.profiler``
   (device time by kernel, idle share), one batch of features is held
   against the same model through the plain versions, and the rank metrics
   against the plain rank pass;
4. the train main path: ``ClusterContrastTrainer(resnet50).train`` for 20
   steps of batch 256 (16 ids x 16 instances, 256x128) drawn by the P×K
   sampler from an in-memory pseudo-labelled set of 700 ids x 18 images,
   against a bank of 700 unit rows padded to 768. Launch counts are zeroed
   just before and read just after; K4-K7, and K5's and K6's backward, must
   have launched once per step. The loss must be finite, every parameter
   must have moved and the bank's rows must be unit vectors. One more step
   is held against the same step composed from the plain versions (loss,
   the ``feat`` gradient, the folded bank); then 10 warm steps are timed
   and 3 more traced with ``torch.profiler``;
5. a JSON line with every kernel's launches, error, times and bound;
6. the last line: ``{"ok": true, "device": {...}}``.
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


def check_k4(report):
    from reid_gan_torch.ops.transforms import (
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(4)
    n, h, w = 256, 256, 128
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device="cuda",
                       generator=g)
    params = sample_augment_params(n, h, w, g)
    out = train_augment(u8, params, h, w)
    ref = train_augment_plain(u8, params)
    torch.cuda.synchronize()
    check(out.stride() == ref.stride(), "K4 layout differs from the plain version")
    err = float((out - ref).abs().max())
    tol = 1e-5   # the same fp32 arithmetic; the erase fill sums in another order
    print(f"[K4] train_augment: max_abs_err {err:.3g} (tol {tol:.3g}); "
          f"{int(params[:, 0].sum())} flips, {int(params[:, 5].sum())} erases")
    check(err <= tol, f"K4 error {err} > {tol}")
    ms = device_ms(lambda: train_augment(u8, params, h, w))
    plain = device_ms(lambda: train_augment_plain(u8, params))
    b, by = bound_ms(u8.numel() * (1 + 4) + params.numel() * 4, 20 * u8.numel())
    print(f"[K4] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by})")
    report["train_augment"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                   bound_ms=b, bound_by=by)


def check_k5(report):
    from reid_gan_torch.models.pooling import gem_pool, gem_pool_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    n, c, h, w = 256, 2048, 16, 8
    fmap = torch.relu(torch.rand((n, c, h, w), device="cuda", generator=g) * 2 - 0.6)
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    gout = torch.randn((n, c), device="cuda", generator=g) / n

    def run(fn):
        x = fmap.detach().requires_grad_(True)
        p = torch.tensor([3.0], device="cuda", requires_grad=True)
        out = fn(x, p)
        out.backward(gout)
        return out, x.grad, p.grad

    out, dx, dp = run(gem_pool)
    ref, dx_r, dp_r = run(gem_pool_plain)
    torch.cuda.synchronize()
    out, ref = out.detach(), ref.detach()
    e_out = float((out - ref).abs().max() / ref.abs().max())
    e_dx = float((dx - dx_r).abs().max() / dx_r.abs().max())
    e_dp = abs(float(dp) - float(dp_r)) / abs(float(dp_r))
    # relative: powf against torch.pow and the sum order; dp: the kernel sums
    # 524,288 terms in double, the plain autograd in fp32
    tol, tol_dp = 1e-5, 1e-3
    print(f"[K5] gem_pool: rel err forward {e_out:.3g}, d map {e_dx:.3g} "
          f"(tol {tol:.3g}), dp {e_dp:.3g} (tol {tol_dp:.3g}; dp {float(dp):.6g})")
    check(e_out <= tol and e_dx <= tol and e_dp <= tol_dp, "K5 differs from plain")
    x = fmap.detach().requires_grad_(True)
    p = torch.tensor([3.0], device="cuda", requires_grad=True)
    fwd = device_ms(lambda: gem_pool(x, p))
    ms = device_ms(lambda: gem_pool(x, p).backward(gout))
    plain = device_ms(lambda: gem_pool_plain(x, p).backward(gout))
    b, by = bound_ms(4 * (3 * fmap.numel() + 4 * n * c), 8 * fmap.numel())
    print(f"[K5] forward+backward ms {ms:.4f} (forward {fwd:.4f}) plain_ms "
          f"{plain:.4f} bound_ms {b:.4f} ({by})")
    report["gem_pool"] = dict(max_abs_err=float((dx - dx_r).abs().max()), ms=ms,
                              plain_ms=plain, bound_ms=b, bound_by=by)


def check_k6(report):
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        memory_loss,
        memory_loss_plain,
    )

    b, d = 256, 2048
    worst, timed = 0.0, None
    for k_pad, nv in ((768, 700), (30720, 30000)):
        g = torch.Generator(device="cuda").manual_seed(k_pad)
        centers = torch.nn.functional.normalize(
            torch.randn((nv, d), device="cuda", generator=g), dim=1)
        state = init_memory(centers, k_pad=k_pad, device="cuda")
        y = torch.randint(0, nv, (b,), device="cuda", generator=g, dtype=torch.int32)
        x0 = centers[y.long()] + 0.05 * torch.randn((b, d), device="cuda", generator=g)

        def run(fn, x0=x0, y=y, state=state):
            x = x0.detach().requires_grad_(True)
            loss, logits = fn(x, y, state)
            loss.mean().backward()
            return loss, logits, x.grad

        loss, logits, dx = run(memory_loss)
        loss_r, logits_r, dx_r = run(memory_loss_plain)
        torch.cuda.synchronize()
        e_l = float((logits[:, :nv] - logits_r[:, :nv]).abs().max())
        e_loss = float((loss - loss_r).abs().max())
        e_dx = float((dx - dx_r).abs().max())
        masked = bool(torch.isneginf(logits[:, nv:]).all())
        # temp 0.05 multiplies the fp32 product's rounding (~1e-7) by 20
        tol, tol_dx = 1e-4, 1e-6
        print(f"[K6] infonce B {b} D {d} K_pad {k_pad} num_valid {nv}: max_abs_err "
              f"logits {e_l:.3g}, loss {e_loss:.3g} (tol {tol:.3g}), dx {e_dx:.3g} "
              f"(tol {tol_dx:.3g}); masked columns -inf: {masked}")
        check(masked and e_l <= tol and e_loss <= tol and e_dx <= tol_dx,
              "K6 differs from plain")
        worst = max(worst, e_loss)
        x = x0.detach().requires_grad_(True)
        fwd = device_ms(lambda x=x, y=y, state=state: memory_loss(x, y, state))
        ms = device_ms(lambda x=x, y=y, state=state:
                       memory_loss(x, y, state)[0].mean().backward())
        plain = device_ms(lambda x=x, y=y, state=state:
                          memory_loss_plain(x, y, state)[0].mean().backward())
        bnd, by = bound_ms(4 * (2 * b * d + nv * d + b * k_pad + 2 * b * d),
                           2 * (2 * b * nv * d))
        print(f"[K6] K_pad {k_pad}: forward+backward ms {ms:.4f} (forward "
              f"{fwd:.4f}) plain_ms {plain:.4f} bound_ms {bnd:.4f} ({by})")
        if timed is None:
            timed = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
    report["infonce"] = dict(max_abs_err=worst, **timed)


def check_k7(report):
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        update_memory,
        update_memory_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(7)
    b, d, nv, k_pad = 256, 2048, 700, 768
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device="cuda", generator=g), dim=1)
    ids = torch.randperm(nv, device="cuda", generator=g)[:16]
    y = ids.repeat_interleave(16)[torch.randperm(b, device="cuda", generator=g)]
    y = y.to(torch.int32).contiguous()
    x = centers[y.long()] + 0.3 * torch.randn((b, d), device="cuda", generator=g)
    worst = 0.0
    for hard in (False, True):
        state = init_memory(centers, k_pad=k_pad, device="cuda")
        ref = state._replace(features=state.features.clone())
        update_memory(state, x, y, use_hard=hard, group_size=16)
        update_memory_plain(ref, x, y, use_hard=hard)
        torch.cuda.synchronize()
        err = float((state.features - ref.features).abs().max())
        tol = 1e-6   # unit rows, fp32 sums in other orders
        print(f"[K7] bank_fold {'hard' if hard else 'plain'} (16 labels x 16): "
              f"max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"K7 error {err} > {tol}")
        worst = max(worst, err)
    state = init_memory(centers, k_pad=k_pad, device="cuda")
    ms = device_ms(lambda: update_memory(state, x, y, group_size=16))
    plain = device_ms(lambda: update_memory_plain(state, x, y), reps=3)
    bnd, by = bound_ms(4 * (b * d + b + 2 * 16 * d), 10 * b * d)
    print(f"[K7] plain fold ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bnd:.4f} ({by})")
    report["bank_fold"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                               bound_ms=bnd, bound_by=by)


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
    ("K4 train_augment", ("train_augment_kernel", "erase_fill_kernel")),
    ("K5 gem_pool", ("gem_forward_kernel", "gem_backward_kernel",
                     "sum_partials_kernel")),
    ("K6 infonce", ("l2n_rows_kernel", "logits_kernel", "lse_loss_kernel",
                    "dxh_kernel", "l2n_backward_kernel")),
    ("K7 bank_fold", ("bank_fold_kernel",)),
    ("batchnorm", ("bn_fw", "bn_bw", "batchnorm", "batch_norm")),
    ("host-to-device copy", ("Memcpy HtoD",)),
    ("Adam (multi-tensor)", ("multi_tensor_apply",)),
    ("convolution", ("xmma", "gemm", "conv", "implicit", "dgrad", "wgrad",
                     "cutlass", "sm90")),
    ("max pool", ("max_pool",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise (ReLU, add, casts)", ("elementwise_kernel",)),
)


def profile_device(label, fn):
    """Run ``fn`` under ``torch.profiler``: device time by group and kernel,
    and the share of the window (first device event to last) in which the
    card ran nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA))
    if not dev:
        print(f"[profile] {label}: the profiler saw no device events: "
              "breakdown not measured")
        return
    busy, reach, by_name = 0.0, dev[0][0], {}
    for start, end, name in dev:
        busy += max(0.0, end - max(start, reach))   # union of the intervals
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    span = reach - dev[0][0]
    print(f"[profile] {label}: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms window, idle share {1 - busy / span:.4f}")
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label} group {group}: {us / busy:.2%} ({us / 1e3:.3f} ms)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] {label} {us / busy:7.2%} {us / 1e3:9.3f} ms  {name[:110]}")


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
    counts.update({k: v for k, v in kernels.launch_counts().items()
                   if k in ("eval_transform", "gem_bn_l2n", "rank_stats")})
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
    profile_device("extraction", lambda: extract_features(extractor, batches))
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


class _InMemoryImages:
    """Stands in for the loader's decode cache: file name → a staged uint8
    image of a numpy array. Budget 0, so the loader gathers per item."""
    budget = 0

    def __init__(self, imgs):
        self.imgs = imgs

    def get(self, fpath, height, width):
        return self.imgs[int(fpath.split(".")[0])]


def _pseudo_set(seed=0, n_ids=700, per_id=18, h=256, w=128):
    """A pseudo-labelled train set in memory: 700 ids x 18 images, 6
    cameras, a base colour per id plus noise, staged at 256x128."""
    rng = np.random.default_rng(seed)
    n = n_ids * per_id
    pids = np.repeat(np.arange(n_ids), per_id)
    cams = rng.integers(0, 6, n)
    base = rng.integers(0, 256, (n_ids, 3)).astype(np.int16)
    noise = rng.integers(-40, 40, (64, h, w, 3), dtype=np.int16)
    imgs = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, 64):
        e = min(s + 64, n)
        imgs[s:e] = np.clip(base[pids[s:e]][:, None, None] + noise[:e - s], 0, 255)
    items = [(f"{i:06d}.jpg", int(pids[i]), int(cams[i])) for i in range(n)]
    return items, imgs


def _compare_step(trainer, state, batch):
    """One step's loss, feature gradient and folded bank through the
    kernels (the model's own forward: K4, K5, K6, K7) and through the plain
    versions, from the same parameters, bank and draws. cuDNN's TF32 is off
    on both sides, so the two differ only by the kernels' arithmetic."""
    from reid_gan_torch.models.pooling import gem_pool_plain, l2n
    from reid_gan_torch.models.resnet import ResNetBackbone
    from reid_gan_torch.ops.cluster_memory import (
        memory_loss,
        memory_loss_plain,
        update_memory,
        update_memory_plain,
    )
    from reid_gan_torch.ops.transforms import (
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    model, dev, h, w = trainer.model, trainer.device, trainer.height, trainer.width
    img = torch.from_numpy(batch["img"]).to(dev)
    y = torch.from_numpy(batch["pid"].astype(np.int32)).to(dev)
    params = sample_augment_params(img.shape[0], h, w,
                                   torch.Generator(device=dev).manual_seed(99))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        results = []
        for plain in (False, True):
            mem = state.memory._replace(features=state.memory.features.clone())
            if plain:
                x = train_augment_plain(img, params)
                fmap = ResNetBackbone.forward(model, x)
                feat = l2n(model.feat_bn(gem_pool_plain(fmap, model.gap.p)))
            else:
                x = train_augment(img, params, h, w)
                feat = model(x, with_gan_feat=False)["feat"]
            feat.retain_grad()
            loss = (memory_loss_plain if plain else memory_loss)(feat, y, mem)[0].mean()
            loss.backward()
            (update_memory_plain if plain else update_memory)(mem, feat.detach(), y)
            model.zero_grad(set_to_none=True)
            results.append((float(loss.detach()), feat.grad, mem.features))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lk, gk, bk), (lp, gp, bp) = results
    e_loss = abs(lk - lp)
    e_g = float((gk - gp).abs().max() / gp.abs().max())
    e_bank = float((bk - bp).abs().max())
    # fp32 ResNet-50 on inputs that differ by K4's rounding, then temp 0.05
    tol_loss, tol_g, tol_bank = 1e-3, 1e-3, 1e-4
    print(f"[train] one step, kernels vs plain versions (TF32 off): loss {lk:.6f} "
          f"vs {lp:.6f} (err {e_loss:.3g}, tol {tol_loss:.3g}); feat grad rel err "
          f"{e_g:.3g} (tol {tol_g:.3g}); folded bank max_abs_err {e_bank:.3g} "
          f"(tol {tol_bank:.3g})")
    check(e_loss <= tol_loss and e_g <= tol_g and e_bank <= tol_bank,
          "the train step through the kernels differs from the plain versions")


def phase_train(counts):
    """The train main path: ``ClusterContrastTrainer.train`` on ResNet-50."""
    from reid_gan_torch import kernels
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.engine.usl import bank_rows, make_train_loader
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.cluster_memory import init_memory

    t0 = time.perf_counter()
    items, imgs = _pseudo_set()
    n_ids = 700
    g = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((n_ids, 2048), device="cuda", generator=g), dim=1)
    memory = init_memory(centers, k_pad=bank_rows(n_ids), device="cuda")
    torch.manual_seed(0)
    model = create("resnet50", norm=True)            # GeM, last stride 1, fp32
    trainer = ClusterContrastTrainer(model, height=256, width=128,
                                     num_instances=16, device="cuda")
    state = trainer.init_state(memory)
    loader = make_train_loader(items, 256, 128, 256, 16, workers=4, iters=400,
                               seed=1, cache=_InMemoryImages(imgs))
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    print(f"[train] set-up (data {len(items)} images, bank {tuple(memory.features.shape)}, "
          f"{memory.num_valid.item()} live): {time.perf_counter() - t0:.1f} s")

    steps = 20
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = trainer.train(state, 0, loader, train_iters=steps, print_freq=10,
                                base_seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update({k: v for k, v in kernels.launch_counts().items()
                   if k in ("train_augment", "gem_pool", "infonce", "bank_fold")})
    phases = kernels.phase_launch_counts()
    print(f"[train] {steps} steps (1st, cuDNN cold): {wall:.2f} s, mean loss {loss:.4f}")
    print(f"[train] launches: {phases}")
    for name in ("train_augment.forward", "gem_pool.forward", "gem_pool.backward",
                 "infonce.forward", "infonce.backward", "bank_fold.forward"):
        check(phases[name] == steps, f"{name} launched {phases[name]} times, "
                                     f"not once per step")
    check(np.isfinite(loss), f"loss is not finite: {loss}")
    still = [n for n, p in model.named_parameters() if p.requires_grad
             and torch.equal(p.detach(), before[n])]
    check(not still, f"parameters that did not move: {still[:5]}")
    norms = state.memory.features[:n_ids].norm(dim=1)
    err = float((norms - 1).abs().max())
    print(f"[train] {len(before)} parameter tensors all moved; bank rows' norm - 1: "
          f"max {err:.3g}")
    check(err <= 1e-5, "bank rows are not unit vectors after the fold")

    _compare_step(trainer, state, loader.next())

    warm = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.train(state, 1, loader, train_iters=warm, print_freq=warm,
                             base_seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[train] warm: {warm / dt:.3f} steps/s, {warm * 256 / dt:.1f} img/s "
          f"(batch 256, 256x128, ResNet-50, fp32 weights, TF32 convolutions)")
    profile_device("train (3 warm steps)", lambda: trainer.train(
        state, 2, loader, train_iters=3, print_freq=3, base_seed=1))
    loader.close()


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
    check_k4(report)
    check_k5(report)
    check_k6(report)
    check_k7(report)
    torch.cuda.synchronize()
    counts = {}
    phase_main_path(counts)
    torch.cuda.synchronize()
    phase_train(counts)
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
