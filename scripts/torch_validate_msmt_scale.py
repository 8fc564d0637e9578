"""MSMT17-scale pseudo-label-phase validation of the PyTorch/CUDA port, on
the card (the port's copy of ``scripts/validate_msmt_scale.py``).

The reference's largest declared configuration is MSMT17
(CC/clustercontrast/datasets/msmt17.py): N=32,621 train images, about 10k
real clusters. This runs the port's whole pseudo-label phase at that N, on
32,621 unit rows of 2,048 around 10,000 centres, and bounds its wall clock
and memory:

1. **Jaccard** (kernel K8's L2 kNN → the host C++ k-reciprocal sets →
   min-sum) at N=32,621 within (N/N0)^2 x the 23 s Market budget (about
   146 s): no worse than quadratic, the algorithm's own cost. Once in
   float32 and once rounded to float16 (``use_float16``), which must agree
   within 2e-3 on the first 256 rows. The only dense (N, N) array is the
   returned matrix (4.3 GB in float32, 2.1 GB in float16).
2. **DBSCAN** (eps 0.6, min 4; host C++) over that matrix within the same
   budget, with more than 1,000 clusters.
3. **Infomap** (kernel K8's inner-product kNN, k 15, min_sim 0.55 → the
   host C++ two-level map equation) within the same budget.
4. **Cluster memory at K = the DBSCAN cluster count**: a bank built by
   ``init_memory`` padded as the CLIs pad it, then one ``memory_loss``
   value and gradient with respect to 256 rows (kernel K6 forward and
   backward), held against the plain version, then 10 timed: < 1 s a step.
5. **Peak RSS** (the process's ``ru_maxrss``) < 24 GB.

    python scripts/torch_validate_msmt_scale.py [--device cpu]

The last line is ``main``'s results as JSON, the kernels' launches in the
phase among them.
"""

import os.path as osp
import resource
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

N_MSMT = 32621            # msmt17.py train split
N_MARKET = 12936
MARKET_BUDGET_S = 23.0    # reference GPU+faiss Jaccard time (log.txt:18)
SCALE = (N_MSMT / N_MARKET) ** 2
BUDGET_S = MARKET_BUDGET_S * SCALE   # each phase's, about 146 s
K_CLUSTERS = 10000
PEAK_RSS_GB = 24.0
FP16_TOL = 2e-3
MIN_CLUSTERS = 1000
MEMORY_STEP_S = 1.0
# K6 against its plain version: the logits' and losses' tolerance, the
# gradient's (3xTF32 products; chip_smoke.check_k6)
K6_TOL, K6_TOL_DX = 1e-4, 1e-6


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def make_feats(n, d=2048, k=K_CLUSTERS, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d).astype(np.float32)
    feats = centers[rng.randint(k, size=n)] + \
        0.7 * rng.randn(n, d).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats


def verdict(r):
    """The checks on the phase's results ``r`` (``main``'s dict)."""
    from reid_gan_torch.utils.validation import require

    budget = BUDGET_S
    require(r["jaccard_s"] < budget, f"jaccard {r['jaccard_s']:.0f}s > {budget:.0f}s budget")
    require(r["fp16_err"] < FP16_TOL, f"fp16 Jaccard deviates: {r['fp16_err']}")
    require(r["dbscan_s"] < budget, f"dbscan {r['dbscan_s']:.0f}s > {budget:.0f}s budget")
    require(r["clusters"] > MIN_CLUSTERS, f"degenerate clustering ({r['clusters']} clusters)")
    require(r["infomap_s"] < budget, f"infomap {r['infomap_s']:.0f}s > {budget:.0f}s budget")
    require(r["memory_s"] < MEMORY_STEP_S,
            f"memory step {r['memory_s']:.2f}s at K={r['bank_k']}")
    require(r["rss_gb"] < PEAK_RSS_GB, f"peak RSS {r['rss_gb']:.1f} GB > {PEAK_RSS_GB} GB")


def memory_step(feats, labels, k, device, runs=10):
    """The bank of ``k`` rows (the first 64 clusters' mean rows, tiled,
    L2-normalised; ``init_memory`` padded as ``cluster_epoch`` pads it) and
    the mean ``memory_loss`` of ``feats[:256]`` with its gradient: held
    against the plain version once, then ``runs`` steps timed. Returns
    (seconds a step, the hold's errors (logits, loss, gradient), the
    bank's padded rows)."""
    import numpy as np
    import torch

    from reid_gan_torch.engine.usl import bank_rows
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss, memory_loss_plain

    centers = np.stack([feats[labels == c].mean(0) for c in range(min(k, 64))])
    bank = np.tile(centers, (k // len(centers) + 1, 1))[:k]
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    state = init_memory(bank, k_pad=bank_rows(k), device=device)
    x = torch.tensor(feats[:256], device=device, requires_grad=True)
    tgt = torch.tensor(np.arange(256) % k, dtype=torch.int32, device=device)

    def step(fn):
        loss, logits = fn(x, tgt, state, temp=0.05)
        return loss, logits, torch.autograd.grad(loss.mean(), x)[0]

    got, ref = step(memory_loss), step(memory_loss_plain)
    errs = tuple(float((a - b).detach().abs().max()) for a, b in
                 ((got[1][:, :k], ref[1][:, :k]), (got[0], ref[0]), (got[2], ref[2])))
    if x.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        step(memory_loss)
    if x.is_cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs, errs, state.features.shape[0]


def main(device="cuda", n=N_MSMT, k=K_CLUSTERS):
    """The phase at ``n`` rows around ``k`` centres on ``device``. Returns
    its results (seconds, clusters, errors, RSS); raises
    ``AssertionError`` when a check fails."""
    import numpy as np

    from reid_gan_torch.clustering.dbscan import dbscan
    from reid_gan_torch.clustering.infomap import cluster_by_infomap
    from reid_gan_torch.device import resolve_device
    from reid_gan_torch.kernels import launch_counts
    from reid_gan_torch.ops.jaccard import compute_jaccard_distance
    from reid_gan_torch.utils.validation import require

    device = resolve_device(device)
    launches0 = launch_counts()
    print(f"budgets: jaccard/dbscan/infomap < {BUDGET_S:.0f} s each "
          f"(quadratic scaling of the {MARKET_BUDGET_S:.0f} s Market "
          f"budget), peak RSS < {PEAK_RSS_GB:.0f} GB")
    feats = make_feats(n, k=k)
    r = {}

    # the kernels' and the host library's loading, at a small N
    compute_jaccard_distance(feats[:512], k1=30, k2=6, print_flag=False, device=device)

    t0 = time.perf_counter()
    dist = compute_jaccard_distance(feats, k1=30, k2=6, print_flag=False, device=device)
    r["jaccard_s"] = time.perf_counter() - t0
    print(f"jaccard fp32   N={n}: {r['jaccard_s']:7.1f} s  rss={rss_gb():.1f} GB")

    t0 = time.perf_counter()
    dist16 = compute_jaccard_distance(feats, k1=30, k2=6, print_flag=False,
                                      use_float16=True, device=device)
    r["jaccard16_s"] = time.perf_counter() - t0
    require(dist16.dtype == np.float16, f"use_float16 returned {dist16.dtype}")
    r["fp16_err"] = float(np.abs(dist16[:256].astype(np.float32) - dist[:256]).max())
    print(f"jaccard fp16   N={n}: {r['jaccard16_s']:7.1f} s  "
          f"max|d16-d32|={r['fp16_err']:.2e}")
    del dist16

    t0 = time.perf_counter()
    labels = dbscan(dist, eps=0.6, min_samples=4)
    r["dbscan_s"] = time.perf_counter() - t0
    r["clusters"] = len(set(labels[labels >= 0].tolist()))
    print(f"dbscan         N={n}: {r['dbscan_s']:7.1f} s  clusters={r['clusters']}")
    del dist

    before = launch_counts()["knn_topk"]
    t0 = time.perf_counter()
    il = cluster_by_infomap(feats, k=15, min_sim=0.55, device=device)
    r["infomap_s"] = time.perf_counter() - t0
    r["infomap_knn_launches"] = launch_counts()["knn_topk"] - before
    r["infomap_clusters"] = len(set(il[il >= 0].tolist()))
    print(f"infomap        N={n}: {r['infomap_s']:7.1f} s  "
          f"clusters={r['infomap_clusters']}  K8 launches={r['infomap_knn_launches']}")

    r["bank_k"] = max(r["clusters"], 2)
    r["memory_s"], errs, rows = memory_step(feats, labels, r["bank_k"], device)
    print(f"memory step    K={r['bank_k']} ({rows} rows): {r['memory_s'] * 1e3:7.1f} ms; "
          f"against the plain version: logits {errs[0]:.3g}, loss {errs[1]:.3g} "
          f"(tol {K6_TOL:.3g}), dx {errs[2]:.3g} (tol {K6_TOL_DX:.3g})")
    require(errs[0] <= K6_TOL and errs[1] <= K6_TOL and errs[2] <= K6_TOL_DX,
            f"memory_loss differs from its plain version at K={r['bank_k']}: {errs}")

    r["rss_gb"] = rss_gb()
    print(f"peak RSS: {r['rss_gb']:.1f} GB")
    r["launches"] = {k: v - launches0[k] for k, v in launch_counts().items()}
    verdict(r)
    print(f"MSMT-SCALE VALIDATION PASSED "
          f"(jaccard {r['jaccard_s']:.0f}s, dbscan {r['dbscan_s']:.0f}s, "
          f"infomap {r['infomap_s']:.0f}s, memory {r['memory_s'] * 1e3:.0f}ms, "
          f"rss {r['rss_gb']:.1f}GB)")
    return r


if __name__ == "__main__":
    import argparse

    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(main(ap.parse_args().device)))
