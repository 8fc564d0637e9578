"""Project the 50-epoch Market-1501 USL run's wall clock on one card for the
PyTorch/CUDA port (the port's copy of ``scripts/project_market_walltime.py``).

The reference's complete run (CC/examples/logs/log.txt) takes 2 h 44 m
07 s on a GPU: each epoch extracts the 12,936 train images, builds the
Jaccard distance and runs DBSCAN, then 400 contrastive steps of batch 256;
an eval over 3,368 queries and 15,913 gallery images runs every 10 epochs.
This measures each phase at Market's scale and the recipe's shapes
(ResNet-50 computing in bf16 at 256x128, k1 30, k2 6, the ``use_hard``
bank at 751 clusters) through the port's modules, then projects the total:

- extraction: device-resident uint8 batches through the eval path (kernel
  K1, the encoder with kernel K2), the train set and the eval set;
- pseudo-labels: ``compute_jaccard_distance`` (kernel K8's kNN, the host
  C++ k-reciprocal sets) and ``dbscan`` on 12,936 unit features;
- training: 20 timed ``use_hard`` steps (kernels K4, K5, K6, K7);
- eval metrics: ``rank_metrics_features`` (kernel K3) at 3,368 x 15,913;
- the host loader's cached and streaming rates (``torch_bench_loader_
  scaling.bench_loader``; ``LOADER_IPS_CACHED`` and
  ``LOADER_IPS_STREAMING`` override both). ``--source memory`` feeds it
  from memory on a machine without Pillow (the card's); the JSON's
  ``loader_ips_used`` names the source.

Every phase with a host feed is projected as the slower of the host and
the device (``project``).

    python scripts/torch_project_market_walltime.py [--source memory] [--device cpu]

The last line is the projection as JSON, with the JAX script's keys.
"""

import json
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

N_TRAIN = 12_936
N_QUERY = 3_368
N_GALLERY = 15_913
NUM_IDS = 751
BATCH = 256
ITERS = 400
EPOCHS = 50
EVAL_EVERY = 10            # log.txt reports mAP at epochs 9/19/29/39/49
H, W = 256, 128
REF_TOTAL_S = 2 * 3600 + 44 * 60 + 7        # log.txt:2298


def loader_rates(source="jpeg", **sizes):
    """The host loader's cached and streaming img/s on one synthetic set
    (``bench_loader`` with the decode cache on, after a cold pass that
    fills it, then off), and the source that gave them: ``env`` when
    ``LOADER_IPS_CACHED`` and ``LOADER_IPS_STREAMING`` are both set."""
    import tempfile

    env_c = os.environ.get("LOADER_IPS_CACHED")
    env_s = os.environ.get("LOADER_IPS_STREAMING")
    if env_c and env_s:
        return float(env_c), float(env_s), "env"
    sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
    from torch_bench_loader_scaling import bench_loader

    from reid_gan_torch.data import loader as loader_mod

    with tempfile.TemporaryDirectory() as root:
        loader_mod._default_cache = loader_mod.ImageCache(4 << 30)
        bench_loader(root=root, source=source, **sizes)              # cold fill
        cached = bench_loader(root=root, source=source, **sizes)     # warm
        loader_mod._default_cache = loader_mod._NullCache()
        streaming = bench_loader(root=root, source=source, **sizes)
        loader_mod._default_cache = None                 # the lazy default again
    return (float(env_c) if env_c else cached,
            float(env_s) if env_s else streaming, source)


def project(t_extract, t_jaccard, t_dbscan, t_iter, t_eval_extract, t_eval_rank,
            loader_cached, loader_stream, n_train=N_TRAIN, n_eval=N_QUERY + N_GALLERY,
            batch=BATCH, iters=ITERS, epochs=EPOCHS, eval_every=EVAL_EVERY):
    """The JAX script's projection (project_market_walltime.py:177-208) of
    the measured phase seconds (``t_iter`` a step) and the loader's two
    rates (img/s). A phase with a host feed costs the slower of the host
    and the device, never their sum (the feed overlaps the compute). The
    cached run pays epoch 1 at the streaming rate (every image is read once)
    and the later epochs at the cached rate. Returns seconds: an epoch at
    each rate and whether its train loop is host-bound, epoch 1's extra
    decode, an eval, and the two totals."""
    train_imgs = iters * batch
    t_train = t_iter * iters
    n_evals = epochs // eval_every + 1

    def epoch_cost(ips):
        h_ex = n_train / ips
        h_tr = train_imgs / ips
        epoch_s = max(t_extract, h_ex) + t_jaccard + t_dbscan + max(t_train, h_tr)
        return epoch_s, h_tr > t_train

    eval_s = max(t_eval_extract, n_eval / loader_cached) + t_eval_rank
    epoch_c, host_bound_c = epoch_cost(loader_cached)
    epoch_st, host_bound_s = epoch_cost(loader_stream)
    return {"epoch_s_cached": epoch_c, "host_bound_cached": host_bound_c,
            "epoch_s_streaming": epoch_st, "host_bound_streaming": host_bound_s,
            "epoch1_decode_s": max(0.0, epoch_st - epoch_c), "eval_s": eval_s,
            "total_s_cached": epoch_st + (epochs - 1) * epoch_c + n_evals * eval_s,
            "total_s_streaming": epochs * epoch_st + n_evals * eval_s}


def main(device="cuda", source="jpeg", n_train=N_TRAIN, n_query=N_QUERY,
         n_gallery=N_GALLERY, num_ids=NUM_IDS, batch=BATCH, iters=ITERS, epochs=EPOCHS,
         eval_every=EVAL_EVERY, height=H, width=W, k1=30, k2=6, instances=16,
         timed=20, loader_sizes=None):
    """Each phase measured on ``device``, then the projection; returns the
    JSON line's dict (``loader_sizes``: ``bench_loader``'s keywords)."""
    import numpy as np
    import torch

    from reid_gan_torch.clustering.dbscan import dbscan
    from reid_gan_torch.device import resolve_device
    from reid_gan_torch.engine.metrics import rank_metrics_features
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.jaccard import compute_jaccard_distance
    from reid_gan_torch.ops.transforms import eval_transform

    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.RandomState(0)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    torch.manual_seed(0)
    model = create("resnet50", norm=True, dtype=torch.bfloat16).to(
        device, memory_format=torch.channels_last).eval()
    param_dtype = next(model.parameters()).dtype

    def extract(img_u8):
        with torch.inference_mode():
            return model(eval_transform(img_u8, height, width).to(param_dtype))

    img = torch.from_numpy(rng.randint(0, 256, (batch, height, width, 3),
                                       dtype=np.uint8)).to(device)

    # ---- phase 1: train-set feature extraction
    n_batches = -(-n_train // batch)
    extract(img)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_batches):
        out = extract(img)
    sync()
    t_extract = time.perf_counter() - t0
    print(f"extract {n_train} train imgs ({n_batches}x{batch}): "
          f"{t_extract:6.2f} s   (ref ~6.6 s)")

    # ---- phase 4's extraction half, before the trainer trains the model
    n_eval_batches = -(-(n_query + n_gallery) // batch)
    t0 = time.perf_counter()
    for _ in range(n_eval_batches):
        out = extract(img)
    sync()
    t_eval_extract = time.perf_counter() - t0
    feats_finite = bool(torch.isfinite(out).all())

    # ---- phase 2: pseudo-labels (host features, as the epoch's)
    feats = rng.randn(n_train, 2048).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    compute_jaccard_distance(feats[:512], k1=k1, k2=k2, print_flag=False, device=device)
    t0 = time.perf_counter()
    dist = compute_jaccard_distance(feats, k1=k1, k2=k2, print_flag=False, device=device)
    t_jaccard = time.perf_counter() - t0
    t0 = time.perf_counter()
    dbscan(dist, eps=0.4, min_samples=4)
    t_dbscan = time.perf_counter() - t0
    del dist
    print(f"jaccard N={n_train}:            {t_jaccard:6.2f} s   (ref 23.0 s)")
    print(f"dbscan:                      {t_dbscan:6.2f} s")

    # ---- phase 3: the contrastive loop (use_hard, the recipe's batch, bf16)
    centers = rng.randn(num_ids, 2048).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    trainer = ClusterContrastTrainer(model, height=height, width=width, use_hard=True,
                                     iters_per_epoch=iters, num_instances=instances,
                                     device=device)
    state = trainer.init_state(init_memory(centers, device=device))
    targets = torch.from_numpy(np.repeat(
        rng.choice(num_ids, batch // instances, replace=False), instances).astype(np.int32)
    ).to(device)
    state, loss = trainer.step(state, img, targets, 0)
    loss.item()
    t0 = time.perf_counter()
    for i in range(timed):
        state, loss = trainer.step(state, img, targets, i)
    loss = loss.item()
    t_iter = (time.perf_counter() - t0) / timed
    t_train = t_iter * iters
    print(f"train step:                  {t_iter * 1e3:6.1f} ms "
          f"-> {iters} iters = {t_train:.1f} s   (ref ~144 s)")

    # ---- phase 4's metrics half: distances and ranks on the card (K3)
    qf = rng.randn(n_query, 2048).astype(np.float32)
    gf = rng.randn(n_gallery, 2048).astype(np.float32)
    q_pids = rng.randint(0, num_ids, n_query)
    g_pids = rng.randint(0, num_ids, n_gallery)
    q_cams = rng.randint(0, 6, n_query)
    g_cams = rng.randint(0, 6, n_gallery)
    rank_metrics_features(qf[:2048], gf, q_pids[:2048], g_pids, q_cams[:2048], g_cams,
                          topk=10, device=device)
    t0 = time.perf_counter()
    cmc, m_ap = rank_metrics_features(qf, gf, q_pids, g_pids, q_cams, g_cams, topk=10,
                                      device=device)
    t_eval_rank = time.perf_counter() - t0
    t_eval = t_eval_extract + t_eval_rank
    print(f"eval (extract {n_query + n_gallery} + rank): {t_eval:6.2f} s "
          f"(extract {t_eval_extract:.2f} + metrics {t_eval_rank:.2f})")
    if not (feats_finite and np.isfinite([loss, m_ap, *cmc]).all()):
        raise RuntimeError("a phase gave a value that is not finite")

    # ---- projection
    loader_cached, loader_stream, fed_by = loader_rates(source, **(loader_sizes or {}))
    print(f"loader rates ({fed_by}): cached {loader_cached:.0f} img/s, "
          f"streaming {loader_stream:.0f} img/s")
    p = project(t_extract, t_jaccard, t_dbscan, t_iter, t_eval_extract, t_eval_rank,
                loader_cached, loader_stream, n_train=n_train,
                n_eval=n_query + n_gallery, batch=batch, iters=iters, epochs=epochs,
                eval_every=eval_every)
    print(f"\n{epochs}-epoch Market-1501 projection vs reference "
          f"164.1 min (log.txt:2298):")
    for tag, key, hb in (("cached", "cached", p["host_bound_cached"]),
                         ("streaming", "streaming", p["host_bound_streaming"])):
        total = p[f"total_s_{key}"]
        print(f"{tag:>10}: epoch {p[f'epoch_s_{key}']:6.1f} s "
              f"({'host' if hb else 'device'}-bound train loop)"
              f" -> {total / 60:.1f} min = {REF_TOTAL_S / total:.2f}x")
    print(f"  (cached run bills epoch 1 at streaming rates: "
          f"+{p['epoch1_decode_s']:.1f} s one-time decode)")
    line = {
        "extract_s": round(t_extract, 2), "jaccard_s": round(t_jaccard, 2),
        "dbscan_s": round(t_dbscan, 2), "train_iter_ms": round(t_iter * 1e3, 1),
        "epoch_s_cached": round(p["epoch_s_cached"], 1),
        "epoch_s_streaming": round(p["epoch_s_streaming"], 1),
        "epoch1_decode_s": round(p["epoch1_decode_s"], 1),
        "loader_ips_used": {"cached": round(loader_cached, 1),
                            "streaming": round(loader_stream, 1), "source": fed_by},
        "eval_s": round(t_eval, 2),
        "projected_total_min_cached": round(p["total_s_cached"] / 60, 1),
        "projected_total_min_streaming": round(p["total_s_streaming"] / 60, 1),
        "reference_total_min": 164.1,
        "speedup_cached": round(REF_TOTAL_S / p["total_s_cached"], 2),
        "speedup_streaming": round(REF_TOTAL_S / p["total_s_streaming"], 2)}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--source", choices=("jpeg", "memory"), default="jpeg")
    args = ap.parse_args()
    main(args.device, args.source)
