"""Port parity for the USL loop: the pseudo-label functions (DBSCAN, Infomap,
k-means) on the same features as the JAX package; a whole ``cluster_epoch``
on the synthetic dataset against JAX's pieces on the same transferred
weights; ``cli/train_usl`` end to end on the CPU, with its checkpoint read
back by ``cli/test``; the shared decode cache; and the options that are not
ported yet."""

import os.path as osp

import numpy as np
import pytest
import torch

from test_torch_port_knn import _gaps, few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _random_variables

MARGIN = 1e-5


def _separated(seed, n=320, d=32, k=10, k1=20):
    """Unit features in ``k`` tight clusters, with every row's first k1 + 1
    neighbours more than 1e-5 apart under both metrics (near-tied points
    dropped), so no near-tie decides a label."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    f = centers[rng.randint(k, size=n)] + 0.25 * rng.randn(n, d)
    f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    while True:
        bad = set()
        for gaps, order in _gaps(f, k1):
            rows, cols = np.nonzero(gaps <= MARGIN)
            bad.update(order[rows, cols + 1].tolist())
        if not bad:
            return f
        f = np.delete(f, sorted(bad), axis=0)


def test_pseudo_labels_match_jax_on_the_same_features():
    """DBSCAN on the Jaccard distance (no Jaccard value within 1e-5 of eps),
    Infomap on the inner-product graph (no similarity within 1e-5 of
    min_sim) and k-means: identical labels."""
    from reid_gan_tpu.clustering.kmeans import kmeans_labels as jax_kmeans
    from reid_gan_tpu.engine.usl import pseudo_labels_dbscan as jax_dbscan
    from reid_gan_tpu.engine.usl import pseudo_labels_infomap as jax_infomap
    from reid_gan_tpu.ops.distance import knn_search as jax_knn
    from reid_gan_tpu.ops.jaccard import compute_jaccard_distance
    from reid_gan_torch.clustering.kmeans import kmeans_labels
    from reid_gan_torch.engine.usl import pseudo_labels_dbscan, pseudo_labels_infomap

    f = _separated(0)
    assert f.shape[0] > 250
    eps, k1, k2 = 0.6, 20, 6
    jac = compute_jaccard_distance(f, k1=k1, k2=k2, print_flag=False)
    assert np.abs(jac - eps).min() > MARGIN
    ref = jax_dbscan(f, eps=eps, k1=k1, k2=k2, print_flag=False)
    got = pseudo_labels_dbscan(f, eps=eps, k1=k1, k2=k2, print_flag=False, device="cpu")
    assert ref.max() >= 5
    np.testing.assert_array_equal(got, ref)

    sims = np.asarray(jax_knn(f, 15, metric="ip")[0])
    assert np.abs(sims - 0.5).min() > MARGIN
    ref = jax_infomap(f, eps=0.5, k1=15, cluster_num=4, print_flag=False)
    got = pseudo_labels_infomap(f, eps=0.5, k1=15, cluster_num=4, print_flag=False,
                                device="cpu")
    assert ref.max() >= 5
    np.testing.assert_array_equal(got, ref)

    ref_l, ref_c = jax_kmeans(f, 10, seed=3)
    got_l, got_c = kmeans_labels(f, 10, seed=3, device="cpu")
    np.testing.assert_array_equal(got_l, np.asarray(ref_l))
    np.testing.assert_allclose(got_c, np.asarray(ref_c), rtol=0, atol=1e-5)


_FLAGS = ["--dataset", "synthetic", "--arch", "resnet18", "--height", "64",
          "--width", "32", "--batch-size", "16", "--num-instances", "4",
          "--eps", "0.7", "--k1", "8", "--k2", "3", "--workers", "2"]


def test_cluster_epoch_matches_jax(tmp_path):
    """One clustering phase on the synthetic set (resnet18, 64x32, DBSCAN
    eps 0.7, k1 8, k2 3) with the same random weights on both sides; the
    JAX features are extracted once and clustered by the JAX pieces that
    its ``cluster_epoch`` composes. The port's features and labels are the
    ones ``cluster_epoch`` hands to ``on_cluster``: features within the
    eval tolerance of test_torch_port_resnet.py (rtol 2e-3, atol 2e-4);
    labels, cluster count and pseudo-dataset identical; the bank within
    1e-4; every clustering span in ``Timer.spans``."""
    from reid_gan_tpu.config import parse_config as jax_parse
    from reid_gan_tpu.engine.evaluators import FeatureExtractor as JaxExtractor
    from reid_gan_tpu.engine.usl import build_pseudo_dataset as jax_pseudo
    from reid_gan_tpu.engine.usl import extract_train_features as jax_extract
    from reid_gan_tpu.engine.usl import generate_cluster_features as jax_centers
    from reid_gan_tpu.engine.usl import pseudo_labels_dbscan as jax_dbscan
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.data.datasets import create as create_dataset
    from reid_gan_torch.engine.evaluators import FeatureExtractor
    from reid_gan_torch.engine.usl import cluster_epoch
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax
    from reid_gan_torch.utils import Timer

    flags = _FLAGS + ["--data-dir", str(tmp_path)]
    train = list(create_dataset("synthetic", str(tmp_path)).train)
    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(13))

    jcfg = jax_parse(flags)
    jext = JaxExtractor(jmodel, {"params": params, "batch_stats": stats},
                        height=64, width=32, batch_size=16)
    ref_f, _ = jax_extract(jext, None, train, 64, 32, batch_size=16, workers=2)
    ref_labels = jax_dbscan(ref_f, eps=jcfg.cluster.eps, min_samples=jcfg.cluster.min_samples,
                            k1=jcfg.cluster.k1, k2=jcfg.cluster.k2, print_flag=False)
    ref_n = int(ref_labels.max()) + 1
    ref_bank = np.asarray(jax_init_memory(jax_centers(ref_labels, ref_f),
                                          k_pad=256).features)

    model = create("resnet18", norm=True)
    model.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    ext = FeatureExtractor(model, height=64, width=32, batch_size=16, device="cpu")
    clustered = []
    Timer.spans.clear()
    memory, pseudo, num_clusters = cluster_epoch(
        ext, train, parse_config(flags), print_flag=False,
        on_cluster=lambda f, lab: clustered.append((f, lab)))
    (feats, labels), = clustered
    np.testing.assert_allclose(feats, ref_f, rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(labels, ref_labels)
    assert {"extract", "knn", "jaccard", "dbscan", "bank"} <= set(Timer.spans)
    assert ref_n >= 4 and num_clusters == ref_n
    assert pseudo == jax_pseudo(train, ref_labels)
    assert tuple(memory.features.shape) == ref_bank.shape
    assert int(memory.num_valid) == ref_n
    np.testing.assert_allclose(memory.features.numpy(), ref_bank, rtol=0, atol=1e-4)


def test_train_usl_end_to_end_and_its_checkpoint_in_the_eval_cli(tmp_path, capsys):
    """``cli.train_usl.main(--debug --device cpu)`` writes the checkpoints,
    log.txt and a train_opt.txt whose lines are JAX's for the sections both
    parse; ``cli.test --resume-torch model_best.pth.tar`` then prints the
    mAP of the loop's final eval."""
    from reid_gan_torch.cli.test import main as test_main
    from torch_port_opts import assert_options_match_jax
    from reid_gan_torch.cli.train_usl import main

    logs = tmp_path / "logs"
    flags = _FLAGS + ["--data-dir", str(tmp_path), "--eval-step", "1", "--debug",
                      "--logs-dir", str(logs)]
    best = main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    for f in ("checkpoint.pth.tar", "model_best.pth.tar", "log.txt", "train_opt.txt"):
        assert osp.exists(logs / f), f
    assert "Clustered into" in out and "Test with the best model" in out
    final_map = out.split("Test with the best model")[1].split("Mean AP: ")[1].split("\n")[0]
    with open(logs / "log.txt") as fh:
        assert "Clustered into" in fh.read()

    assert_options_match_jax("train_usl", logs / "train_opt.txt", flags)

    cmc, mAP = test_main(_FLAGS + ["--data-dir", str(tmp_path), "--resume-torch",
                                   str(logs / "model_best.pth.tar"), "--device", "cpu"])
    assert f"Mean AP: {mAP:4.1%}" == f"Mean AP: {final_map}"
    assert abs(mAP - best) <= 1e-9
    assert 0.0 <= best <= 1.0 and cmc.shape == (100,)

    # --resume reads the same checkpoint back into the loop's model
    _, resumed = main(flags[:-2] + ["--logs-dir", str(tmp_path / "again"), "--device",
                                    "cpu", "--resume", str(logs / "model_best.pth.tar"),
                                    "--evaluate"])
    assert abs(resumed - best) <= 1e-9


def test_preprocessors_share_one_decode_cache():
    from reid_gan_torch.data.loader import ImageCache, Preprocessor, default_image_cache

    a, b = Preprocessor([("x.jpg", 0, 0)]), Preprocessor([], height=64, width=32)
    assert a.cache is b.cache is default_image_cache()
    assert Preprocessor([], cache=None).cache is not a.cache
    own = ImageCache(1 << 20)
    assert Preprocessor([], cache=own).cache is own


def test_train_usl_refuses_the_cpu_unless_asked_and_unported_options(monkeypatch, tmp_path):
    """``--fp16`` and a msgpack ``--resume`` are ported (test_torch_port_fp16*.py,
    test_torch_port_resume.py): a missing checkpoint raises the JAX CLI's
    ``ValueError``, with ``--fp16`` too. Without a card the CLI raises."""
    from reid_gan_torch.cli.train_usl import main

    for extra in ([], ["--fp16"]):
        with pytest.raises(ValueError, match="No checkpoint found"):
            main(_FLAGS + ["--device", "cpu", "--data-dir", str(tmp_path), "--logs-dir",
                           str(tmp_path / "logs"), "--resume",
                           str(tmp_path / "checkpoint.msgpack")] + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--data-dir", "/nonexistent"])
