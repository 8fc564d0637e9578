"""Port parity for FD-GAN's evaluation and CLIs on the synthetic set at
64x32: the ``CascadeEvaluator`` (stage-1 distances, the verifier's stage-2
re-scoring, mAP and the allshots/cuhk03/market1501 CMC of both stages)
against the JAX evaluator on the same weights, within 1e-4; and the three
CLIs chained through their checkpoints, ``--debug --device cpu``."""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fdgan_nets import random_tree
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

H, W = 64, 32


def _capture(monkeypatch, module):
    """Record each (distmat, result) of ``module.fd_evaluate_all``."""
    seen = []
    real = module.fd_evaluate_all

    def wrapped(distmat, *args, **kwargs):
        d = np.array(distmat, np.float64)
        seen.append((d, real(distmat, *args, **kwargs)))
        return seen[-1][1]

    monkeypatch.setattr(module, "fd_evaluate_all", wrapped)
    return seen


def test_cascade_evaluator_matches_jax(tmp_path, monkeypatch):
    """dataset=None: both stages' distance matrices within 1e-4, and from
    each the mAP and the three protocols' CMC (K3's all-shots and
    separate-camera variants, the cuhk03 sampler) within 1e-4."""
    from reid_gan_tpu.data.datasets import create as jax_create
    from reid_gan_tpu.data.loader import DataLoader as JaxLoader
    from reid_gan_tpu.data.loader import Preprocessor as JaxPre
    from reid_gan_tpu.engine import fdgan as jax_fdgan
    from reid_gan_tpu.engine.evaluators import FeatureExtractor as JaxExtractor
    from reid_gan_tpu.engine.fdgan import CascadeEvaluator as JaxCascade
    from reid_gan_tpu.models.embedding import EltwiseSubEmbed as JaxEmbed
    from reid_gan_tpu.models.multi_branch import siamese_baseline as jax_siamese
    from reid_gan_tpu.models.resnet import FDResNet as JaxFDResNet
    from reid_gan_torch.cli.fdgan_baseline import make_cascade_evaluator
    from reid_gan_torch.config import Config
    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.engine import fdgan
    from reid_gan_torch.engine.metrics import cmc, rank_metrics
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax
    from reid_gan_torch.models.multi_branch import siamese_baseline

    ds = create("synthetic", str(tmp_path), num_ids=8, imgs_per_id=4)
    jds = jax_create("synthetic", str(tmp_path), num_ids=8, imgs_per_id=4)
    query, gallery = list(ds.query), list(ds.gallery) + list(ds.train)[:40]
    jm = jax_siamese(depth=18)
    v = random_tree(jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, H, W, 3)),
                                                     jnp.zeros((2, H, W, 3)), train=False),
                                   jax.random.PRNGKey(0)), 90)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    topk = 12

    jseen = _capture(monkeypatch, jax_fdgan)
    ex = JaxExtractor(JaxFDResNet(depth=18, cut_at_pooling=True),
                      {"params": v["params"]["base_model"],
                       "batch_stats": v["batch_stats"]["base_model"]},
                      height=H, width=W, batch_size=16, dtype=jnp.float32)
    jev = JaxCascade(ex, JaxEmbed(nonlinearity="square", use_batch_norm=True,
                                  use_classifier=True, num_features=512, num_classes=2),
                     v["params"]["embed_model"], v["batch_stats"]["embed_model"])
    jloader = JaxLoader(JaxPre(query + gallery, mode="reid", height=H, width=W),
                        batch_size=16, drop_last=False, num_workers=2)
    ref_top1 = jev.evaluate(jloader, query, gallery, rerank_topk=topk, dataset=None)

    seen = _capture(monkeypatch, fdgan)
    cfg = Config()
    cfg.data.height, cfg.data.width, cfg.data.batch_size = H, W, 16
    model = siamese_baseline(depth=18)
    model.load_state_dict(siamese_state_dict_from_jax(v["params"], v["batch_stats"]))
    ev = make_cascade_evaluator(model, cfg, "cpu")
    loader = DataLoader(Preprocessor(query + gallery, mode="reid", height=H, width=W),
                        batch_size=16, drop_last=False, num_workers=2)
    top1 = ev.evaluate(loader, query, gallery, rerank_topk=topk, dataset=None)

    assert len(seen) == len(jseen) == 2 and abs(top1 - ref_top1) <= 1e-4
    ids = ([p for _, p, _ in query], [p for _, p, _ in gallery],
           [c for _, _, c in query], [c for _, _, c in gallery])
    for (d, _), (jd, _) in zip(seen, jseen):
        np.testing.assert_allclose(d, jd, rtol=1e-4, atol=1e-4)
        _, m = rank_metrics(d, *ids, topk=1, device="cpu")
        _, jm_ = rank_metrics(jd, *ids, topk=1, device="cpu")
        assert abs(m - jm_) <= 1e-4
        for name, proto in fdgan._PROTOCOLS.items():
            np.testing.assert_allclose(cmc(d, *ids, seed=0, device="cpu", **proto),
                                       cmc(jd, *ids, seed=0, device="cpu", **proto),
                                       atol=1e-4, err_msg=name)
    # the second stage re-scores with the verifier: distances of [0, 1] in
    # front of a tail moved past the gap
    d2 = seen[1][0]
    assert (np.sort(d2, axis=1)[:, :topk] <= 1.0).all()


def test_fdgan_clis_chain_through_their_checkpoints(tmp_path):
    """``cli/fdgan_baseline`` → ``cli/fdgan_train --stage 1`` (E from the
    baseline's checkpoint, Di from it) → ``--stage 2`` (each net from its
    stage-1 file), ``--debug --device cpu``: every checkpoint written, the
    losses finite, the stage-2 validation run; ``--dataset cuhk03`` raises."""
    from reid_gan_torch.cli import fdgan_baseline, fdgan_train
    from reid_gan_torch.utils.serialization import load_checkpoint

    common = ["--dataset", "synthetic", "--data-dir", str(tmp_path / "d"), "--height",
              str(H), "--width", str(W), "-b", "8", "-j", "2", "--debug", "--device", "cpu"]
    best = fdgan_baseline.main(common + ["--logs-dir", str(tmp_path / "base")])
    assert 0.0 < best <= 1.0
    ck = load_checkpoint(str(tmp_path / "base" / "model_best.pth.tar"))
    assert ck["state_dict"]["embed_model.classifier.weight"].shape == (2, 512)
    m1 = fdgan_train.main(common + [
        "--stage", "1", "--pose-aug", "gauss", "--logs-dir", str(tmp_path / "s1"),
        "--save-dir", str(tmp_path / "c1"),
        "--netE-pretrain", str(tmp_path / "base" / "model_best.pth.tar")])
    di = m1.net_Di.state_dict()["embed_model.classifier.weight"]
    assert di.shape == (1, 512)
    s1 = tmp_path / "c1" / "experiment"
    nets = {n: str(s1 / f"latest_net_{n}.pth") for n in ("E", "G", "Di", "Dp")}
    assert all(osp.exists(p) for p in nets.values())
    assert osp.exists(tmp_path / "s1" / "images" / "epoch000_fake.png")
    m2 = fdgan_train.main(common + [
        "--stage", "2", "--pose-aug", "erase", "--eval-step", "1",
        "--logs-dir", str(tmp_path / "s2"), "--save-dir", str(tmp_path / "c2"),
        "--netE-pretrain", nets["E"], "--netG-pretrain", nets["G"],
        "--netDi-pretrain", nets["Di"], "--netDp-pretrain", nets["Dp"]])
    assert osp.exists(tmp_path / "c2" / "experiment" / "best_net_E.pth")
    with open(tmp_path / "s2" / "loss_log.txt") as f:
        last = f.read().strip().splitlines()[-1]
    assert "G: " in last and "nan" not in last
    assert m2.stage == 2 and len(m2.opt_G.param_groups[0]["params"]) > \
        len(list(m2.net_G.parameters()))
    with pytest.raises(NotImplementedError, match="ROADMAP A: `JsonDataset`/CUHK03"):
        fdgan_train.main(["--dataset", "cuhk03", "--device", "cpu",
                          "--logs-dir", str(tmp_path / "x")])
    assert torch.isfinite(next(m2.net_G.parameters())).all()
