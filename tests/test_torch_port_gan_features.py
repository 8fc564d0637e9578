"""Port parity for GAN-feature clustering and the confidence weights
(``--cluster-with-gan-features``): the extractor's ``test_all`` forward
(features and pooled GAN features) for each encoder that has one, a
``cluster_epoch`` with the GAN bank, ``compute_conf_weight`` for the pose
and the AE generators, an fp64 ``train_all`` step folding a GAN bank under
weights with zeros, ``AEModel.synthesize_mix_p``, and two epochs of
``cli/train_gan_usl`` with the flag on the CPU.

Small sizes: images at 64x32, GAN at 16x8 (32x16 in the CLI run); weights
drawn with numpy in the JAX trees and carried across by ``models/convert.py``
and ``models/dual_gan/convert.py``."""

import os.path as osp
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import ae_variables, jax_ae_gan
from test_torch_port_gan_cli import _GAN
from test_torch_port_gan_nets import gan_variables, jax_gan
from test_torch_port_joint import GH, GW, _batch, joint_setup, train_all_step_matches_jax
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _random_variables, _to64
from test_torch_port_usl import _FLAGS

H, W = 64, 32


def _port_encoder(arch, params, stats):
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import (
        resnet_state_dict_from_jax,
        variant_state_dict_from_jax,
    )

    model = create(arch)
    convert = variant_state_dict_from_jax if arch.startswith(("resnet_bip", "resnet_mp")) \
        else resnet_state_dict_from_jax
    model.load_state_dict(convert(params, stats), strict=True)
    return model


@pytest.mark.parametrize("arch", ["resnet18", "resnet_ibn50a", "resnet_bipd50",
                                  "resnet_mp50"])
def test_extractor_test_all_matches_jax(arch):
    """``FeatureExtractor(extra_features=True)`` on a uint8 batch of 4 at
    64x32, both extractors in fp32 (input, weights, features), JAX at the
    highest matmul precision: the features and the GAN maps' spatial means
    within 1e-5 of max(1, their largest magnitude). The GAN map is K11's
    plain version (``resnet18``, ``resnet_ibn50a``, ``resnet_bipd50``), of
    unit rows, or ``resnet_mp50``'s 1x1 projection, whose means run to
    about 2e3; ``resnet_mp50`` also returns ``feat_g``."""
    from reid_gan_tpu.engine.evaluators import FeatureExtractor as JaxExtractor
    from reid_gan_tpu.models import create as jax_create
    from reid_gan_torch.engine.evaluators import FeatureExtractor

    jmodel = jax_create(arch)
    params, stats = _random_variables(jmodel, np.random.RandomState(60))
    img = np.random.RandomState(61).randint(0, 256, (4, H, W, 3)).astype(np.uint8)
    with jax.default_matmul_precision("highest"):
        ref_f, ref_g = JaxExtractor(jmodel, {"params": params, "batch_stats": stats},
                                    height=H, width=W, batch_size=4, extra_features=True,
                                    dtype=jnp.float32)(img)
    model = _port_encoder(arch, params, stats)
    ext = FeatureExtractor(model, height=H, width=W, batch_size=4, device="cpu",
                           dtype=torch.float32, extra_features=True)
    f, g = ext(img)
    assert f.shape == ref_f.shape and g.shape == ref_g.shape and g.dtype == np.float32
    for got, ref in ((f, ref_f), (g, ref_g)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    with torch.no_grad():
        out = model.eval()(torch.zeros(2, 3, H, W), test_all=True)
    want = {"feat", "gan_feat", "feat_g"} if arch == "resnet_mp50" else {"feat", "gan_feat"}
    assert set(out) == want


def test_cluster_epoch_with_gan_features_matches_jax(tmp_path):
    """One clustering phase with an ``extra_features`` extractor on the
    synthetic set (resnet18 in fp64 on both sides, features and pooled GAN
    features rounded to fp32 as both extractors return them; DBSCAN eps
    0.7, k1 8, k2 3), against the JAX pieces its ``cluster_epoch``
    composes: identical labels (no Jaccard distance within 1e-5 of eps), the
    bank and the GAN bank within 1e-6."""
    from reid_gan_tpu.config import parse_config as jax_parse
    from reid_gan_tpu.engine.evaluators import FeatureExtractor as JaxExtractor
    from reid_gan_tpu.engine.usl import extract_train_features as jax_extract
    from reid_gan_tpu.engine.usl import generate_cluster_features as jax_centers
    from reid_gan_tpu.engine.usl import pseudo_labels_dbscan as jax_dbscan
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_tpu.ops.jaccard import compute_jaccard_distance
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.data.datasets import create as create_dataset
    from reid_gan_torch.engine.evaluators import FeatureExtractor
    from reid_gan_torch.engine.usl import cluster_epoch

    flags = _FLAGS + ["--data-dir", str(tmp_path)]
    train = list(create_dataset("synthetic", str(tmp_path)).train)
    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(14))
    cfg = jax_parse(flags)
    with jax.enable_x64(True):
        jext = JaxExtractor(jmodel, {"params": _to64(params), "batch_stats": _to64(stats)},
                            height=H, width=W, batch_size=16, extra_features=True,
                            dtype=jnp.float64)
        ref_f, ref_g = jax_extract(jext, None, train, H, W, batch_size=16, workers=2)
    assert np.abs(compute_jaccard_distance(ref_f, k1=cfg.cluster.k1, k2=cfg.cluster.k2,
                                           print_flag=False) - cfg.cluster.eps).min() > 1e-5
    ref_labels = jax_dbscan(ref_f, eps=cfg.cluster.eps, min_samples=cfg.cluster.min_samples,
                            k1=cfg.cluster.k1, k2=cfg.cluster.k2, print_flag=False)
    ref = jax_init_memory(jax_centers(ref_labels, ref_f), k_pad=256,
                          gan_centroids=jax_centers(ref_labels, ref_g))

    model = _port_encoder("resnet18", params, stats).double()
    ext = FeatureExtractor(model, height=H, width=W, batch_size=16, device="cpu",
                           dtype=torch.float64, extra_features=True)
    clustered = []
    memory, _, num_clusters = cluster_epoch(
        ext, train, parse_config(flags), print_flag=False,
        on_cluster=lambda f, lab: clustered.append((f, lab)))
    (_, labels), = clustered
    np.testing.assert_array_equal(labels, ref_labels)
    assert num_clusters == int(ref_labels.max()) + 1 >= 4
    assert memory.gan_features.shape == memory.features.shape == (256, 512)
    for name in ("features", "gan_features"):
        np.testing.assert_allclose(getattr(memory, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0, atol=1e-6,
                                   err_msg=name)


def _recorded(obj, name, into):
    """Wrap ``obj.name`` so each return value is appended to ``into`` as a
    numpy array."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append(np.asarray(out.detach() if torch.is_tensor(out) else out))
        return out

    return wrapped


@pytest.mark.parametrize("gen", ["Pose", "AE"])
def test_compute_conf_weight_matches_jax(tmp_path, monkeypatch, gen):
    """``compute_conf_weight`` over the synthetic set's 80 train images with
    pseudo-labels into a bank of 8 live rows (of 256), in fp64 on both
    sides, the pose generator (16x8, rendering each image's centroid in its
    keypoints) and the AE generator (16x8): every per-sample
    reconstruction loss within 1e-9 relative, and identical weights (the
    80 // 4 worst samples 0, the others 1). The JAX function gets the
    port's GAN images (K9's plain version) and pose maps (K10's): the
    jitted and eager JAX transforms round those fp32 maps an ulp apart from
    each other, which the loss carries at 1e-7; the transforms' own parity
    is held in test_torch_port_gan_ops.py."""
    from reid_gan_tpu.cli import train_gan_usl as jax_cli
    from reid_gan_tpu.cli.train_gan_usl import compute_conf_weight as jax_conf
    from reid_gan_tpu.config import parse_config as jax_parse
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_torch.cli.train_gan_usl import compute_conf_weight
    from reid_gan_torch.config import GANConfig, parse_config
    from reid_gan_torch.data.datasets import create as create_dataset
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.pose import batch_cords_to_map
    from reid_gan_torch.ops.transforms import gan_input_transform

    ds = create_dataset("synthetic", str(tmp_path))
    pseudo = [(f, pid, cam) for f, pid, cam in ds.train]
    flags = _FLAGS + ["--data-dir", str(tmp_path), "--gan-height", str(GH),
                      "--gan-width", str(GW)]
    reid = 512 if gen == "Pose" else 64
    rng = np.random.RandomState(70)
    bank = rng.randn(8, reid)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    jgan = jax_gan() if gen == "Pose" else jax_ae_gan()
    G, Dv = (gan_variables if gen == "Pose" else ae_variables)(jgan, 71)

    ref_rec = []
    monkeypatch.setattr(jgan, "get_L1_loss", _recorded(jgan, "get_L1_loss", ref_rec))
    monkeypatch.setattr(jax_cli, "gan_input_transform", lambda x, h, w: jnp.asarray(
        gan_input_transform(torch.from_numpy(np.array(x)), h, w).permute(0, 2, 3, 1)
        .numpy()))
    monkeypatch.setattr(jax_cli, "jax", SimpleNamespace(vmap=lambda fn: lambda kp, old: (
        jnp.asarray(batch_cords_to_map(torch.from_numpy(np.array(kp)),
                                       torch.from_numpy(np.array(old)), GH, GW).numpy()))))
    with jax.enable_x64(True):
        ref = jax_conf(jgan, SimpleNamespace(G=_to64(G), D=_to64(Dv)), pseudo,
                       jax_init_memory(bank, k_pad=256), jax_parse(flags), ds.train_pose_dir)

    gan = AEModel(GANConfig(model="AE", model_gen=gen), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, reid_feat_dim=reid, device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    rec = []
    gan.get_L1_loss = _recorded(gan, "get_L1_loss", rec)
    conf = compute_conf_weight(gan, pseudo, init_memory(bank, k_pad=256, device="cpu"),
                               parse_config(flags), ds.train_pose_dir)

    rec, ref_rec = np.concatenate(rec), np.concatenate(ref_rec)
    assert rec.dtype == ref_rec.dtype == np.float64 and rec.shape == (80,)
    np.testing.assert_allclose(rec, ref_rec, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(conf, ref)
    assert conf.dtype == np.float32 and (conf == 0).sum() == 80 // 4
    assert set(np.argsort(-rec)[:20]) == set(np.flatnonzero(conf == 0))


def test_train_all_step_with_a_gan_bank_matches_jax(monkeypatch):
    """One fp64 ``train_all`` step (the set-up of test_torch_port_joint.py)
    with a GAN bank of 8 live unit rows (of 256) and weights with zeros: the
    losses within 1e-9 relative, the encoder's, G's and D's gradients within
    1e-9 of their norms, the parameters within 1e-10, and the bank and the
    GAN bank, which folds the pooled GAN map, within 1e-10."""
    from test_torch_port_joint import D, K_PAD, NV

    rng = np.random.RandomState(23)
    gan_bank = rng.randn(NV, D)
    gan_bank /= np.linalg.norm(gan_bank, axis=1, keepdims=True)
    s = joint_setup(monkeypatch, gan_bank=gan_bank)
    before = s.state.memory.gan_features.clone()
    batch, conf = _batch(41)
    conf[::3] = 0.0
    train_all_step_matches_jax(s, 0, 33, batch, conf)
    moved = (s.state.memory.gan_features - before).abs().amax(dim=1)
    assert s.state.memory.gan_features.shape == (K_PAD, D)
    assert torch.equal(moved > 0, torch.isin(torch.arange(K_PAD),
                                             torch.from_numpy(batch["pid"]).long()))


def test_synthesize_mix_p_matches_jax():
    """The pose generator (16x8, eval mode) on 8 batch features and 5 extra
    ones, the extra ones rendered in poses drawn from the batch by JAX's
    ``randint`` on the same key and fed in: both outputs within 1e-9 in
    fp64, the batch's images differentiable and the extra ones detached."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    jgan = jax_gan()
    G, _ = gan_variables(jgan, 80)
    rng = np.random.RandomState(81)
    f_gan, f_ex = rng.randn(8, 2, 1, 512), rng.randn(5, 2, 1, 512)
    pose = rng.rand(8, GH, GW, 18)
    key = jax.random.PRNGKey(82)
    with jax.enable_x64(True):
        ref, ref_ex = jgan.synthesize_mix_p(_to64(G), key, jnp.asarray(f_gan),
                                            jnp.asarray(f_ex), jnp.asarray(pose))
        p_idx = np.asarray(jax.random.randint(key, (5,), 0, 8))

    gan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, reid_feat_dim=512, device="cpu")
    gan.net_G.double().load_state_dict(state_dict_from_jax(gan.net_G, G["params"],
                                                           G["batch_stats"]))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    syn, syn_ex = gan.synthesize_mix_p(nchw(f_gan), nchw(f_ex), nchw(pose),
                                       torch.from_numpy(p_idx.copy()))
    assert syn.requires_grad and not syn_ex.requires_grad
    np.testing.assert_allclose(syn.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(syn_ex.permute(0, 2, 3, 1).numpy(), np.asarray(ref_ex),
                               rtol=0, atol=1e-9)


def test_train_gan_usl_clusters_with_gan_features(tmp_path, monkeypatch, capsys):
    """Two epochs of ``cli/train_gan_usl --cluster-with-gan-features
    --device cpu`` (resnet18 at 64x32, the pose generator at 32x16, 4 steps
    an epoch): each epoch's bank has a GAN half as large as the main one,
    with its live rows unit vectors that the steps then move; the
    confidence weights are computed in epoch 1 only, 1 with the worst
    quarter 0; and the checkpoints and the GAN nets' files are written."""
    from reid_gan_torch.cli import train_gan_usl

    banks, confs = [], []
    cluster = train_gan_usl.cluster_epoch
    conf_weight = train_gan_usl.compute_conf_weight

    def clustered(*args, **kwargs):
        out = cluster(*args, **kwargs)
        banks.append((out[0], out[0].gan_features.clone()))
        return out

    def weighed(*args, **kwargs):
        confs.append((len(banks), conf_weight(*args, **kwargs)))
        return confs[-1][1]

    monkeypatch.setattr(train_gan_usl, "cluster_epoch", clustered)
    monkeypatch.setattr(train_gan_usl, "compute_conf_weight", weighed)
    logs, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    best = train_gan_usl.main(_FLAGS + _GAN + [
        "--data-dir", str(tmp_path), "--cluster-with-gan-features", "--epochs", "2",
        "--iters", "4", "--eval-step", "1", "--logs-dir", str(logs), "--save-dir",
        str(ckpt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert 0.0 <= best <= 1.0 and "calculate confidence weight cost time" in out
    assert len(banks) == 2 and [epoch for epoch, _ in confs] == [2]
    conf = confs[0][1]
    assert set(np.unique(conf)) == {0.0, 1.0} and (conf == 0).sum() == len(conf) // 4
    for memory, start in banks:
        k = int(memory.num_valid)
        assert memory.gan_features.shape == memory.features.shape and k >= 2
        np.testing.assert_allclose(start[:k].norm(dim=1).numpy(), 1.0, atol=1e-5)
        assert not torch.equal(memory.gan_features, start)
        assert torch.count_nonzero(memory.gan_features[k:]) == 0
    for f in ("checkpoint.pth.tar", "model_best.pth.tar"):
        assert osp.exists(logs / f), f
    assert osp.exists(ckpt / "experiment" / "latest_net_G.pth")
