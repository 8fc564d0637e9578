"""``--fp16`` through the three training CLIs on the CPU, on the synthetic
dataset (resnet18 at 64x32, the GAN at 32x16): ``cli/train_usl``;
``cli/train_gan_usl`` in its three modes (``train_reid`` in the warm-up
epoch, ``train_all`` with ``--use-vgg`` and ``--cluster-with-gan-features``,
and the hard-mix ``train`` from the nets of a ``--fp16``
``cli/train_gan_warmup``). Each run ends; the encoder and the GAN nets
compute in bf16 with fp32 parameters, VGG19 in fp32; the checkpoints hold
fp32 weights."""

import os.path as osp

import torch

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_resume import capture
from test_torch_port_usl import _FLAGS

_GAN = ["--model", "AE", "--gan-height", "32", "--gan-width", "16"]


def _assert_bf16(net):
    """Every convolution and dense layer of ``net`` computes in bf16; its
    parameters are fp32."""
    from reid_gan_torch.models.precision import _Compute

    assert {m.compute_dtype for m in net.modules() if isinstance(m, _Compute)} == \
        {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_train_usl_fp16_epoch(tmp_path, monkeypatch):
    from reid_gan_torch.cli import train_usl

    made = capture(monkeypatch, train_usl, "create_model")
    logs = tmp_path / "logs"
    best = train_usl.main(_FLAGS + ["--data-dir", str(tmp_path), "--eval-step", "1", "--debug",
                                    "--fp16", "--logs-dir", str(logs), "--device", "cpu"])
    assert 0.0 <= best <= 1.0
    _assert_bf16(made[0])
    with open(logs / "log.txt") as f:
        log = f.read()
    assert "Clustered into" in log and "Test with the best model" in log
    sd = torch.load(logs / "model_best.pth.tar", weights_only=True)["state_dict"]
    assert sd["conv1.weight"].dtype == torch.float32


def test_train_gan_usl_fp16_reid_joint_vgg_and_gan_features(tmp_path, monkeypatch):
    """Epoch 0 ``train_reid`` (``--warmup-epo 1``), epochs 1-2 ``train_all``
    with the VGG19 loss and the GAN-feature clustering (its confidence
    weights in epoch 2)."""
    from reid_gan_torch.cli import train_gan_usl

    gans = capture(monkeypatch, train_gan_usl, "create_gan")
    models = capture(monkeypatch, train_gan_usl, "create_model")
    logs = tmp_path / "logs"
    best = train_gan_usl.main(_FLAGS + _GAN + [
        "--model-gen", "Pose", "--data-dir", str(tmp_path), "--eval-step", "1", "--fp16",
        "--use-vgg", "--cluster-with-gan-features", "--warmup-epo", "1", "--epochs", "3",
        "--iters", "2", "--save-dir", str(tmp_path / "ckpt"), "--logs-dir", str(logs),
        "--device", "cpu"])
    assert 0.0 <= best <= 1.0
    _assert_bf16(models[0])
    gan = gans[0]
    for net in (gan.net_G, gan.net_D):
        _assert_bf16(net)
    assert all(p.dtype == torch.float32 for p in gan.vgg.parameters())
    with open(logs / "log.txt") as f:
        log = f.read()
    assert "calculate confidence weight cost time" in log
    assert log.count("Clustered into") == 3 and "(epoch: 2, iters: 2" in log
    g = torch.load(tmp_path / "ckpt" / "experiment" / "latest_net_G.pth", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64) for v in g.values())


def test_warmup_then_hardmix_fp16(tmp_path, monkeypatch):
    """``cli/train_gan_warmup --fp16`` trains the AE nets in bf16; the
    hard-mix ``train`` mode (``--no-gan-train --continue-train --fp16``)
    loads them and runs its epoch."""
    from reid_gan_torch.cli import train_gan_usl, train_gan_warmup

    made = capture(monkeypatch, train_gan_warmup, "create_gan")
    common = ["--dataset", "synthetic", "--data-dir", str(tmp_path), "--batch-size", "16",
              "--workers", "2", "--debug", "--model-gen", "AE", "--fp16",
              "--save-dir", str(tmp_path / "ae"), "--device", "cpu"] + _GAN
    train_gan_warmup.main(common + ["--logs-dir", str(tmp_path / "w")])
    for net in (made[0].net_G, made[0].net_D):
        _assert_bf16(net)
    assert osp.exists(tmp_path / "ae" / "experiment" / "latest_net_G.pth")

    gans = capture(monkeypatch, train_gan_usl, "create_gan")
    best = train_gan_usl.main(_FLAGS + common[4:] + [
        "--data-dir", str(tmp_path), "--no-gan-train", "--continue-train", "--eval-step", "1",
        "--logs-dir", str(tmp_path / "h")])
    assert 0.0 <= best <= 1.0
    _assert_bf16(gans[0].net_G)
    with open(tmp_path / "h" / "log.txt") as f:
        log = f.read()
    assert "latest_net_G.pth" in log and "Clustered into" in log, log
