"""``cli/train_gan_usl`` end to end on the CPU on the synthetic dataset
(resnet18 at 64x32, the pose generator at 32x16): the checkpoints, the GAN
nets' ``latest`` files and ``iter.txt``, ``--continue-train`` from them, the
per-net save/load round trip, and the pairings the joint modes cannot
run."""

import os.path as osp

import pytest
import torch

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_usl import _FLAGS

_GAN = ["--model", "AE", "--model-gen", "Pose", "--gan-height", "32", "--gan-width", "16"]


def test_train_gan_usl_end_to_end_and_continue_train(tmp_path, capsys):
    """``--debug --device cpu`` runs one joint epoch and writes
    ``checkpoint.pth.tar``, ``model_best.pth.tar``, ``log.txt``,
    ``loss_log.txt``, a ``train_opt.txt`` equal to JAX's for the
    same flags (every section), ``latest_net_G.pth``,
    ``latest_net_D.pth`` and ``iter.txt`` = ``1,0``; ``--continue-train``
    then resumes at epoch 1 from them and runs the second epoch."""
    from reid_gan_torch.cli.train_gan_usl import main
    from torch_port_opts import assert_options_match_jax

    logs, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    flags = _FLAGS + _GAN + ["--data-dir", str(tmp_path), "--eval-step", "1",
                             "--save-dir", str(ckpt)]
    best = main(flags + ["--debug", "--logs-dir", str(logs), "--device", "cpu"])
    out = capsys.readouterr().out
    assert 0.0 <= best <= 1.0
    for f in ("checkpoint.pth.tar", "model_best.pth.tar", "log.txt", "loss_log.txt",
              "train_opt.txt"):
        assert osp.exists(logs / f), f
    nets = ckpt / "experiment"
    for f in ("latest_net_G.pth", "latest_net_D.pth"):
        assert osp.exists(nets / f), f
    with open(nets / "iter.txt") as fh:
        assert fh.read().strip() == "1,0"
    assert "Clustered into" in out and "model [AEModel] was created" in out
    assert "(epoch: 0, iters: 8" in out and "Test with the best model" in out
    with open(logs / "loss_log.txt") as fh:
        line = fh.read().splitlines()[-1]
    assert all(f"{k}: " in line for k in ("loss", "loss_cl", "G", "D"))

    assert_options_match_jax("train_gan_usl", logs / "train_opt.txt",
                             flags + ["--debug", "--logs-dir", str(logs)])

    saved_g = torch.load(nets / "latest_net_G.pth", weights_only=True)
    main(flags + ["--continue-train", "--epochs", "2", "--iters", "2",
                  "--logs-dir", str(tmp_path / "again"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Resuming from epoch 1" in out and "(epoch: 1, iters: 2" in out
    assert "(epoch: 0," not in out
    with open(nets / "iter.txt") as fh:
        assert fh.read().strip() == "2,0"
    resumed_g = torch.load(nets / "latest_net_G.pth", weights_only=True)
    assert set(resumed_g) == set(saved_g)
    assert any(not torch.equal(resumed_g[k], saved_g[k]) for k in saved_g)


def test_save_and_load_networks_round_trip(tmp_path, capsys):
    """``save_networks`` writes ``{epoch}_net_{name}.pth``; ``load_networks``
    restores parameters and buffers (BN running stats, spectral u/sigma)
    in place, and keeps a net whose file is missing."""
    from reid_gan_torch.models.dual_gan.networks import define_D, define_G
    from reid_gan_torch.utils.serialization import load_networks, save_networks

    torch.manual_seed(0)
    g, d = define_G("Pose", ngf=8, img_f=32, reid_nc=16), define_D()
    save_networks({"G": g, "D": d}, str(tmp_path), "latest")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["latest_net_D.pth",
                                                          "latest_net_G.pth"]
    torch.manual_seed(1)
    g2, d2, other = define_G("Pose", ngf=8, img_f=32, reid_nc=16), define_D(), define_D()
    before = {k: v.clone() for k, v in other.state_dict().items()}
    load_networks({"G": g2, "D": d2, "X": other}, str(tmp_path), "latest")
    assert "no checkpoint for net 'X'" in capsys.readouterr().out
    for a, b in ((g, g2), (d, d2)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in before.items())
    assert "block0.conv1.u" in d2.state_dict() and "block0.norm1.running_var" in \
        g2.state_dict()


@pytest.mark.parametrize("flag,item", [
    (["--bipath", "--arch", "resnet_bip50", "--model-gen", "Pose"],
     "--bipath with --model-gen Pose"),
    (["--bipath", "--arch", "resnet50", "--model-gen", "AE"], "--bipath with --arch resnet50"),
    (["--bipath", "--arch", "resnet_bip50", "--model-gen", "AE",
      "--cluster-with-gan-features"], "--bipath with --cluster-with-gan-features"),
    (["--learnable-memory", "--model-gen", "AE"],
     "--model-gen AE with the GAN trained jointly: the 'train_all_with_memory' mode"),
    (["--model-gen", "DEC", "--dataset", "synthetic"], "--model-gen DEC with the GAN trained"),
    (["--model-gen", "FD", "--dataset", "synthetic"], "--model-gen FD with the GAN trained"),
    (["--model-gen", "PoseAE", "--dataset", "synthetic"],
     "--model-gen PoseAE with the GAN trained")])
def test_unported_options_raise(tmp_path, flag, item):
    """The pairings the joint modes cannot run raise ``ValueError`` before
    any work, as the JAX step fails on them: ``--bipath`` with the pose
    generator (``apply_G(G, xs)`` passes no pose, JAX gan_trainers.py:423),
    with an encoder other than ``ResNetBip`` (``fuse=False``, :413-416) or
    with GAN-feature clustering (the bi-path encoder has no ``test_all``
    forward, evaluators.py:49); ``--learnable-memory`` with the AE generator
    (``synthesize_p``, :334); the DEC, FD and PoseAE generators with the GAN
    trained jointly (``train_all`` renders with the pose generator)."""
    from reid_gan_torch.cli.train_gan_usl import main

    with pytest.raises(ValueError, match=item):
        main(["--device", "cpu", "--data-dir", str(tmp_path), "--logs-dir",
              str(tmp_path / "logs")] + flag)
    assert not (tmp_path / "logs").exists()


class _Stop(Exception):
    pass


def _stub_gan(monkeypatch, seen):
    """``create_gan`` of ``cli/train_gan_usl`` replaced by a stub that keeps
    its ``dtype`` and returns a GAN engine with nothing to load."""
    import types

    from reid_gan_torch.cli import train_gan_usl

    def create_gan(*args, dtype=None, **kwargs):
        seen["gan"] = dtype
        return types.SimpleNamespace(init_state=lambda: None)

    monkeypatch.setattr(train_gan_usl, "create_gan", create_gan)


@pytest.mark.parametrize("flag,dtype", [(["--fp16"], torch.bfloat16), ([], None)])
def test_fp16_reaches_the_encoder_and_the_gan(monkeypatch, flag, dtype):
    """``--fp16`` builds both the GAN engine and the encoder with the bf16
    compute dtype (JAX ``train_gan_usl.py:101,122``); without it, neither."""
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.config import parse_config

    seen = {}
    _stub_gan(monkeypatch, seen)

    def create_model(*args, dtype=None, **kwargs):
        seen["encoder"] = dtype
        raise _Stop

    monkeypatch.setattr(train_gan_usl, "create_model", create_model)
    cfg = parse_config(_GAN + flag, sections=train_gan_usl.SECTIONS)
    with pytest.raises(_Stop):
        train_gan_usl.run(cfg, None, "cpu")
    assert seen == {"gan": dtype, "encoder": dtype}


def test_msgpack_resume_with_a_missing_key_raises(monkeypatch, tmp_path):
    """``--resume`` of a JAX ``.msgpack`` whose tree lacks a leaf of the
    encoder raises ``ValueError`` naming it, as flax's ``from_state_dict``
    does, before any training."""
    import numpy as np

    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.utils.serialization import save_msgpack_checkpoint

    tree = dict(flax_variables_from_model(create("resnet18")), epoch=np.asarray(3))
    del tree["params"]["base"]["layer2_1"]["conv1"]
    path = str(tmp_path / "checkpoint.msgpack")
    save_msgpack_checkpoint(tree, False, path)
    _stub_gan(monkeypatch, {})
    cfg = parse_config(_GAN + ["-a", "resnet18", "--resume", path],
                       sections=train_gan_usl.SECTIONS)
    with pytest.raises(ValueError, match="missing.*layer2.1.conv1"):
        train_gan_usl.run(cfg, None, "cpu")


def test_train_gan_usl_refuses_the_cpu_unless_asked(monkeypatch):
    from reid_gan_torch.cli.train_gan_usl import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--data-dir", "/nonexistent"])
