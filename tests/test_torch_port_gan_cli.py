"""``cli/train_gan_usl`` end to end on the CPU on the synthetic dataset
(resnet18 at 64x32, the pose generator at 32x16): the checkpoints, the GAN
nets' ``latest`` files and ``iter.txt``, ``--continue-train`` from them, the
per-net save/load round trip, and the options that are not ported yet."""

import os.path as osp

import pytest
import torch

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_usl import _FLAGS

_GAN = ["--model", "AE", "--model-gen", "Pose", "--gan-height", "32", "--gan-width", "16"]


def test_train_gan_usl_end_to_end_and_continue_train(tmp_path, capsys):
    """``--debug --device cpu`` runs one joint epoch and writes
    ``checkpoint.pth.tar``, ``model_best.pth.tar``, ``log.txt``,
    ``loss_log.txt``, a ``train_opt.txt`` whose lines are JAX's for the
    same flags (its FD-GAN section aside), ``latest_net_G.pth``,
    ``latest_net_D.pth`` and ``iter.txt`` = ``1,0``; ``--continue-train``
    then resumes at epoch 1 from them and runs the second epoch."""
    from reid_gan_tpu.config import dump_config as jax_dump
    from reid_gan_tpu.config import parse_config as jax_parse
    from reid_gan_torch.cli.train_gan_usl import main

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

    jax_dump(jax_parse(flags + ["--debug", "--logs-dir", str(logs)],
                       sections=("data", "model", "optim", "cluster", "train", "gan")),
             str(tmp_path / "jax"))
    with open(tmp_path / "jax" / "train_opt.txt") as fh:
        ref = [ln for ln in fh.read().splitlines() if not ln.startswith("fdgan.")]
    with open(logs / "train_opt.txt") as fh:
        got = fh.read().splitlines()
    assert got == ref and sum(ln.startswith("gan.") for ln in got) > 20

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
    (["--cluster-with-gan-features"], "ROADMAP A: GAN-feature clustering"),
    (["--bipath"], "ROADMAP A: bip and learnable-memory modes"),
    (["--learnable-memory"], "ROADMAP A: bip and learnable-memory modes"),
    (["--no-gan-train", "--cluster-with-gan-features"], "ROADMAP A: GAN-feature clustering"),
    (["--fp16"], "ROADMAP A: `--fp16`"),
    (["--resume", "logs/checkpoint.msgpack"], "ROADMAP A: msgpack checkpoints"),
    (["--model-gen", "DEC", "--dataset", "synthetic"], "ROADMAP A: other generators and DPTN")])
def test_unported_options_raise(tmp_path, flag, item):
    from reid_gan_torch.cli.train_gan_usl import main

    with pytest.raises(NotImplementedError, match=item):
        main(["--device", "cpu", "--data-dir", str(tmp_path), "--logs-dir",
              str(tmp_path / "logs")] + flag)


def test_train_gan_usl_refuses_the_cpu_unless_asked(monkeypatch):
    from reid_gan_torch.cli.train_gan_usl import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--data-dir", "/nonexistent"])
