"""Port parity for resuming from the JAX CLIs' msgpack checkpoints, FD-GAN:
the JAX ``cli/fdgan_baseline`` and ``cli/fdgan_train --stage 1`` each run
``--debug`` and write their flax msgpack files; the port loads them where
its CLIs do (``--continue-train``, ``--resume``, ``--netE-pretrain`` with Di
from E, stage III's ``--net*-pretrain``), each net's state dict bit-equal
to the converted tree the file holds."""

import os.path as osp
import sys

import torch

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_resume import assert_loaded, assert_snapshot, capture, flax_tree, \
    snapshot_loads

_FD = ["--dataset", "synthetic", "--height", "64", "--width", "32", "-b", "8",
       "--workers", "2", "--debug"]


def test_fdgan_chain_loads_the_jax_checkpoints(tmp_path, monkeypatch):
    """The JAX baseline's ``checkpoint.msgpack`` (the Siamese variables):
    ``cli/fdgan_baseline --resume --evaluate`` loads it, and stage 1's
    ``--netE-pretrain`` loads it into E and Di (the verifier's positive row,
    model.py:157-182). The JAX stage 1's ``latest_net_{E,G,Di,Dp}.msgpack``:
    ``cli/fdgan_train --continue-train`` and stage III's
    ``--net*-pretrain`` load each net."""
    from reid_gan_tpu.cli.fdgan_baseline import main as jax_baseline
    from reid_gan_tpu.cli.fdgan_train import main as jax_train
    from reid_gan_torch.cli import fdgan_baseline, fdgan_train
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.models.fdgan.model import FDGANModel
    from reid_gan_torch.models.multi_branch import siamese_net

    data = ["--data-dir", str(tmp_path)]
    jax_baseline(_FD + data + ["--logs-dir", str(tmp_path / "jb")], mesh=False)
    sys.stdout = sys.__stdout__
    base = str(tmp_path / "jb" / "checkpoint.msgpack")
    e_tree = flax_tree(base)

    models = capture(monkeypatch, fdgan_baseline, "siamese_baseline")
    fdgan_baseline.main(_FD + data + ["--resume", base, "--evaluate", "--logs-dir",
                                      str(tmp_path / "pb"), "--device", "cpu"])
    assert_loaded(models[0], e_tree)

    cfg = parse_config(["--stage", "1", "--netE-pretrain", base],
                       sections=("data", "model", "optim", "train", "gan", "fdgan"))
    model = FDGANModel(cfg.fdgan, height=64, width=32, depth=18, device="cpu")
    assert_loaded(model.net_E, e_tree)
    di = siamese_net(18, num_classes=1)
    di.load_state_dict(model._di_from_e(model.net_E.state_dict()))
    assert all(torch.equal(v, model.net_Di.state_dict()[k]) for k, v in di.state_dict().items())
    assert model.net_Di.embed_model.classifier.weight.shape == (1, 512)

    save = str(tmp_path / "fdc")
    stage1 = _FD + data + ["--stage", "1", "--netE-pretrain", base, "--save-dir", save]
    jax_train(stage1 + ["--logs-dir", str(tmp_path / "j1")], mesh=False)
    sys.stdout = sys.__stdout__
    nets = osp.join(save, "experiment")
    trees = {n: flax_tree(osp.join(nets, f"latest_net_{n}.msgpack"))
             for n in ("E", "G", "Di", "Dp")}

    loaded = snapshot_loads(monkeypatch, fdgan_train)
    made = capture(monkeypatch, fdgan_train, "FDGANModel")
    fdgan_train.main(stage1 + ["--continue-train", "--logs-dir", str(tmp_path / "p1"),
                               "--device", "cpu"])
    for name, net in made[0].nets().items():
        assert_snapshot(net, loaded[0][name], trees[name])

    paths = {n: osp.join(nets, f"latest_net_{n}.msgpack") for n in trees}
    cfg = parse_config(["--stage", "2", "--netE-pretrain", paths["E"], "--netG-pretrain",
                        paths["G"], "--netDi-pretrain", paths["Di"], "--netDp-pretrain",
                        paths["Dp"]], sections=("data", "model", "optim", "train", "gan",
                                                "fdgan"))
    model = FDGANModel(cfg.fdgan, height=64, width=32, depth=18, device="cpu")
    for name, net in model.nets().items():
        assert_loaded(net, trees[name])
