"""Port parity for resuming from the JAX CLIs' msgpack checkpoints, the
re-ID loops and the GAN warm-up: the JAX ``cli/train_usl``,
``cli/train_gan_usl`` and ``cli/train_gan_warmup`` each run one ``--debug``
epoch (resnet18 at 64x32, the pose and AE generators at 32x16) and write
their flax msgpack files; the port's CLIs resume from them with the JAX
epoch counter and state dicts bit-equal to the trees the files hold
(decoded by flax, converted by the port's converters), and the port's
``cli/test --resume`` of the JAX checkpoint gives the JAX CLI's CMC and mAP
within 1e-4."""

import os.path as osp
import sys

import torch

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_usl import _FLAGS

_GAN = ["--model", "AE", "--model-gen", "Pose", "--gan-height", "32", "--gan-width", "16"]


def flax_tree(path):
    """The file's tree as flax decodes it, numpy leaves."""
    from flax import serialization as flax_ser

    with open(path, "rb") as f:
        return flax_ser.msgpack_restore(f.read())


def assert_loaded(net, tree):
    """``net``'s state dict equals the port's conversion of the flax tree
    ``tree`` (``{"params", "batch_stats"}``), bit for bit."""
    from reid_gan_torch.models.convert import state_dict_from_flax

    ref = state_dict_from_flax(net, tree)
    got = net.state_dict()
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k].cpu(), v), k


def capture(monkeypatch, module, name):
    """Wrap ``module.name`` (a factory) so the objects it makes are kept."""
    made = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(module, name, wrapped)
    return made


def test_train_usl_resumes_from_the_jax_cli_and_evaluates_alike(tmp_path, monkeypatch):
    """``cli/train_usl --resume checkpoint.msgpack``: the JAX epoch counter
    (1, so the one ``--debug`` epoch is done and nothing trains) and the
    weights; then ``cli/test --resume`` of the same file within 1e-4 of the
    JAX eval CLI."""
    from reid_gan_tpu.cli.test import main as jax_test
    from reid_gan_tpu.cli.train_usl import main as jax_main
    from reid_gan_torch.cli import train_usl
    from reid_gan_torch.cli.test import main as torch_test

    data = ["--data-dir", str(tmp_path)]
    jax_main(_FLAGS + data + ["--eval-step", "1", "--debug", "--logs-dir",
                              str(tmp_path / "jax")], mesh=False)
    sys.stdout = sys.__stdout__
    ckpt = str(tmp_path / "jax" / "checkpoint.msgpack")
    tree = flax_tree(ckpt)
    assert int(tree["epoch"]) == 1

    made = capture(monkeypatch, train_usl, "create_model")
    best = train_usl.main(_FLAGS + data + ["--debug", "--resume", ckpt, "--logs-dir",
                                           str(tmp_path / "port"), "--device", "cpu"])
    assert best == 0.0
    assert_loaded(made[0], tree)
    with open(tmp_path / "port" / "log.txt") as f:
        log = f.read()
    assert f"=> Resumed from epoch 1 (best mAP {float(tree['best_mAP']):.1%})" in log
    assert "Clustered into" not in log

    args = _FLAGS + data + ["--batch-size", "64", "--resume", ckpt]
    ref_cmc, ref_map = jax_test(args, mesh=False)
    sys.stdout = sys.__stdout__
    cmc, mAP = torch_test(args + ["--device", "cpu"])
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4


def test_train_gan_usl_resumes_the_jax_encoder_and_gan_nets(tmp_path, monkeypatch):
    """``cli/train_gan_usl --continue-train --resume checkpoint.msgpack``
    after the JAX joint epoch: G and D from ``latest_net_{G,D}.msgpack``,
    the encoder from the checkpoint, the epoch counter the later of
    ``iter.txt``'s and the checkpoint's (1), as train_gan_usl.py:106-133."""
    from reid_gan_tpu.cli.train_gan_usl import main as jax_main
    from reid_gan_torch.cli import train_gan_usl

    ckpt_dir = str(tmp_path / "ckpt")
    flags = _FLAGS + _GAN + ["--data-dir", str(tmp_path), "--eval-step", "1", "--debug",
                             "--save-dir", ckpt_dir]
    jax_main(flags + ["--logs-dir", str(tmp_path / "jax")], mesh=False)
    sys.stdout = sys.__stdout__
    nets = osp.join(ckpt_dir, "experiment")
    ckpt = str(tmp_path / "jax" / "checkpoint.msgpack")
    with open(osp.join(nets, "iter.txt")) as f:
        assert f.read().strip() == "1,0"

    gans = capture(monkeypatch, train_gan_usl, "create_gan")
    models = capture(monkeypatch, train_gan_usl, "create_model")
    train_gan_usl.main(flags + ["--continue-train", "--resume", ckpt, "--logs-dir",
                                str(tmp_path / "port"), "--device", "cpu"])
    assert_loaded(models[0], flax_tree(ckpt))
    assert_loaded(gans[0].net_G, flax_tree(osp.join(nets, "latest_net_G.msgpack")))
    assert_loaded(gans[0].net_D, flax_tree(osp.join(nets, "latest_net_D.msgpack")))
    with open(tmp_path / "port" / "log.txt") as f:
        log = f.read()
    assert "Resuming from epoch 1" in log and "Clustered into" not in log


def snapshot_loads(monkeypatch, module):
    """Wrap ``module.load_networks`` so each call's nets are copied (state
    dicts on the CPU) right after they load."""
    loaded = []
    real = module.load_networks

    def wrapped(nets, save_dir, which_epoch):
        out = real(nets, save_dir, which_epoch)
        loaded.append({name: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                       for name, net in nets.items()})
        return out

    monkeypatch.setattr(module, "load_networks", wrapped)
    return loaded


def assert_snapshot(net, sd, tree):
    """A state dict ``sd`` taken from ``net`` equals the conversion of
    ``tree``, bit for bit."""
    from reid_gan_torch.models.convert import state_dict_from_flax

    ref = state_dict_from_flax(net, tree)
    assert sorted(ref) == sorted(sd)
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k


def test_warmup_continues_from_the_jax_nets(tmp_path, monkeypatch):
    """``cli/train_gan_warmup --continue-train`` from the JAX warm-up's
    ``latest_net_{G,D}.msgpack`` (train_gan_warmup.py:49-53), then trains
    and writes the port's ``.pth`` files beside them."""
    from reid_gan_tpu.cli.train_gan_warmup import main as jax_main
    from reid_gan_torch.cli import train_gan_warmup

    flags = ["--dataset", "synthetic", "--data-dir", str(tmp_path), "--batch-size", "16",
             "--workers", "2", "--debug", "--model", "AE", "--model-gen", "AE",
             "--gan-height", "32", "--gan-width", "16", "--save-dir", str(tmp_path / "ae")]
    jax_main(flags + ["--logs-dir", str(tmp_path / "jax")], mesh=False)
    sys.stdout = sys.__stdout__
    nets = str(tmp_path / "ae" / "experiment")
    loaded = snapshot_loads(monkeypatch, train_gan_warmup)
    gans = capture(monkeypatch, train_gan_warmup, "create_gan")
    train_gan_warmup.main(flags + ["--continue-train", "--logs-dir", str(tmp_path / "port"),
                                   "--device", "cpu"])
    for name, net in (("G", gans[0].net_G), ("D", gans[0].net_D)):
        assert_snapshot(net, loaded[0][name],
                        flax_tree(osp.join(nets, f"latest_net_{name}.msgpack")))
        assert osp.exists(osp.join(nets, f"latest_net_{name}.pth"))
