"""The data mesh through ``cli/train_gan_usl``'s hard-mix, bip,
learnable-memory and WGAN-GP modes and through ``cli/train_gan_warmup``,
each with ``--debug`` on two gloo ranks (``torch_mesh_ranks.spawn``, every
case in one spawn) against one process (``mesh=False``) on the same
synthetic set: the same pseudo-label counts and best mAP within 1e-4 (the
joint CLI), the same logged losses and the same tensors in the saved nets
(the warm-up), and every file written by rank 0 alone."""

import glob
import os.path as osp
import re

import numpy as np
import pytest
import torch

from test_torch_port_ddp import _FLAGS
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from torch_mesh_ranks import spawn

_GAN = ["--model", "AE", "--gan-height", "32", "--gan-width", "16", "--device", "cpu"]
JOINT = {
    "no_gan_train": ["--model-gen", "AE", "--no-gan-train"],
    "bipath": ["--model-gen", "AE", "--bipath", "--arch", "resnet_bip50"],
    "learnable_memory": ["--model-gen", "Pose", "--learnable-memory"],
    # the penalty's draws differ from one process's (global generator there,
    # the step's on a mesh) but reach D only, not the encoder, which the mAP
    # reads
    "wgangp": ["--model-gen", "Pose", "--gan-mode", "wgangp"],
}


def _writers(out_dir):
    return sorted(osp.basename(p) for p in glob.glob(osp.join(str(out_dir), "*.rank*")))


def _clusters(path):
    with open(path) as fh:
        return re.findall(r"Clustered into (\d+) classes", fh.read())


def _warmup_flags(root):
    return ["--dataset", "synthetic", "--data-dir", str(root / "d"), "--batch-size", "16",
            "--workers", "1", "--debug", "--model-gen", "AE"] + _GAN


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case's run on two ranks, all in one spawn
    (``torch_mesh_ranks.each``): each joint mode's and the warm-up's, under
    ``<root>/<case>`` (its set ``d``, logs ``two``, nets ``two_ckpt`` and
    the writers' record ``writes``). Returns the root and each case's
    result."""
    import torch_mesh_ranks

    root = tmp_path_factory.mktemp("cli")
    runs = []
    for case in list(JOINT) + ["warmup"]:
        (root / case / "writes").mkdir(parents=True)
        flags = _warmup_flags(root / case) if case == "warmup" else \
            _FLAGS + _GAN + JOINT[case] + ["--data-dir", str(root / case / "d")]
        runs.append(("train_gan_warmup" if case == "warmup" else "train_gan_usl",
                     flags + ["--logs-dir", str(root / case / "two"), "--save-dir",
                              str(root / case / "two_ckpt")], str(root / case / "writes")))
    got = spawn(torch_mesh_ranks.each, 2, root, torch_mesh_ranks.cli_main_bip18, runs)
    return root, dict(zip(list(JOINT) + ["warmup"], got))


@pytest.mark.parametrize("case", list(JOINT))
def test_joint_mode_on_two_ranks_matches_one_process(monkeypatch, two_ranks, case):
    """``cli/train_gan_usl`` in the mode of ``case`` on two ranks against
    one process: the best mAP within 1e-4, the same pseudo-label counts;
    rank 0 alone opens the log, writes the options and the checkpoints and,
    where the mode trains the GAN, its nets and ``iter.txt``. ``--bipath``
    builds ``resnet_bip50`` at depth 18 on both sides."""
    from test_torch_port_bip_memory import _bip18
    from reid_gan_torch.cli.train_gan_usl import main

    _bip18(monkeypatch)
    root, got = two_ranks
    tmp_path = root / case
    flags = _FLAGS + _GAN + JOINT[case] + ["--data-dir", str(tmp_path / "d")]
    ref = main(flags + ["--logs-dir", str(tmp_path / "one"), "--save-dir",
                        str(tmp_path / "one_ckpt")], mesh=False)
    out = tmp_path / "writes"
    logs, ckpt = tmp_path / "two", tmp_path / "two_ckpt"
    best = got[case]
    assert abs(best - ref) <= 1e-4
    trains_gan = case != "no_gan_train"
    assert _writers(out) == ["Logger.rank0", "Visualizer.rank0", "dump_config.rank0",
                             "save_checkpoint.rank0"] + \
        (["save_networks.rank0"] if trains_gan else [])
    for f in ("latest_net_G.pth", "latest_net_D.pth", "iter.txt"):
        assert osp.exists(ckpt / "experiment" / f) == trains_gan, f
    assert _clusters(logs / "log.txt") == _clusters(tmp_path / "one" / "log.txt") != []
    with open(logs / "log.txt") as fh:
        assert "Test with the best model" in fh.read()


def test_warmup_on_two_ranks_matches_one_process(two_ranks):
    """``cli/train_gan_warmup --debug`` (4 D→G iterations of batch 16, 8 rows
    a rank) on two ranks against one process: the same step count, the same
    losses in ``loss_log.txt`` (printed to 3 decimals), and saved nets with
    the same tensors, finite; rank 0 alone opens the log, writes the
    options, the loss log and the nets. The nets are not held element by
    element: in fp32 the global BatchNorm rounds otherwise than the one-card
    BatchNorm (a mesh of one rank differs from one process as much), and
    Adam steps each weight by about its learning rate whatever the size of
    its gradient, so the weights whose gradients are near zero part by up to
    a few learning rates in 4 steps. The fp64 step against JAX's mesh step
    (test_torch_port_ddp_gan.py) holds their math."""
    from reid_gan_torch.cli.train_gan_warmup import main

    root, got = two_ranks
    tmp_path = root / "warmup"
    flags = _warmup_flags(tmp_path)
    state = main(flags + ["--logs-dir", str(tmp_path / "one"), "--save-dir",
                          str(tmp_path / "one_ckpt")], mesh=False)
    out = tmp_path / "writes"
    logs, ckpt = tmp_path / "two", tmp_path / "two_ckpt"
    steps = got["warmup"]
    assert steps == state.step == 4
    assert _writers(out) == ["Logger.rank0", "Visualizer.rank0", "dump_config.rank0",
                             "save_networks.rank0"]

    def losses(path):
        with open(path) as fh:
            return re.findall(r"(\w+): (-?[\d.]+)", fh.read().splitlines()[-1])

    got = losses(logs / "loss_log.txt")
    assert got == losses(tmp_path / "one" / "loss_log.txt")
    assert {k for k, _ in got} >= {"G", "D"}
    assert np.isfinite([float(v) for _, v in got]).all()
    for net in ("G", "D"):
        a = torch.load(ckpt / "experiment" / f"latest_net_{net}.pth", weights_only=True)
        b = torch.load(tmp_path / "one_ckpt" / "experiment" / f"latest_net_{net}.pth",
                       weights_only=True)
        assert set(a) == set(b), net
        for k, v in b.items():
            assert a[k].shape == v.shape and a[k].dtype == v.dtype, (net, k)
            assert bool(torch.isfinite(a[k].double()).all()), (net, k)
