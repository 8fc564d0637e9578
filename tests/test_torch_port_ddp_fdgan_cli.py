"""The data mesh through FD-GAN's CLIs: ``cli/fdgan_baseline`` →
``cli/fdgan_train --stage 1`` → ``--stage 2``, each with ``--debug`` (depth
18, 2 steps of 8 pairs) on two gloo ranks (``torch_mesh_ranks.spawn``)
against the same chain in one process (``mesh=False``) on the same
synthetic set, and the ``fdgan_pose`` loader's draws on four ranks against
one process, by hand and through the FD CLIs' launch, under an unfixed hash
seed."""

import glob
import os.path as osp
import re

import numpy as np
import torch

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from torch_mesh_ranks import spawn

H, W = 64, 32


def _writers(out_dir):
    return sorted(osp.basename(p) for p in glob.glob(osp.join(str(out_dir), "*.rank*")))


def _losses(path):
    with open(path) as fh:
        return [(k, v) for k, v in re.findall(r"(\w+): (-?[\d.]+)", fh.read().splitlines()[-1])
                if k != "time"]


def _maps(path):
    with open(path) as fh:
        return [float(m) for m in re.findall(r"Mean AP: ([\d.]+)%", fh.read())]


def test_fdgan_chain_on_two_ranks_matches_one_process(tmp_path, monkeypatch):
    """Each stage from the same files (one process's previous stage's), one
    process on its own (``mesh=False``) and two ranks. The
    baseline's best mAP and every mAP it prints within 1e-4 (0.01
    points); its checkpoint's tensors each within 0.1 of their norm
    (relative L2): in fp32 the global BatchNorm rounds otherwise than the
    one-card BatchNorm, and at init the Siamese gradients are
    ill-conditioned, so SGD's two steps move a tensor by up to 1-7% apart
    where its norm is the move itself (a bias that starts at zero; a
    gradient summed in place of averaged is 100% apart there). The stages'
    losses in ``loss_log.txt`` (printed to 3 decimals) equal, and stage 2's
    printed mAPs; each net saved with the same keys, shapes and finite
    values (Adam steps each weight by about its learning rate whatever its
    gradient, as in test_torch_port_ddp_gan_cli.py). Rank 0 alone opens
    the logs, writes the options, the checkpoints, the images and the nets.
    The fp64 steps against JAX's mesh steps (test_torch_port_ddp_fdgan.py)
    hold their math."""
    import torch_mesh_ranks

    common = ["--dataset", "synthetic", "--data-dir", str(tmp_path / "d"), "--height",
              str(H), "--width", str(W), "-b", "8", "-j", "1", "--debug", "--device", "cpu"]

    def chain(root):
        # each stage starts from the files of one process's previous stage
        nets = one_root / "c1" / "experiment"
        return [("fdgan_baseline", common + ["--logs-dir", str(root / "base")]),
                ("fdgan_train", common + [
                    "--stage", "1", "--pose-aug", "gauss", "--logs-dir", str(root / "s1"),
                    "--save-dir", str(root / "c1"),
                    "--netE-pretrain", str(one_root / "base" / "model_best.pth.tar")]),
                ("fdgan_train", common + [
                    "--stage", "2", "--pose-aug", "erase", "--eval-step", "1",
                    "--logs-dir", str(root / "s2"), "--save-dir", str(root / "c2")] + sum(
                        ([f"--net{n}-pretrain", str(nets / f"latest_net_{n}.pth")]
                         for n in ("E", "G", "Di", "Dp")), []))]

    # every spawned process hashes strings with a seed of its own; both runs
    # draw the fdgan_pose targets in this process's order of each id's names,
    # as a launch passes it to its ranks (fdgan_baseline.run_main)
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    from reid_gan_torch.data.datasets import create

    order = {p: list(v) for p, v in create("synthetic", str(tmp_path / "d")).pid_imgs.items()}

    writes = tmp_path / "writes"
    writes.mkdir()
    one_root, two_root = tmp_path / "one", tmp_path / "two"
    # each chain's three runs in one spawn (torch_mesh_ranks.each)
    ref = spawn(torch_mesh_ranks.each, 1, tmp_path, torch_mesh_ranks.cli_alone,
                [(cli, argv, order) for cli, argv in chain(one_root)])
    got = spawn(torch_mesh_ranks.each, 2, tmp_path, torch_mesh_ranks.cli_main,
                [(cli, argv, str(writes), order) for cli, argv in chain(two_root)])
    assert got[1:] == ref[1:] == [2, 2]
    assert abs(got[0] - ref[0]) <= 1e-4 and 0.0 < ref[0] <= 1.0
    assert np.allclose(_maps(two_root / "base" / "log.txt"),
                       _maps(one_root / "base" / "log.txt"), rtol=0, atol=1e-2)
    a = torch.load(two_root / "base" / "checkpoint.pth.tar", weights_only=False)
    b = torch.load(one_root / "base" / "checkpoint.pth.tar", weights_only=False)
    assert a["epoch"] == b["epoch"] and set(a["state_dict"]) == set(b["state_dict"])
    for k, v in b["state_dict"].items():
        if v.is_floating_point():
            err = float((a["state_dict"][k] - v).norm())
            assert err <= 0.1 * float(v.norm()) + 1e-12, (k, err, float(v.norm()))
    assert _writers(writes) == ["Logger.rank0", "Visualizer.rank0", "dump_config.rank0",
                                "save_checkpoint.rank0", "save_networks.rank0"]
    for stage in ("s1", "s2"):
        got_l, ref_l = _losses(two_root / stage / "loss_log.txt"), \
            _losses(one_root / stage / "loss_log.txt")
        assert got_l == ref_l and {k for k, _ in got_l} >= {"G", "D_i", "D_p", "G_sp"}
        assert osp.exists(two_root / stage / "images" / "epoch000_fake.png")
    assert _maps(two_root / "s2" / "log.txt") == _maps(one_root / "s2" / "log.txt") != []
    for c, which in (("c1", "latest"), ("c2", "latest"), ("c2", "best")):
        for n in ("E", "G", "Di", "Dp"):
            name = f"{which}_net_{n}.pth"
            a = torch.load(two_root / c / "experiment" / name, weights_only=True)
            b = torch.load(one_root / c / "experiment" / name, weights_only=True)
            assert set(a) == set(b), (c, name)
            for k, v in b.items():
                assert a[k].shape == v.shape and a[k].dtype == v.dtype, (c, name, k)
                assert bool(torch.isfinite(a[k].double()).all()), (c, name, k)


def test_fdgan_pose_loader_draws_on_four_ranks_equal_one_process(tmp_path):
    """Three ``fdgan_pose`` batches of 8 pairs through ``DataLoader(shard=)``
    on each of four ranks: each rank's rows of both batches are one
    process's rows (the image, the target image drawn for it, its landmarks
    and flip), and every rank's ``rng`` ends where one process's does; a
    batch of 6 pairs, which four ranks do not split, raises ``ValueError``
    naming both numbers before any batch."""
    import pytest

    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.data.sampler import RandomPairSampler
    from reid_gan_torch.parallel import Mesh

    ds = create("synthetic", str(tmp_path), num_ids=8, imgs_per_id=4)
    train = list(ds.train)

    def loader(shard, batch=8):
        pre = Preprocessor(train, mode="fdgan_pose", height=H, width=W, pid_imgs=ds.pid_imgs,
                           pose_root=ds.poses_dir, seed=3, cache=None)
        pairs = list(RandomPairSampler(train, seed=4))[:24]   # three batches of 8
        return DataLoader(pre, sampler=pairs, batch_size=batch, num_workers=2,
                          drop_last=True, shard=shard), pre

    def three(ld):
        out = list(ld)
        assert len(out) == 3
        return out

    ref_loader, ref_pre = loader(None)
    ref = three(ref_loader)
    shards = [loader(Mesh(r, 4, "cpu")) for r in range(4)]
    got = [three(ld) for ld, _ in shards]
    for i in range(3):
        for side in (0, 1):
            for k, v in ref[i][side].items():
                rows = [g[i][side][k] for g in got]
                joined = np.concatenate(rows) if isinstance(v, np.ndarray) else sum(rows, [])
                np.testing.assert_array_equal(np.asarray(joined), np.asarray(v), err_msg=k)
    after = ref_pre.rng.rand(4)
    for _, pre in shards:
        np.testing.assert_array_equal(pre.rng.rand(4), after)
    with pytest.raises(ValueError, match="a pair batch of 6 does not split over a mesh of 4"):
        loader(Mesh(0, 4, "cpu"), batch=6)


def test_fdgan_pose_draws_of_a_launch_equal_the_launching_process(tmp_path, monkeypatch):
    """``cli/fdgan_baseline.run_main`` where it launches (four gloo ranks in
    place of four cards) under an unfixed hash seed: one epoch of the
    ``fdgan_pose`` loader on each rank (``torch_mesh_ranks.fdgan_pose_epoch``)
    gives this process's rows of every batch (target images, landmarks,
    flips), though the ranks' own sets list their names otherwise."""
    import pickle

    from reid_gan_torch.cli import fdgan_baseline
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.data.datasets import create

    import torch_mesh_ranks

    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    argv = ["--dataset", "synthetic", "--data-dir", str(tmp_path / "d"), "--height", str(H),
            "--width", str(W), "-b", "8", "-j", "2", "--seed", "3",
            "--logs-dir", str(tmp_path / "logs")]
    cfg = parse_config(argv, sections=("data", "train"))
    ds = create("synthetic", str(tmp_path / "d"))
    ref = torch_mesh_ranks.fdgan_pose_epoch(cfg, ds)
    assert len(ref) > 10

    monkeypatch.setattr(fdgan_baseline, "wants_mesh", lambda device, mesh: mesh is None)
    monkeypatch.setattr(fdgan_baseline, "local_device_count", lambda: 4)
    monkeypatch.setattr(fdgan_baseline, "launch", lambda fn, n, args: spawn(
        fn, n, tmp_path, *args))
    fdgan_baseline.run_main(cfg, "cpu", None, argv, torch_mesh_ranks.fdgan_pose_ranks, None)
    ranks = []
    for r in range(4):
        with open(tmp_path / "logs" / f"draws.rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    order = {p: list(v) for p, v in ds.pid_imgs.items()}
    assert any(got["own"] != order for got in ranks)
    for i, batch in enumerate(ref):
        for side in (0, 1):
            for k, v in batch[side].items():
                joined = np.concatenate([got["rows"][i][side][k] for got in ranks])
                np.testing.assert_array_equal(joined, v, err_msg=f"batch {i} side {side} {k}")
