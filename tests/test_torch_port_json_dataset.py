"""Port parity for the open-reid JSON-split datasets (``JsonDataset``,
``CUHK03``): the splits of a synthetic tree against the JAX package's, the
integrity check, and ``cli/fdgan_baseline --dataset cuhk03`` against the JAX
CLI on the same weights (a tree listing absolute image names, which both
packages resolve), then the port's FD CLIs on a tree of bare names, which
resolve under its ``images/``."""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fdgan_cli import _capture
from test_torch_port_fdgan_nets import random_tree
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

H, W = 64, 32


def write_tree(root, n_ids=112, n_test=8, per_cam=1, absolute=False, poses=False, seed=0):
    """An open-reid tree: ``meta.json`` (each id's images by camera, two
    cameras), ``splits.json`` (one split: the first ids trainval, the last
    ``n_test`` both query and gallery, as CUHK03's splits list them), the
    images at 64x32 (a colour an id plus noise) and with ``poses`` a
    landmark file an image. Names are ``{pid:08d}_{cam:02d}_{i:04d}.jpg``,
    bare or, with ``absolute``, the images' absolute paths."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    images = osp.join(root, "images")
    os.makedirs(images, exist_ok=True)
    if poses:
        os.makedirs(osp.join(root, "poses"), exist_ok=True)
    identities = []
    for pid in range(n_ids):
        colour = rng.randint(0, 256, 3)
        cams = []
        for cam in range(2):
            names = []
            for i in range(per_cam):
                name = f"{pid:08d}_{cam:02d}_{i:04d}.jpg"
                img = np.clip(colour + rng.randint(-30, 30, (H, W, 3)), 0, 255)
                Image.fromarray(img.astype(np.uint8)).save(osp.join(images, name))
                if poses:
                    ys, xs = rng.randint(0, H, 18), rng.randint(0, W, 18)
                    with open(osp.join(root, "poses", name[:-4] + ".txt"), "w") as f:
                        f.writelines(f"{y} {x}\n" for y, x in zip(ys, xs))
                names.append(osp.join(images, name) if absolute else name)
            cams.append(names)
        identities.append(cams)
    with open(osp.join(root, "meta.json"), "w") as f:
        json.dump({"name": "cuhk03", "shot": "multiple", "num_cameras": 2,
                   "identities": identities}, f)
    test = list(range(n_ids - n_test, n_ids))
    with open(osp.join(root, "splits.json"), "w") as f:
        json.dump([{"trainval": list(range(n_ids - n_test))[::-1], "query": test,
                    "gallery": test}], f)
    return root


def test_dataset_factory_names_match_jax():
    from reid_gan_torch.data.datasets import names
    from reid_gan_tpu.data.datasets import names as jax_names

    assert names() == jax_names()


@pytest.mark.parametrize("name", ["json", "cuhk03"])
@pytest.mark.parametrize("num_val", [3, 0.25, 0], ids=["int", "fraction", "none"])
def test_splits_match_jax(tmp_path, name, num_val):
    """Every split (relabelled train/val/trainval, query and gallery with
    their own pids), the id counts and ``pid_imgs`` equal the JAX
    dataset's, with ``num_val`` a count, a fraction and 0."""
    from reid_gan_torch.data.datasets import create
    from reid_gan_tpu.data.datasets import create as jax_create

    root = write_tree(str(tmp_path), n_ids=14, n_test=4, per_cam=2)
    got = create(name, root, num_val=num_val, verbose=False)
    ref = jax_create(name, root, num_val=num_val, verbose=False)
    for split in ("train", "val", "trainval", "query", "gallery"):
        assert getattr(got, split) == getattr(ref, split), split
    for attr in ("num_train_ids", "num_val_ids", "num_trainval_ids", "pid_imgs",
                 "images_dir", "poses_dir"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    want_val = {3: 3, 0.25: 2, 0: 0}[num_val]
    assert got.num_val_ids == want_val and got.num_train_ids == 10 - want_val
    assert len(got.query) == len(got.gallery) == 16


@pytest.mark.parametrize("missing", ["meta.json", "splits.json", "images"])
def test_cuhk03_refuses_an_incomplete_tree(tmp_path, missing):
    """Without ``meta.json``, ``splits.json`` or ``images/``, both packages'
    ``CUHK03`` raise ``RuntimeError``; ``JsonDataset`` and ``CUHK03`` raise
    the JAX package's ``ValueError`` for a ``num_val`` of every id and for
    a split that is not there."""
    import shutil

    from reid_gan_torch.data.datasets import CUHK03, JsonDataset
    from reid_gan_tpu.data.datasets import CUHK03 as JaxCUHK03

    root = write_tree(str(tmp_path / "t"), n_ids=6, n_test=2)
    for cls in (JsonDataset, CUHK03):
        with pytest.raises(ValueError, match="num_val exceeds total identities 4"):
            cls(root, num_val=4, verbose=False)
        with pytest.raises(ValueError, match="split_id exceeds total splits 1"):
            cls(root, split_id=1, num_val=1, verbose=False)
    path = osp.join(root, missing)
    shutil.rmtree(path) if osp.isdir(path) else os.remove(path)
    for cls in (CUHK03, JaxCUHK03):
        with pytest.raises(RuntimeError, match="CUHK03 dataset not found or corrupted"):
            cls(root, num_val=1, verbose=False)


def test_fdgan_baseline_cuhk03_matches_jax_cli(tmp_path, monkeypatch):
    """``cli/fdgan_baseline --dataset cuhk03 --debug --evaluate --resume``
    on a tree of absolute names, both CLIs from the same random Siamese
    net (depth 18, a msgpack for JAX and a ``.pth.tar`` for the port): both
    stages' distance matrices within 1e-5 of their largest entry (query and
    gallery are the same images here, and the fp32 sum ‖x‖² + ‖y‖² − 2x·y
    cancels on the diagonal to a few ulps of ‖x‖²), and from each the mAP
    and the cuhk03 CMC top-1 the CLIs return, and the cuhk03 CMC top-1/5/10
    (the single-gallery-shot sampler, the separate camera set), within
    1e-4."""
    from reid_gan_tpu.cli.fdgan_baseline import main as jax_main
    from reid_gan_tpu.engine import fdgan as jax_fdgan
    from reid_gan_tpu.models.multi_branch import siamese_baseline as jax_siamese
    from reid_gan_tpu.utils.serialization import save_checkpoint as jax_save
    from reid_gan_torch.cli.fdgan_baseline import main
    from reid_gan_torch.engine import fdgan
    from reid_gan_torch.engine.metrics import cmc
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax
    from reid_gan_torch.utils.serialization import save_checkpoint

    root = write_tree(str(tmp_path / "cuhk03"), n_ids=116, n_test=12, per_cam=2,
                      absolute=True)
    jm = jax_siamese(depth=18)
    v = random_tree(jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, H, W, 3)),
                                                     jnp.zeros((2, H, W, 3)), train=False),
                                   jax.random.PRNGKey(0)), 91)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    jax_save(v, False, str(tmp_path / "w.msgpack"))
    save_checkpoint({"state_dict": siamese_state_dict_from_jax(v["params"], v["batch_stats"])},
                    False, str(tmp_path / "w.pth.tar"))
    common = ["--dataset", "cuhk03", "--data-dir", root, "--height", str(H), "--width",
              str(W), "-b", "16", "-j", "2", "--debug", "--evaluate"]

    jseen = _capture(monkeypatch, jax_fdgan)
    ref_top1, ref_map = jax_main(common + ["--resume", str(tmp_path / "w.msgpack"),
                                           "--logs-dir", str(tmp_path / "jax")], mesh=False)
    seen = _capture(monkeypatch, fdgan)
    top1, mAP = main(common + ["--resume", str(tmp_path / "w.pth.tar"), "--logs-dir",
                               str(tmp_path / "port"), "--device", "cpu"])

    assert abs(top1 - ref_top1) <= 1e-4 and abs(mAP - ref_map) <= 1e-4
    assert len(seen) == len(jseen) == 2
    from reid_gan_torch.data.datasets import create

    ds = create("cuhk03", root, verbose=False)
    ids = ([p for _, p, _ in ds.query], [p for _, p, _ in ds.gallery],
           [c for _, _, c in ds.query], [c for _, _, c in ds.gallery])
    for (d, res), (jd, jres) in zip(seen, jseen):
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5 * np.abs(jd).max())
        np.testing.assert_allclose(res, jres, rtol=0, atol=1e-4)
        curve, ref_curve = (cmc(m, *ids, seed=0, device="cpu", **fdgan._PROTOCOLS["cuhk03"])
                            for m in (d, jd))
        np.testing.assert_allclose(curve[:10], ref_curve[:10], rtol=0, atol=1e-4)
    assert 0.0 < mAP <= 1.0


def test_fd_clis_run_on_a_tree_of_bare_names(tmp_path):
    """The names of ``meta.json`` resolve under the tree's ``images/``:
    ``cli/fdgan_baseline --dataset cuhk03 --debug`` trains, evaluates under
    the cuhk03 protocol and writes its checkpoints; ``cli/fdgan_train
    --stage 1 --dataset json`` reads the pose pairs (the same-id target by
    its bare name, its landmarks under ``poses/``) from that checkpoint and
    writes its nets."""
    from reid_gan_torch.cli import fdgan_baseline, fdgan_train

    root = write_tree(str(tmp_path / "tree"), poses=True)
    common = ["--data-dir", root, "--height", str(H), "--width", str(W), "-b", "8", "-j",
              "2", "--debug", "--device", "cpu"]
    best = fdgan_baseline.main(["--dataset", "cuhk03", "--logs-dir", str(tmp_path / "base")]
                               + common)
    assert np.isfinite(best) and 0.0 < best <= 1.0
    base = tmp_path / "base"
    assert osp.exists(base / "checkpoint.pth.tar") and osp.exists(base / "model_best.pth.tar")
    with open(base / "log.txt") as f:
        log = f.read()
    assert "CUHK03 json dataset loaded" in log and "cuhk03" in log.split("CMC Scores")[1]
    m1 = fdgan_train.main(["--dataset", "json", "--stage", "1", "--logs-dir",
                           str(tmp_path / "s1"), "--save-dir", str(tmp_path / "c1"),
                           "--netE-pretrain", str(base / "model_best.pth.tar")] + common)
    nets = tmp_path / "c1" / "experiment"
    assert all(osp.exists(nets / f"latest_net_{n}.pth") for n in ("E", "G", "Di", "Dp"))
    assert torch.isfinite(next(m1.net_G.parameters())).all()
