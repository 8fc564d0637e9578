"""The port's learning and scale checks (``scripts/torch_validate_*.py``) at
toy sizes on the CPU: the synthetic sets they draw against the JAX
package's files, the in-memory image source against Pillow, each script's
checks as functions of their inputs (a passing and a failing case a
threshold), ``use_float16`` Jaccard against JAX's, the MSMT script's bank
step, and one toy run of the USL script through the in-memory path."""

import importlib.util
import os
import os.path as osp

import numpy as np
import pytest

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# a few ids of each set, at the sizes the scripts draw (synthetic: 64x32)
_SETS = {"synthetic": {"num_ids": 3, "num_cams": 3, "imgs_per_id": 3},
         "synthetic_hard": {"num_ids": 6, "imgs_per_id": 5, "height": 128, "width": 64,
                            "palette": 2}}
_QUALITY = {"synthetic": 90, "synthetic_hard": 92}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_validate_{name}", osp.join(REPO, "scripts", f"torch_validate_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return {osp.relpath(osp.join(d, f), root): open(osp.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("name", sorted(_SETS))
def test_synthetic_sets_write_the_jax_files(tmp_path, name):
    """``create(name, ...)`` of the port and of the JAX package with the
    same arguments and seed: the same names, splits and pids, and every file
    (JPEGs, keypoint CSVs, landmark files, ``.complete``) byte for byte."""
    from reid_gan_tpu.data.datasets import create as jax_create
    from reid_gan_torch.data.datasets import create

    a, b = tmp_path / "jax", tmp_path / "torch"
    ds_a = jax_create(name, str(a), **_SETS[name])
    ds_b = create(name, str(b), **_SETS[name])
    assert ds_b.images is None
    for split in ("train", "query", "gallery"):
        assert [(osp.relpath(f, a), p, c) for f, p, c in getattr(ds_a, split)] == \
            [(osp.relpath(f, b), p, c) for f, p, c in getattr(ds_b, split)]
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb) and any(f.endswith(".jpg") for f in fa)
    assert all(fa[k] == fb[k] for k in fa)


@pytest.mark.parametrize("name", sorted(_SETS))
def test_in_memory_sets_hold_the_drawn_images_and_write_the_rest(tmp_path, name):
    """``in_memory=True``: the same splits, pids and ``pid_imgs`` as the
    written set; every file but the images (and ``.complete``) written
    alike; each held image, encoded by Pillow at the writer's quality, is
    the written JPEG."""
    import io

    from PIL import Image

    from reid_gan_torch.data.datasets import create

    disk = create(name, str(tmp_path / "disk"), **_SETS[name])
    mem = create(name, str(tmp_path / "mem"), in_memory=True, **_SETS[name])
    base = lambda items: [(osp.basename(f), p, c) for f, p, c in items]  # noqa: E731
    for split in ("train", "query", "gallery"):
        assert base(getattr(mem, split)) == base(getattr(disk, split))
    assert mem.pid_imgs == disk.pid_imgs
    fd, fm = _files(disk.dataset_dir), _files(mem.dataset_dir)
    assert sorted(fm) == sorted(k for k in fd if not k.endswith((".jpg", ".complete")))
    assert all(fm[k] == fd[k] for k in fm)
    jpgs = {osp.basename(k): v for k, v in fd.items() if k.endswith(".jpg")}
    assert sorted(mem.images) == sorted(jpgs)
    for fname, img in mem.images.items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=_QUALITY[name])
        assert buf.getvalue() == jpgs[fname], fname


@pytest.mark.parametrize("src,dst", [((64, 32), (128, 64)), ((128, 64), (64, 32)),
                                     ((37, 23), (50, 17)), ((64, 32), (64, 32)),
                                     ((128, 64), (128, 32))])
def test_named_images_resize_as_pillow_decodes(src, dst):
    """``NamedImages.get`` at another size: Pillow's bilinear resize of the
    held image, bit for bit, and its own size as the original; the held
    image itself at its own size."""
    from PIL import Image

    from reid_gan_torch.data.in_memory import NamedImages

    img = np.random.RandomState(sum(src + dst)).randint(0, 256, src + (3,)).astype(np.uint8)
    got, old = NamedImages({"0001_c1s1_000000_00.jpg": img}).get(
        "/any/dir/0001_c1s1_000000_00.jpg", *dst)
    ref = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    assert old.tolist() == list(src)


def test_usl_check():
    usl = _script("synthetic_usl")
    usl.verdict(0.51)
    with pytest.raises(AssertionError, match="failed to learn separable ids"):
        usl.verdict(0.5)


@pytest.mark.parametrize("best,has_g,match", [
    (0.51, True, None), (0.5, True, "joint loop failed to learn"),
    (0.9, False, "no latest_net_G.pth")])
def test_joint_checks(tmp_path, best, has_g, match):
    joint = _script("synthetic_joint")
    if has_g:
        (tmp_path / "latest_net_G.pth").write_bytes(b"")
    if match is None:
        joint.verdict(best, str(tmp_path))
    else:
        with pytest.raises(AssertionError, match=match):
            joint.verdict(best, str(tmp_path))


@pytest.mark.parametrize("maps,best,match", [
    ([0.40, 0.55, 0.61], 0.61, None),
    ([0.60, 0.75], 0.75, "first-epoch mAP 0.600"),
    ([0.45, 0.54], 0.54, "no climb"),
    ([0.35, 0.50], 0.50, "failed to learn"),
    ([], 0.9, "no epoch was evaluated")])
def test_hard_trajectory_checks(maps, best, match):
    hard = _script("hard_synthetic")
    if match is None:
        hard.verdict_trajectory(maps, best)
    else:
        with pytest.raises(AssertionError, match=match):
            hard.verdict_trajectory(maps, best)


def test_hard_jaccard_check():
    hard = _script("hard_synthetic")
    hard.verdict_jaccard(22.9)
    with pytest.raises(AssertionError, match="exceeds the reference's 23.0s"):
        hard.verdict_jaccard(23.0)


_MSMT_OK = {"jaccard_s": 40.0, "fp16_err": 1e-3, "dbscan_s": 2.0, "clusters": 4000,
            "infomap_s": 20.0, "memory_s": 0.01, "bank_k": 4000, "rss_gb": 12.0}


@pytest.mark.parametrize("key,value,match", [
    (None, None, None), ("jaccard_s", 150.0, "jaccard 150s"),
    ("fp16_err", 2e-3, "fp16 Jaccard deviates"), ("dbscan_s", 150.0, "dbscan 150s"),
    ("clusters", 1000, "degenerate clustering"), ("infomap_s", 150.0, "infomap 150s"),
    ("memory_s", 1.0, "memory step 1.00s"), ("rss_gb", 24.0, "peak RSS 24.0 GB")])
def test_msmt_checks(key, value, match):
    """The budget is (32,621 / 12,936)^2 x 23 s, about 146 s."""
    msmt = _script("msmt_scale")
    assert 146 < msmt.BUDGET_S < 147
    r = dict(_MSMT_OK, **({} if key is None else {key: value}))
    if match is None:
        msmt.verdict(r)
    else:
        with pytest.raises(AssertionError, match=match):
            msmt.verdict(r)


@pytest.mark.parametrize("native", [True, False])
def test_float16_jaccard_matches_jax(native):
    """``compute_jaccard_distance(use_float16=True)``, the host C++ path and
    the plain one (V held in float16), on 300 rows around 30 centres
    against JAX's on the same rows: float16, within one float16 step (1e-3)
    of it and within 2e-3 of the float32 matrix, the MSMT script's bound."""
    from reid_gan_tpu.ops.jaccard import compute_jaccard_distance as jax_jaccard
    from reid_gan_torch.ops.jaccard import compute_jaccard_distance

    feats = _script("msmt_scale").make_feats(300, d=64, k=30)
    got = compute_jaccard_distance(feats, k1=20, k2=6, print_flag=False, native=native,
                                   device="cpu", use_float16=True)
    ref = jax_jaccard(feats, k1=20, k2=6, print_flag=False, use_float16=True,
                      native=native)
    full = compute_jaccard_distance(feats, k1=20, k2=6, print_flag=False, native=native,
                                    device="cpu")
    assert got.dtype == np.float16 and np.asarray(ref).dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), np.asarray(ref, np.float32),
                               rtol=0, atol=1e-3)
    assert full.dtype == np.float32
    assert np.abs(got.astype(np.float32) - full).max() < 2e-3


def test_msmt_main_runs_the_phase_and_fails_a_degenerate_clustering():
    """``torch_validate_msmt_scale.main`` on the CPU at 1,500 rows around 300
    centres: the whole phase runs (Jaccard in float32 and float16, DBSCAN,
    Infomap, the bank step) and its checks fail on the cluster count, below
    the 1,000 that MSMT17's scale must reach."""
    msmt = _script("msmt_scale")
    with pytest.raises(AssertionError, match="degenerate clustering"):
        msmt.main("cpu", n=1500, k=300)


def test_msmt_memory_step_on_the_cpu():
    """The bank step at a small K: the bank padded to a multiple of 256
    rows, the plain version held against itself, a time a step."""
    msmt = _script("msmt_scale")
    feats = msmt.make_feats(600, d=64, k=64)
    labels = np.arange(600) % 64
    sec, errs, rows = msmt.memory_step(feats, labels, 300, "cpu", runs=2)
    assert rows == 512 and errs == (0.0, 0.0, 0.0) and sec > 0


def test_usl_script_toy_run_in_memory(tmp_path):
    """``torch_validate_synthetic_usl.main`` on the CPU at a toy size (8 ids,
    64x32, one epoch of 4 steps): the set's images only in memory, the
    loop's log and checkpoints written, its check passed."""
    usl = _script("synthetic_usl")
    root = str(tmp_path)
    out = usl.main(root, "cpu", ["--height", "64", "--width", "32", "--batch-size", "16",
                                 "--epochs", "1", "--iters", "4", "--eval-step", "1",
                                 "--k1", "8", "--eps", "0.7"],
                   dataset_kw={"num_ids": 8, "num_cams": 3, "imgs_per_id": 4})
    assert out["maps"] and out["best"] == max(out["maps"]) > 0.5
    assert not any(f.endswith(".jpg") for _, _, fs in os.walk(root) for f in fs)
    for f in ("log.txt", "checkpoint.pth.tar", "model_best.pth.tar"):
        assert osp.exists(osp.join(root, "logs", f)), f
