"""Port end to end: the eval CLI against the JAX CLI on the same synthetic
data and weights; the copied synthetic dataset; entry points that refuse to
run on the CPU unasked; the port's import hygiene; the ctypes bindings
against the C signatures of the kernels."""

import ast
import ctypes
import filecmp
import glob
import os
import os.path as osp
import re

import numpy as np
import pytest
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.mark.parametrize("dataset", ["synthetic", "synthetic_hard"])
def test_eval_cli_matches_jax_cli(tmp_path, dataset):
    """A random port ReIDResNet (resnet18) saved as .pth, evaluated by both
    CLIs on one synthetic directory at 64x32: CMC top-1/5/10 and mAP within
    1e-4."""
    from reid_gan_tpu.cli.test import main as jax_main
    from reid_gan_torch.cli.test import main as torch_main
    from reid_gan_torch.models import create

    torch.manual_seed(5)
    model = create("resnet18")
    with torch.no_grad():
        model.gap.p.fill_(3.2)
        model.feat_bn.weight.uniform_(0.5, 1.5)
    pth = tmp_path / "model.pth"
    torch.save(model.state_dict(), str(pth))
    args = ["--dataset", dataset, "--data-dir", str(tmp_path), "--arch", "resnet18",
            "--height", "64", "--width", "32", "--batch-size", "64",
            "--workers", "2", "--resume-torch", str(pth)]
    ref_cmc, ref_map = jax_main(args, mesh=False)
    cmc, mAP = torch_main(args + ["--device", "cpu"])
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4


def test_eval_cli_rerank_matches_jax_cli(tmp_path):
    """``--rerank``: the host distance matrices, the k-reciprocal
    re-ranking on the port's native code and the rank pass on the re-ranked
    matrix, against the JAX CLI on the same weights (those of the test
    above): CMC top-1/5/10 and mAP within 1e-4. Re-ranking amplifies the
    features' rounding differences: on the untouched random weights, whose
    features nearly collapse, the two CLIs' re-ranked mAP part by 5.4e-5
    (ROADMAP C); on these by under 1e-9. The re-ranking itself matches JAX
    to 1e-6 on the same matrices (test_torch_port_native.py)."""
    from reid_gan_tpu.cli.test import main as jax_main
    from reid_gan_torch.cli.test import main as torch_main
    from reid_gan_torch.models import create

    torch.manual_seed(5)
    model = create("resnet18")
    with torch.no_grad():
        model.gap.p.fill_(3.2)
        model.feat_bn.weight.uniform_(0.5, 1.5)
    pth = tmp_path / "model.pth"
    torch.save(model.state_dict(), str(pth))
    args = ["--dataset", "synthetic_hard", "--data-dir", str(tmp_path), "--arch",
            "resnet18", "--height", "64", "--width", "32", "--batch-size", "64",
            "--workers", "2", "--resume-torch", str(pth), "--rerank"]
    ref_cmc, ref_map = jax_main(args, mesh=False)
    cmc, mAP = torch_main(args + ["--device", "cpu"])
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4


def test_synthetic_dataset_writes_the_same_files(tmp_path):
    from reid_gan_tpu.data.datasets import create as jax_create
    from reid_gan_torch.data.datasets import create

    a, b = tmp_path / "jax", tmp_path / "torch"
    ds_a = jax_create("synthetic", str(a), num_ids=3, imgs_per_id=2)
    ds_b = create("synthetic", str(b), num_ids=3, imgs_per_id=2)
    rel = lambda items, root: [(osp.relpath(f, root), p, c) for f, p, c in items]  # noqa: E731
    for split in ("train", "query", "gallery"):
        assert rel(getattr(ds_a, split), a) == rel(getattr(ds_b, split), b)
    files = sorted(osp.relpath(osp.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert mismatch == [] and errors == []


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from reid_gan_torch.cli.test import main
    from reid_gan_torch.device import resolve_device
    from reid_gan_torch.engine.evaluators import FeatureExtractor
    from reid_gan_torch.models import create

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureExtractor(create("resnet18"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--data-dir", "/nonexistent"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_rank_metrics_refuse_the_cpu_unless_asked(monkeypatch):
    """``evaluate_all_features`` and ``rank_metrics_features`` default to the
    card, as every entry point does: without one they raise."""
    from reid_gan_torch.engine.evaluators import evaluate_all_features
    from reid_gan_torch.engine.metrics import rank_metrics_features

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = np.eye(2, 4, dtype=np.float32)
    items = [("a.jpg", 0, 0), ("b.jpg", 1, 0)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_metrics_features(f, f, [0, 1], [0, 1], [0, 0], [1, 1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_all_features(f, f, items, items)
    _, mAP = rank_metrics_features(f, f, [0, 1], [0, 1], [0, 0], [1, 1],
                                   device="cpu")
    assert mAP == 1.0


def test_unported_options_raise(tmp_path):
    """``--resume`` and ``--dsbn`` are ported (test_torch_port_dsbn.py): a
    missing msgpack checkpoint raises the JAX CLI's ``ValueError``, and
    ``--dsbn`` without a msgpack ``--resume`` raises before any work."""
    from reid_gan_torch.cli.test import main

    with pytest.raises(ValueError, match="No checkpoint found"):
        main(["--device", "cpu", "--dataset", "synthetic", "--data-dir", str(tmp_path),
              "--arch", "resnet18", "--resume", str(tmp_path / "ckpt.msgpack")])
    with pytest.raises(ValueError, match="--dsbn reads a domain-specific BN"):
        main(["--device", "cpu", "--dsbn"])


def _port_sources():
    root = osp.join(REPO, "reid_gan_torch")
    files = [osp.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    scripts = sorted(glob.glob(osp.join(REPO, "scripts", "torch_validate_*.py")))
    assert len(scripts) == 4, scripts
    return files + [osp.join(REPO, "chip_smoke.py")] + scripts


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "optax", "reid_gan_tpu"}
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in banned]
    assert bad == []


_CTYPE = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
          ctypes.c_longlong: "long long", ctypes.c_float: "float"}


def _c_kind(decl):
    decl = decl.strip()
    if "*" in decl:
        return "ptr"
    for kind in ("long long", "int", "float"):
        if decl.startswith(kind) or decl.startswith("const " + kind):
            return kind
    raise AssertionError(f"unexpected C parameter {decl!r}")


def test_kernel_bindings_match_the_c_signatures():
    """Each CudaKernel's ctypes argtypes (plus the trailing stream) and its
    scratch query's argtypes and return type match the ``extern "C"``
    function in csrc/ — a mismatch would pass a cut pointer or a wrong value
    to the card, and nvcc is not here to check."""
    from reid_gan_torch import kernels

    sigs = {}
    for fname in os.listdir(kernels.CSRC_DIR):
        if fname.endswith(".cu"):
            with open(osp.join(kernels.CSRC_DIR, fname)) as f:
                src = f.read()
            for ret, name, params in re.findall(
                    r'extern "C" (int|long long) (\w+)\(([^)]*)\)', src):
                sigs[name] = (ret, [_c_kind(p) for p in params.split(",")])
    assert len(kernels.KERNELS) == 14
    scratch = []
    for k in kernels.KERNELS:
        entries = list(k.entries.values())
        if k.scratch is not None:
            entries.append(k.scratch)
            scratch.append(k.name)
        for entry in entries:
            got = (_CTYPE[entry.restype], [_CTYPE[t] for t in entry.argtypes])
            assert got == sigs[entry.symbol], entry.symbol
        assert osp.exists(osp.join(REPO, k.source)), k.source
    assert scratch == ["train_augment", "gem_pool", "infonce", "knn_topk"]
    assert kernels.launch_counts() == {
        "eval_transform": 0, "gem_bn_l2n": 0, "rank_stats": 0,
        "train_augment": 0, "gem_pool": 0, "infonce": 0, "bank_fold": 0,
        "knn_topk": 0, "gan_input": 0, "pose_maps": 0, "gan_feat_l2n": 0,
        "diff_transform": 0, "pose_peaks": 0, "fd_augment": 0}
    assert set(kernels.phase_launch_counts()) >= {"gem_pool.backward",
                                                  "infonce.backward"}


def test_cpu_paths_launch_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    from reid_gan_torch import kernels
    from reid_gan_torch.engine.metrics import rank_metrics_features
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.pose import batch_cords_to_map, render_pose_peaks
    from reid_gan_torch.ops.transforms import (
        diff_transform,
        eval_transform,
        fd_augment,
        gan_input_transform,
    )

    kernels.reset_launch_counts()
    rng = np.random.RandomState(0)
    u8 = torch.from_numpy(rng.randint(0, 256, (2, 32, 16, 3)).astype(np.uint8))
    x = eval_transform(u8, 32, 16)
    with torch.no_grad():
        model = create("resnet18")
        f = model.eval()(x.float()).numpy()
        assert model.train()(x.float())["gan_feat"].shape == (2, 512, 2, 1)
    rank_metrics_features(f, f, [0, 1], [0, 1], [0, 0], [1, 1], device="cpu")
    gan_input_transform(u8, 32, 16)
    batch_cords_to_map(torch.ones((2, 18, 2)), torch.full((2, 2), 8.0), 32, 16)
    diff_transform(torch.zeros((2, 3, 16, 8)), 32, 16)
    render_pose_peaks(torch.ones((2, 18, 2)), torch.full((2,), 5.0),
                      torch.full((2,), -1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                      32, 16)
    fd_augment(u8, torch.zeros((2, 9)))
    assert set(kernels.launch_counts().values()) == {0}
