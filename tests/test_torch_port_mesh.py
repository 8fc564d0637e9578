"""Port parity for the data mesh's pieces (``reid_gan_torch/parallel``,
``ops/norm.py``, the sharded loader) against the JAX package's
``parallel/mesh.py`` on the conftest's virtual CPU devices (``get_mesh(4)``),
on gloo meshes of four CPU processes (``torch_mesh_ranks.spawn``): the
shards, the gathers and reductions, BatchNorm over the whole mesh batch,
the swap of a net's BatchNorms, every pairing past the checks that once
refused a mesh, and ``cli/test`` on four ranks against the JAX CLI on its
mesh."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from torch_mesh_ranks import spawn


def _fake_mesh(rank, size):
    """A ``Mesh`` without a process group: enough for the pieces that call
    no collective."""
    from reid_gan_torch.parallel import Mesh

    return Mesh(rank, size, "cpu")


def test_shard_batch_matches_the_shards_jax_places():
    """Rank r's ``shard_batch`` of a tree is the shard JAX's ``shard_batch``
    places on device r of ``get_mesh(4)``; ``pad_to_multiple`` is JAX's."""
    from reid_gan_tpu.parallel.mesh import get_mesh
    from reid_gan_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard
    from reid_gan_torch.parallel import pad_to_multiple, shard_batch

    rng = np.random.RandomState(0)
    tree = {"img": rng.randint(0, 256, (8, 4, 2, 3)).astype(np.uint8),
            "pid": rng.randint(0, 9, 8).astype(np.int32)}
    mesh = get_mesh(4)
    ref = jax_shard(mesh, tree)
    for r, dev in enumerate(mesh.devices):
        got = shard_batch(_fake_mesh(r, 4), tree)
        for k, leaf in ref.items():
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(got[k], np.asarray(shard.data), err_msg=k)
        t = shard_batch(_fake_mesh(r, 4), [torch.from_numpy(tree["pid"])])[0]
        np.testing.assert_array_equal(t.numpy(), got["pid"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(_fake_mesh(0, 3), tree)
    for n, m in ((10, 4), (12, 4), (1, 3)):
        x = rng.randn(n, 2)
        (a, na), (b, nb) = pad_to_multiple(x, m), jax_pad(x, m)
        np.testing.assert_array_equal(a, b)
        assert na == nb == n


def test_gathers_and_reductions_on_four_ranks(tmp_path):
    """On four gloo ranks: an uneven last batch (10 rows) padded, sharded,
    gathered in rank order and trimmed gives the batch back; the gradient
    all-reduce is the mean over the ranks (a parameter without a gradient
    stays without); ``replicate`` gives rank 0's parameters, buffers and
    trees; the scalar reductions and ``broadcast_object``."""
    batch = np.random.RandomState(1).randn(12, 3).astype(np.float32)
    out = spawn(__import__("torch_mesh_ranks").gathers_and_reductions, 4, tmp_path,
                batch, 10)
    np.testing.assert_array_equal(out["rows"], batch[:10])
    assert out["n"] == 10
    np.testing.assert_array_equal(out["g0"], np.full(3, 1.5))
    np.testing.assert_array_equal(out["g1"], np.arange(4.0).reshape(2, 2) * 2.5)
    assert out["g2"] is None
    assert out["mean"] == 1.5 and out["sum"] == 10
    assert out["obj"] == {"rank": 0}
    np.testing.assert_array_equal(out["bn"][0], np.ones(3))
    np.testing.assert_array_equal(out["bn"][1], np.zeros(3))
    np.testing.assert_array_equal(out["tree"][0], np.full(2, 0.5))
    assert out["tree"][1] == 0


@pytest.mark.parametrize("exc", [ValueError, SystemExit], ids=["raises", "exits"])
def test_a_rank_that_raises_fails_the_launch(tmp_path, exc):
    """Rank 1 raises (an error, or ``SystemExit`` as a failed check does)
    while the others wait for it in a barrier: the launch raises at once,
    with the rank's exit code, and does not wait for the group's timeout."""
    import time

    import torch.multiprocessing as mp
    import torch_mesh_ranks

    t0 = time.monotonic()
    with pytest.raises(mp.ProcessExitedException, match="exit code 1"):
        spawn(torch_mesh_ranks.fails_on_rank_1, 3, tmp_path, exc)
    assert time.monotonic() - t0 < torch_mesh_ranks.TIMEOUT.total_seconds()


def _jax_global_bn(x, dy, weight, bias, rm, rv):
    """JAX ``TorchBatchNorm`` in train mode under ``jit`` on the global batch
    sharded over ``get_mesh(4)``, NHWC: the output, the gradients of
    Σ y·dy and the running stats."""
    from reid_gan_tpu.ops.norm import TorchBatchNorm
    from reid_gan_tpu.parallel.mesh import get_mesh, shard_batch

    to_last = (lambda a: np.moveaxis(a, 1, -1)) if x.ndim == 4 else (lambda a: a)
    bn = TorchBatchNorm()
    mesh = get_mesh(4)
    with jax.enable_x64(True):
        variables = {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                     "batch_stats": {"mean": jnp.asarray(rm, jnp.float32),
                                     "var": jnp.asarray(rv, jnp.float32)}}
        xs, dys = shard_batch(mesh, (to_last(x), to_last(dy)))

        @jax.jit
        def f(params, xx, dd):
            def loss(p, xx):
                y, mut = bn.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                  xx, mutable=["batch_stats"])
                return jnp.sum(y * dd), (y, mut["batch_stats"])
            (_, (y, st)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                        has_aux=True)(params, xx)
            return y, gp, gx, st

        y, gp, gx, st = f(variables["params"], xs, dys)
        back = (lambda a: np.moveaxis(np.asarray(a), -1, 1)) if x.ndim == 4 else np.asarray
        return {"y": back(y), "dx": back(gx), "dw": np.asarray(gp["scale"]),
                "db": np.asarray(gp["bias"]), "rm": np.asarray(st["mean"]),
                "rv": np.asarray(st["var"])}


_BN_SHAPES = {"2d": (8, 5, 3, 2), "1d": (12, 7)}


def _bn_inputs(shape):
    rng = np.random.RandomState(2)
    c = shape[1]
    x = rng.randn(*shape) * 2.0 + rng.randn(1, c, *([1] * (len(shape) - 2))) * 3.0
    dy = rng.randn(*shape)
    weight, bias = rng.rand(c) + 0.5, rng.randn(c) * 0.1
    rm, rv = rng.randn(c).astype(np.float32), (rng.rand(c) + 0.5).astype(np.float32)
    return x, dy, weight, bias, rm, rv


@pytest.fixture(scope="module")
def global_bn_ranks(tmp_path_factory):
    """Each shape's ``GlobalBatchNorm`` on four gloo ranks, both in one
    spawn (``torch_mesh_ranks.each``)."""
    import torch_mesh_ranks

    calls = []
    for shape in _BN_SHAPES.values():
        x, dy, weight, bias, rm, rv = _bn_inputs(shape)
        calls.append((x, dy, weight, bias, rm.astype(np.float64), rv.astype(np.float64)))
    got = spawn(torch_mesh_ranks.each, 4, tmp_path_factory.mktemp("global_bn"),
                torch_mesh_ranks.global_bn, calls)
    return dict(zip(_BN_SHAPES, got))


@pytest.mark.parametrize("case", list(_BN_SHAPES))
def test_global_batch_norm_matches_jax_under_a_sharded_jit(global_bn_ranks, case):
    """``GlobalBatchNorm`` (all-reduces of [Σx, n] and Σ(x − mean)², its
    gradient written out) on four gloo ranks in fp64, against JAX
    ``TorchBatchNorm`` under ``jit`` on the 4-way-sharded global batch: the
    output within 1e-10, the input's and the parameters' gradients within
    1e-9, the running mean and the running variance (Bessel's n/(n−1) of the
    global n) within 1e-6 relative (fp32 on the JAX side, ROADMAP C). An
    odd channel count, means far from 0."""
    got = global_bn_ranks[case]
    ref = _jax_global_bn(*_bn_inputs(_BN_SHAPES[case]))
    np.testing.assert_allclose(got["y"], ref["y"], rtol=0, atol=1e-10)
    for k in ("dx", "dw", "db"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-9, err_msg=k)
    for k in ("rm", "rv"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_global_batch_norm_in_fp32_keeps_a_large_mean_apart(tmp_path):
    """In fp32 the global BatchNorm's variance takes the mean first and then
    the centred squares: on channels whose mean (1,000) dwarfs their spread
    (0.5), where E[x²] − E[x]² in fp32 loses every digit, the output stays
    within 1e-3 of the fp64 BatchNorm of the same input, the input's
    gradient within 1e-4 relative and the running variance within 1e-6
    relative (a gloo mesh of one rank in this process)."""
    from reid_gan_torch.ops.norm import GlobalBatchNorm
    from reid_gan_torch.parallel import destroy_mesh, get_mesh

    g = torch.Generator().manual_seed(0)
    x = 1000 + 0.5 * torch.randn(64, 5, 4, 3, generator=g)
    dy = torch.randn(x.shape, generator=g)

    def run(bn, x):
        x = x.clone().requires_grad_(True)
        y = bn.train()(x)
        (y * dy.to(x.dtype)).sum().backward()
        return y.detach().double(), x.grad.double(), bn.running_var.double()

    y_ref, g_ref, rv_ref = run(torch.nn.BatchNorm2d(5).double(), x.double())
    get_mesh(1, 0, init_method=f"file://{tmp_path}/store", device_type="cpu")
    try:
        y, gx, rv = run(GlobalBatchNorm(5), x)
    finally:
        destroy_mesh()
    assert float((y - y_ref).abs().max()) <= 1e-3
    assert float((gx - g_ref).norm() / g_ref.norm()) <= 1e-4
    assert float(((rv - rv_ref).abs() / rv_ref).max()) <= 1e-6


@pytest.mark.parametrize("arch", ["resnet18", "resnet_ibn50a"])
def test_convert_global_bn_keeps_the_state_dict_and_eval(arch):
    """``convert_global_bn`` swaps every BatchNorm of the encoder (the IBN
    halves', ``feat_bn``) and of the pose G for a ``GlobalBatchNorm`` that
    shares its tensors: the same state-dict keys and values, ``feat_bn.bias``
    still frozen, the same eval output (eval mode runs no collective).
    Without a mesh nothing is swapped."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.ops.norm import GlobalBatchNorm, convert_global_bn

    torch.manual_seed(0)
    model = create(arch, norm=True).eval()
    x = torch.randn(2, 3, 32, 16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = model(x)
    n_bn = sum(isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))
               for m in model.modules())
    assert convert_global_bn(model, None) is model
    assert not any(isinstance(m, GlobalBatchNorm) for m in model.modules())
    assert convert_global_bn(model, _fake_mesh(0, 4)) is model
    assert sum(isinstance(m, GlobalBatchNorm) for m in model.modules()) == n_bn > 20
    assert not any(isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))
                   for m in model.modules())
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert not model.feat_bn.bias.requires_grad
    torch.testing.assert_close(model(x), ref, rtol=0, atol=0)

    gan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=16, gan_width=8,
                  num_feats=32, ngf=8, reid_feat_dim=512, device="cpu")
    keys = list(gan.net_G.state_dict())
    convert_global_bn(gan.net_G, _fake_mesh(0, 2))
    assert list(gan.net_G.state_dict()) == keys
    assert any(isinstance(m, GlobalBatchNorm) for m in gan.net_G.modules())


def test_sharded_loader_decodes_each_ranks_slice(tmp_path):
    """A loader with ``shard`` decodes rank r's contiguous slice of each
    batch (the last one padded with its last index), and carries the whole
    batch's index fields: over three ranks the slices, in rank order and
    trimmed, are the unsharded loader's batches."""
    from reid_gan_torch.data.datasets import create as create_dataset
    from reid_gan_torch.data.loader import DataLoader, Preprocessor

    ds = create_dataset("synthetic", str(tmp_path))
    items = list(ds.query) + list(ds.gallery)
    pre = Preprocessor(items, height=32, width=16, cache=None)
    ref = list(DataLoader(pre, batch_size=7, drop_last=False, num_workers=1))
    shards = [list(DataLoader(pre, batch_size=7, drop_last=False, num_workers=1,
                              shard=_fake_mesh(r, 3))) for r in range(3)]
    assert len(items) % 7 and all(len(s) == len(ref) for s in shards)
    for i, b in enumerate(ref):
        n = len(b["fname"])
        img = np.concatenate([s[i]["img"] for s in shards])
        assert len(img) == 3 * -(-n // 3)
        np.testing.assert_array_equal(img[:n], b["img"])
        np.testing.assert_array_equal(img[n:], np.repeat(b["img"][-1:], len(img) - n, 0))
        for s in shards:
            assert s[i]["fname"] == b["fname"]
            for k in ("pid", "camid", "index"):
                np.testing.assert_array_equal(s[i][k], b[k])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per_item"])
def test_sharded_with_gan_loader_draws_the_whole_batchs_flips(tmp_path, packed):
    """A sharded ``with_gan`` loader takes the packed gather where the
    unsharded one does, and each rank's flips are its rows' share of the
    whole batch's draws from the same seed: over three ranks the slices, in
    rank order and trimmed, are the unsharded batches, flips too (the
    per-item path draws in the pool's order, so there only the count of
    flips and the stream after each batch must agree, on batches that split
    evenly, as a train loader's P×K batches do)."""
    from reid_gan_torch.data.datasets import create as create_dataset
    from reid_gan_torch.data.loader import DataLoader, ImageCache, Preprocessor

    ds = create_dataset("synthetic", str(tmp_path))
    items = list(ds.train)[:20 if packed else 18]
    assert len(items) == (20 if packed else 18)

    def loader(shard):
        pre = Preprocessor(items, mode="with_gan", height=32, width=16, gan_height=16,
                           gan_width=8, flip_all=True, seed=5,
                           cache=ImageCache() if packed else None)
        assert pre.batchable() == packed
        return DataLoader(pre, batch_size=8 if packed else 6, drop_last=False,
                          num_workers=1,
                          shard=shard), pre

    ref_loader, ref_pre = loader(None)
    ref = list(ref_loader)
    shards = [loader(_fake_mesh(r, 3)) for r in range(3)]
    got = [list(ld) for ld, _ in shards]
    for i, b in enumerate(ref):
        n = len(b["index"])
        for k in ("img", "Xs", "flip", "gan_flip", "gt_label") if packed else ("img", "Xs"):
            np.testing.assert_array_equal(np.concatenate([s[i][k] for s in got])[:n], b[k])
        if not packed:
            assert sum(len(s[i]["flip"]) for s in got) == 3 * -(-n // 3)
        for s in got:
            np.testing.assert_array_equal(s[i]["index"], b["index"])
    after = ref_pre.rng.rand(4)
    for _, pre in shards:
        np.testing.assert_array_equal(pre.rng.rand(4), after)


def test_assemble_rows_means_and_local_stats_on_four_ranks(tmp_path):
    """On four gloo ranks: ``assemble_rows`` gives every rank the chosen
    rows of the whole batch (repeated, out of order, owned by any rank) bit
    for bit; ``all_reduce_means`` the ranks' means at the widest dtype; a
    global BatchNorm within ``local_stats`` on rows every rank holds alike is
    the one-card ``nn.BatchNorm2d`` on them (output, running stats with n − 1
    of those rows, the counter), with no collective, and leaves ``local``
    off after the block."""
    import torch_mesh_ranks

    rng = np.random.RandomState(9)
    x = rng.randn(12, 3, 2, 2)
    rows = np.array([11, 0, 5, 5, 3, 8, 2])
    bn_in = rng.randn(3, 4, 2, 2) * 2 + 1
    got = spawn(torch_mesh_ranks.mesh_pieces, 4, tmp_path, x, rows, bn_in)
    np.testing.assert_array_equal(got["picked"], x[rows])
    assert got["means"] == {"a": (1.5, torch.float64), "b": (3.0, torch.float64)}
    ref = torch.nn.BatchNorm2d(4).double().train()
    y = ref(torch.from_numpy(bn_in))
    np.testing.assert_array_equal(got["y"], y.detach().numpy())
    np.testing.assert_array_equal(got["rm"], ref.running_mean.numpy())
    np.testing.assert_array_equal(got["rv"], ref.running_var.numpy())
    assert got["n"] == 1


class _Reached(Exception):
    """Raised where a run gets to its first piece of work."""


def test_ported_mesh_pairings_run_past_their_checks(tmp_path, monkeypatch):
    """Under a mesh every pairing runs past the checks that used to refuse
    it: each CLI gets to its dataset (``main_first``, stopped there) with
    ``--fp16`` (the three training CLIs, the joint CLI in each of its
    modes), with ``--dsbn`` (the eval CLI), and FD-GAN's two CLIs; the joint
    trainer gets to its first batch in every mode, with fp32 and with bf16
    nets; the bf16 USL trainer and the GAN warm-up trainer (fp32 and bf16)
    are built and the warm-up gets to its first batch; ``SiameseTrainer``
    gets to its first batch, ``FDGANModel`` is built in both stages, and
    the pair loaders take a shard. A pair batch that the mesh size does not
    divide raises ``ValueError`` naming both numbers before any work: in
    both FD-GAN CLIs and in the pair loaders."""
    from reid_gan_torch.cli import (
        fdgan_baseline,
        fdgan_train,
        test,
        train_gan_usl,
        train_gan_warmup,
        train_usl,
    )
    from reid_gan_torch.config import FDGANConfig, GANConfig
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.engine.fdgan import SiameseTrainer
    from reid_gan_torch.engine.gan_trainers import (
        MODES,
        ClusterContrastWithGANTrainer,
        GANTrainer,
    )
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models import create, siamese_baseline
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.fdgan.model import FDGANModel

    def reached(*args, **kwargs):
        raise _Reached

    mesh = _fake_mesh(0, 2)
    base = ["--dataset", "synthetic", "--data-dir", str(tmp_path / "d"), "--arch",
            "resnet18", "--device", "cpu"]
    cases = [
        (train_usl, ["--fp16"]),
        (test, ["--dsbn", "--resume", "x.msgpack"]),
        (train_gan_usl, ["--model-gen", "Pose", "--fp16"]),
        (train_gan_usl, ["--model-gen", "AE", "--no-gan-train"]),
        (train_gan_usl, ["--model-gen", "AE", "--no-gan-train", "--fp16"]),
        (train_gan_usl, ["--model-gen", "AE", "--arch", "resnet_bip50", "--bipath"]),
        (train_gan_usl, ["--model-gen", "AE", "--arch", "resnet_bip50", "--bipath",
                         "--fp16"]),
        (train_gan_usl, ["--model-gen", "Pose", "--learnable-memory"]),
        (train_gan_usl, ["--model-gen", "Pose", "--learnable-memory", "--fp16"]),
        (train_gan_usl, ["--model-gen", "Pose", "--gan-mode", "wgangp"]),
        (train_gan_warmup, ["--model-gen", "AE"]),
        (train_gan_warmup, ["--model-gen", "AE", "--fp16"]),
        (train_gan_warmup, ["--model-gen", "AE", "--gan-mode", "wgangp"]),
        (fdgan_baseline, []),
        (fdgan_train, ["--stage", "1"]),
        (fdgan_train, ["--stage", "2"]),
    ]
    for i, (cli, extra) in enumerate(cases):
        # the FD-GAN CLIs load their dataset through fdgan_baseline's main
        monkeypatch.setattr(fdgan_baseline if cli is fdgan_train else cli, "main_first",
                            reached)
        with pytest.raises(_Reached):
            cli.main(base + extra + ["--logs-dir", str(tmp_path / f"logs{i}")], mesh=mesh)
    for cli in (fdgan_baseline, fdgan_train):
        logs = tmp_path / f"odd_{cli.__name__}"
        with pytest.raises(ValueError, match="a pair batch of 7 does not split over a "
                                             "mesh of 2 ranks"):
            cli.main(base + ["-b", "7", "--logs-dir", str(logs)], mesh=mesh)
        assert not logs.exists()
    assert not (tmp_path / "d").exists()

    class Loader:
        def next(self):
            raise _Reached

        def __iter__(self):
            raise _Reached

    kw = dict(gan_height=16, gan_width=8, num_feats=32, ngf=8, reid_feat_dim=512,
              device="cpu")
    for gen, gan_mode, dtype in (("AE", "lsgan", None), ("Pose", "wgangp", None),
                                 ("AE", "lsgan", torch.bfloat16),
                                 ("Pose", "lsgan", torch.bfloat16)):
        gan = AEModel(GANConfig(model="AE", model_gen=gen, gan_mode=gan_mode), dtype=dtype,
                      **kw)
        trainer = ClusterContrastWithGANTrainer(create("resnet18", dtype=dtype), gan,
                                                height=32, width=16, device="cpu",
                                                mesh=mesh)
        for mode in MODES:
            with pytest.raises(_Reached):
                trainer.run_epoch(None, 0, Loader(), mode=mode, gmem=object())
    ClusterContrastTrainer(create("resnet18", dtype=torch.bfloat16), device="cpu", mesh=mesh)
    for module in ("engine.gan_trainers", "engine.fdgan", "models.fdgan.model"):
        monkeypatch.setattr(f"reid_gan_torch.{module}.replicate", lambda m, tree: tree)
    for dtype in (None, torch.bfloat16):
        gan = AEModel(GANConfig(model="AE", model_gen="AE"), dtype=dtype, **kw)
        warm = GANTrainer(gan, device="cpu", mesh=mesh)
        with pytest.raises(_Reached):
            warm.train_gan(gan.init_state(), 0, Loader(), train_iters=1)
    siamese = SiameseTrainer(siamese_baseline(depth=18), device="cpu", mesh=mesh)
    with pytest.raises(_Reached):
        siamese.train(0, Loader())
    for stage in (1, 2):
        assert FDGANModel(FDGANConfig(stage=stage), height=64, width=32, depth=18,
                          device="cpu", mesh=mesh).mesh is mesh
    for mode in ("pair", "fdgan_pose"):
        assert DataLoader(Preprocessor([], mode=mode), batch_size=64, shard=mesh).shard \
            is mesh
        with pytest.raises(ValueError, match="a pair batch of 63 does not split"):
            DataLoader(Preprocessor([], mode=mode), batch_size=63, shard=mesh)


_RERANK = {"plain": [], "rerank": ["--rerank"]}


@pytest.fixture(scope="module")
def eval_cli_ranks(tmp_path_factory):
    """A random resnet18 saved as ``model.pth`` and the synthetic_hard set
    under one root, and ``cli/test`` on four gloo ranks with and without
    ``--rerank``, both in one spawn (``torch_mesh_ranks.each``). Returns
    the CLI's flags without ``--rerank`` and each case's (cmc, mAP)."""
    import torch_mesh_ranks
    from reid_gan_torch.models import create

    root = tmp_path_factory.mktemp("eval_cli")
    torch.manual_seed(5)
    model = create("resnet18")
    with torch.no_grad():
        model.gap.p.fill_(3.2)
        model.feat_bn.weight.uniform_(0.5, 1.5)
    pth = root / "model.pth"
    torch.save(model.state_dict(), str(pth))
    args = ["--dataset", "synthetic_hard", "--data-dir", str(root), "--arch",
            "resnet18", "--height", "64", "--width", "32", "--batch-size", "16",
            "--workers", "1", "--resume-torch", str(pth)]
    calls = []
    for case, flag in _RERANK.items():
        (root / case).mkdir()
        calls.append(("test", args + flag + ["--device", "cpu"], str(root / case)))
    got = spawn(torch_mesh_ranks.each, 4, root, torch_mesh_ranks.cli_main, calls)
    return args, dict(zip(_RERANK, got))


@pytest.mark.parametrize("case", list(_RERANK))
def test_eval_cli_on_four_ranks_matches_the_jax_cli_on_its_mesh(eval_cli_ranks, case):
    """``cli/test`` on four gloo ranks against the JAX CLI over
    ``get_mesh(4)`` on the same saved weights: CMC top-1/5/10 and mAP within
    1e-4; with ``--rerank`` rank 0 re-ranks and broadcasts the metrics."""
    from reid_gan_tpu.cli.test import main as jax_main
    from reid_gan_tpu.parallel.mesh import get_mesh

    args, got = eval_cli_ranks
    ref_cmc, ref_map = jax_main(args + _RERANK[case], mesh=get_mesh(4))
    cmc, mAP = got[case]
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4
