"""Port parity for the data mesh's paths through the slice: one USL step,
the sharded eval and ``cli/train_usl`` end to end, each on four
gloo ranks (``torch_mesh_ranks.spawn``) against the JAX package under
``get_mesh(4)`` on the conftest's virtual CPU devices; the ``train_all``
step on four ranks against the port's single-process step on the global
batch, and ``cli/train_gan_usl`` on two ranks against one process. Each
run's files are written by rank 0 alone."""

import glob
import os.path as osp
import re

import numpy as np
import pytest
import torch

import jax

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _jax_named, _random_variables, _to64
from torch_mesh_ranks import spawn

H, W, P, K = 32, 16, 4, 4
B, D, NV, K_PAD = P * K, 512, 8, 256


def _jax_resnet18(seed):
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet

    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(seed))
    return jmodel, params, stats


def _port_state(params, stats):
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    return {k: v.numpy() for k, v in resnet_state_dict_from_jax(params, stats).items()}


class _OneBatch:
    def __init__(self, batch):
        self.batch = batch

    def next(self):
        return self.batch


def _assert_near(name, got, ref, rel):
    """Each array within ``rel`` of its norm, plus 1e-12 of the largest
    norm (a value that is zero in exact arithmetic is rounding on both
    sides)."""
    scale = max(np.linalg.norm(r) for r in ref.values())
    for k, r in ref.items():
        err = np.linalg.norm(got[k] - r)
        assert err <= rel * np.linalg.norm(r) + 1e-12 * scale, \
            f"{name} {k}: {err:.3g} of {np.linalg.norm(r):.3g}"


def test_usl_step_on_four_ranks_matches_the_jax_mesh_trainer(tmp_path, monkeypatch):
    """One fp64 ``ClusterContrastTrainer`` step on four gloo ranks (resnet18
    at 32x16, a P×K batch of 4×4, 4 rows a rank; global BatchNorm, the
    gradient all-reduce, K7's fold of the gathered rows) against JAX's
    ``ClusterContrastTrainer(mesh=get_mesh(4))`` on the same sharded batch.
    The augmentation is the port's: each rank draws the whole batch's
    parameters from the step's seed and takes its rows; the JAX step gets
    that augmented batch in fp64 (its in-step ``reid_augment`` is the
    identity here; the transform's parity is test_torch_port_augment.py's).
    The loss within 1e-9 relative, the parameters and the bank within 1e-10,
    Adam's first moments within 1e-9 and second within 2e-9 of their norms,
    the running stats within 1e-6 relative (fp32 on the JAX side, ROADMAP
    C)."""
    import torch_mesh_ranks
    from reid_gan_tpu.engine import trainers as jax_trainers
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_tpu.parallel.mesh import get_mesh
    from reid_gan_torch.ops.transforms import sample_augment_params, train_augment

    jmodel, params, stats = _jax_resnet18(30)
    rng = np.random.RandomState(31)
    img = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    pid = np.repeat(rng.permutation(NV)[:P], K).astype(np.int32)[rng.permutation(B)]
    bank = rng.randn(NV, D)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    seed = 7

    got = spawn(torch_mesh_ranks.usl_step, 4, tmp_path, _port_state(params, stats), bank,
                img, pid, seed, H, W, K, K_PAD)

    gen = torch.Generator().manual_seed(seed)
    x = train_augment(torch.from_numpy(img), sample_augment_params(B, H, W, gen), H, W)
    monkeypatch.setattr(jax_trainers, "reid_augment",
                        lambda key, img, height=None, width=None, train=None: img)
    with jax.enable_x64(True):
        jt = jax_trainers.ClusterContrastTrainer(jmodel, height=H, width=W,
                                                 num_instances=K, mesh=get_mesh(4))
        state = jt.init_state({"params": _to64(params), "batch_stats": _to64(stats)},
                              jax_init_memory(bank, k_pad=K_PAD))
        batch = {"img": x.permute(0, 2, 3, 1).double().numpy(), "pid": pid}
        state, loss = jt.train(state, 0, _OneBatch(batch), train_iters=1, print_freq=1,
                               base_seed=seed)
        ref = _jax_named(jax.tree.map(np.asarray, state.params),
                         jax.tree.map(np.asarray, state.batch_stats))
        adam = state.opt_state[1]
        mu = _jax_named(jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray,
                                                                        state.batch_stats))
        nu = _jax_named(jax.tree.map(np.asarray, adam.nu), jax.tree.map(np.asarray,
                                                                        state.batch_stats))
        ref_bank = np.asarray(state.memory.features)

    assert abs(got["loss"] - loss) <= 1e-9 * abs(loss)
    for k, v in got["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-6, atol=1e-7) if "running" in k else dict(rtol=0, atol=1e-10)
        np.testing.assert_allclose(v, ref[k], err_msg=k, **tol)
    np.testing.assert_allclose(got["bank"], ref_bank, rtol=0, atol=1e-10)
    names = sorted(got["moments"])
    assert len(names) == len(jax.tree_util.tree_leaves(params))
    _assert_near("mu", {n: got["moments"][n][0] for n in names}, {n: mu[n] for n in names},
                 1e-9)
    _assert_near("nu", {n: got["moments"][n][1] for n in names}, {n: nu[n] for n in names},
                 2e-9)


def test_sharded_eval_on_four_ranks_matches_the_jax_mesh_evaluator(tmp_path):
    """Extraction and the rank pass on four gloo ranks (batches of 6, so
    each is padded to 8 and every rank holds a padding row of some batch;
    the query chunks dealt over the ranks) against JAX's ``FeatureExtractor``
    and ``Evaluator`` over ``get_mesh(4)`` (batches of 8) on the same
    weights and synthetic images: every feature within 1e-5, CMC and mAP
    within 1e-6."""
    import torch_mesh_ranks
    from reid_gan_tpu.data.datasets import create as jax_dataset
    from reid_gan_tpu.data.loader import DataLoader as JaxLoader
    from reid_gan_tpu.data.loader import Preprocessor as JaxPre
    from reid_gan_tpu.engine.evaluators import Evaluator as JaxEvaluator
    from reid_gan_tpu.engine.evaluators import FeatureExtractor as JaxExtractor
    from reid_gan_tpu.engine.evaluators import extract_features as jax_extract
    from reid_gan_tpu.parallel.mesh import get_mesh

    jmodel, params, stats = _jax_resnet18(32)
    ds = jax_dataset("synthetic_hard", str(tmp_path))
    query, gallery = list(ds.query), list(ds.gallery)
    got = spawn(torch_mesh_ranks.sharded_eval, 4, tmp_path, _port_state(params, stats),
                query, gallery, 64, 32, 6)

    ex = JaxExtractor(jmodel, {"params": params, "batch_stats": stats}, height=64,
                      width=32, batch_size=8, mesh=get_mesh(4))
    loader = JaxLoader(JaxPre(query + gallery, mode="reid", height=64, width=32),
                       batch_size=8, drop_last=False, num_workers=1)
    feats = jax_extract(ex, loader)[0]
    cmc, mAP = JaxEvaluator(ex).evaluate(loader, query, gallery, cmc_flag=True)
    assert set(got["features"]) == set(feats) and len(feats) == len(query + gallery)
    for f, v in feats.items():
        np.testing.assert_allclose(got["features"][f], v, rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(got["cmc"], cmc, rtol=0, atol=1e-6)
    assert abs(got["mAP"] - mAP) <= 1e-6


def _writers(out_dir):
    return sorted(osp.basename(p) for p in glob.glob(osp.join(str(out_dir), "*.rank*")))


_FLAGS = ["--dataset", "synthetic", "--arch", "resnet18", "--height", "64", "--width",
          "32", "--batch-size", "16", "--num-instances", "4", "--eps", "0.7", "--k1",
          "8", "--k2", "3", "--workers", "1", "--eval-step", "1", "--debug"]


def test_train_usl_on_four_ranks_matches_the_jax_cli_on_its_mesh(tmp_path):
    """``cli/train_usl`` with ``--debug`` on four gloo ranks against the JAX
    CLI's ``main(args, mesh=get_mesh(4))`` on the same synthetic set: the
    same pseudo-label count, the best mAP within 1e-4 (each side's own
    random init). Only rank 0 opens the log and writes the options and the
    checkpoints, and rank 0's ``log.txt`` holds the run."""
    import torch_mesh_ranks
    from reid_gan_tpu.cli.train_usl import main as jax_main
    from reid_gan_tpu.parallel.mesh import get_mesh

    flags = _FLAGS + ["--data-dir", str(tmp_path / "d")]
    ref = jax_main(flags + ["--logs-dir", str(tmp_path / "jax")], mesh=get_mesh(4))
    out = tmp_path / "writes"
    out.mkdir()
    logs = tmp_path / "logs"
    best = spawn(torch_mesh_ranks.cli_main, 4, tmp_path, "train_usl",
                 flags + ["--logs-dir", str(logs), "--device", "cpu"], str(out))
    assert abs(best - ref) <= 1e-4
    assert _writers(out) == ["Logger.rank0", "dump_config.rank0", "save_checkpoint.rank0"]
    for f in ("checkpoint.pth.tar", "model_best.pth.tar", "log.txt", "train_opt.txt"):
        assert osp.exists(logs / f), f

    def clusters(path):
        with open(path) as fh:
            return re.findall(r"Clustered into (\d+) classes", fh.read())

    got = clusters(logs / "log.txt")
    assert got and got == clusters(tmp_path / "jax" / "log.txt")
    with open(logs / "log.txt") as fh:
        assert "Test with the best model" in fh.read()


_SIZES = (32, 16, 16, 8)


def _joint_inputs():
    """resnet18 and the pose G and D (ngf 8) with random weights in fp64, a
    bank and a GAN bank of 8 live rows, and one ``train_all`` batch of 8 in
    4 groups of 2 with conf weights."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.resnet import ReIDResNet

    torch.manual_seed(40)
    enc = ReIDResNet(depth=18, norm=True)
    with torch.no_grad():
        for name, t in enc.state_dict().items():
            if name.endswith(("running_var", "bn1.weight", "bn2.weight")):
                t.uniform_(0.5, 1.5)
            elif name.endswith("running_mean"):
                t.normal_(0, 0.1)
    gan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=16, gan_width=8,
                  num_feats=32, ngf=8, reid_feat_dim=D, device="cpu")
    sd = lambda m: {k: v.double().numpy() if v.is_floating_point() else v.numpy()  # noqa: E731
                    for k, v in m.state_dict().items()}
    rng = np.random.RandomState(41)
    bank, gan_bank = rng.randn(NV, D), rng.randn(NV, D)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    n = 8
    kp = np.stack([rng.uniform(0, 64, (n, 18)), rng.uniform(0, 32, (n, 18))], -1)
    kp[rng.rand(n, 18) < 0.2] = -1
    batch = {"img": rng.randint(0, 256, (n, 32, 16, 3)).astype(np.uint8),
             "pid": np.repeat(rng.permutation(NV)[:n // 2], 2).astype(np.int32),
             "Xs": rng.randint(0, 256, (n, 16, 8, 3)).astype(np.uint8),
             "keypoints": kp.astype(np.float32),
             "old_size": np.tile(np.asarray([[64, 32]], np.float32), (n, 1))}
    conf = (rng.rand(n) < 0.75).astype(np.float32)
    return sd(enc), {"G": sd(gan.net_G), "D": sd(gan.net_D)}, bank, gan_bank, batch, conf


def test_train_all_step_on_four_ranks_matches_the_single_process_step(tmp_path):
    """One fp64 ``train_all`` step (resnet18 at 32x16, the pose G and D at
    16x8, batch 8, 2 rows a rank) on four gloo ranks against the port's
    single-process step on the global batch: the four losses within 1e-9
    relative; every parameter, buffer and spectral ``u``/``sigma`` of the
    encoder, G and D within 1e-10; the running stats within 1e-9 relative
    (G's BatchNorms fold their global stats once a step: the counters read
    1); the bank and the GAN bank, folded from the gathered rows in one
    launch, within 1e-10."""
    import torch_mesh_ranks

    enc, gan, bank, gan_bank, batch, conf = _joint_inputs()
    args = (enc, gan, bank, gan_bank, batch, conf, 9, _SIZES, 2)
    ref = torch_mesh_ranks.joint_step(None, *args)
    got = spawn(torch_mesh_ranks.joint_step, 4, tmp_path, *args)
    for k, r in ref["errs"].items():
        assert abs(got["errs"][k] - r) <= 1e-9 * abs(r), k
    for net in ("enc", "G", "D"):
        for k, r in ref[net].items():
            if k.endswith("num_batches_tracked"):
                assert got[net][k] == r == 1, (net, k)
                continue
            tol = dict(rtol=1e-9, atol=1e-12) if "running" in k else \
                dict(rtol=0, atol=1e-10)
            np.testing.assert_allclose(got[net][k], r, err_msg=f"{net} {k}", **tol)
        assert any("running" in k for k in ref[net]) or net == "D"
    for k in ("bank", "gan_bank"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-10, err_msg=k)
    assert not np.allclose(ref["gan_bank"][:NV], gan_bank)


def test_train_gan_usl_on_two_ranks_matches_one_process(tmp_path):
    """``cli/train_gan_usl`` (the pose generator, ``train_all`` from the first
    epoch) with ``--debug`` on two gloo ranks against one process: the same
    best mAP within 1e-4 and pseudo-label count; only rank 0 writes the log,
    the options, the checkpoints, the GAN nets and ``iter.txt``."""
    import torch_mesh_ranks
    from reid_gan_torch.cli.train_gan_usl import main

    flags = _FLAGS + ["--data-dir", str(tmp_path / "d"), "--model", "AE", "--model-gen",
                      "Pose", "--gan-height", "32", "--gan-width", "16", "--device", "cpu"]
    ref = main(flags + ["--logs-dir", str(tmp_path / "one"), "--save-dir",
                        str(tmp_path / "one_ckpt")], mesh=False)
    out = tmp_path / "writes"
    out.mkdir()
    logs, ckpt = tmp_path / "two", tmp_path / "two_ckpt"
    best = spawn(torch_mesh_ranks.cli_main, 2, tmp_path, "train_gan_usl",
                 flags + ["--logs-dir", str(logs), "--save-dir", str(ckpt)], str(out))
    assert abs(best - ref) <= 1e-4
    assert _writers(out) == ["Logger.rank0", "Visualizer.rank0", "dump_config.rank0",
                             "save_checkpoint.rank0", "save_networks.rank0"]
    for f in ("latest_net_G.pth", "latest_net_D.pth", "iter.txt"):
        assert osp.exists(ckpt / "experiment" / f), f

    def clusters(path):
        with open(path) as fh:
            return re.findall(r"Clustered into (\d+) classes", fh.read())

    assert clusters(logs / "log.txt") == clusters(tmp_path / "one" / "log.txt") != []


def _assert_named_state(name, got, ref):
    """``_assert_state``'s tolerances on a state dict of numpy arrays."""
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        r = np.asarray(r)
        if "running" in k:
            tol = dict(rtol=1e-6, atol=1e-7)
        elif k.endswith(("u", "sigma")):
            tol = dict(rtol=1e-9, atol=1e-12)
        else:
            tol = dict(rtol=0, atol=1e-10)
        np.testing.assert_allclose(got[k], r, err_msg=f"{name} {k}", **tol)


@pytest.mark.slow
def test_train_all_step_on_four_ranks_matches_the_jax_mesh_step(tmp_path, monkeypatch):
    """The fp64 oracle of the ``train_all`` step under a mesh: the port's
    step on four gloo ranks (2 rows each) against JAX's jitted ``train_all``
    step on the batch sharded over ``get_mesh(4)`` with the state
    replicated, from ``test_torch_port_joint.joint_setup``'s weights, bank
    and GAN bank. The JAX step gets the port's augmented image, GAN image
    and pose maps (its in-step transforms are the identity there), the port
    draws the whole batch's augmentation on each rank. The losses within
    1e-9 relative, the encoder's, G's and D's parameters within 1e-10,
    running stats within 1e-6 relative, D's spectral u/sigma within 1e-9,
    both banks within 1e-10."""
    import torch_mesh_ranks
    from test_torch_port_joint import _batch, _nhwc64, joint_setup
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.ops.pose import batch_cords_to_map
    from reid_gan_torch.ops.transforms import (
        gan_input_transform,
        sample_augment_params,
        train_augment,
    )

    gan_bank = np.random.RandomState(23).randn(NV, D)
    s = joint_setup(monkeypatch, gan_bank=gan_bank)
    h, w, gh, gw = s.size
    batch, conf = _batch(60)
    seed = 61
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}  # noqa: E731
    got = spawn(torch_mesh_ranks.joint_step, 4, tmp_path, sd(s.model),
                {"G": sd(s.gan.net_G), "D": sd(s.gan.net_D)},
                s.state.memory.features[:NV].numpy(), gan_bank, batch, conf, seed,
                s.size, 2)

    n = len(batch["pid"])
    x = train_augment(torch.from_numpy(batch["img"]), sample_augment_params(
        n, h, w, torch.Generator().manual_seed(seed)), h, w)
    xs = gan_input_transform(torch.from_numpy(batch["Xs"]), gh, gw)
    ps = batch_cords_to_map(torch.from_numpy(batch["keypoints"]),
                            torch.from_numpy(batch["old_size"]), gh, gw)
    mesh = get_mesh(4)
    with jax.enable_x64(True):
        dev = jax_shard(mesh, {"img": np.asarray(_nhwc64(x)), "pid": batch["pid"],
                               "Xs": np.asarray(_nhwc64(xs)),
                               "Ps": np.asarray(_nhwc64(ps))})
        jstate, jerrs = s.jt._get_step("train_all")(
            replicate(mesh, s.jstate), dev, np.int32(seed), jax_shard(mesh, conf))
        enc = _jax_named(jax.tree.map(np.asarray, jstate.enc_params),
                         jax.tree.map(np.asarray, jstate.enc_batch_stats))
        nets = {name: {k: v.numpy() for k, v in state_dict_from_jax(
            net, jax.tree.map(np.asarray, var["params"]),
            jax.tree.map(np.asarray, var["batch_stats"])).items()}
            for name, net, var in (("G", s.gan.net_G, jstate.gan.G),
                                   ("D", s.gan.net_D, jstate.gan.D))}
        banks = {"bank": np.asarray(jstate.memory.features),
                 "gan_bank": np.asarray(jstate.memory.gan_features)}
    for k in ("loss_cl", "G", "D", "loss"):
        r = float(jerrs[k])
        assert abs(got["errs"][k] - r) <= 1e-9 * abs(r), k
    _assert_named_state("encoder", got["enc"], enc)
    for name in ("G", "D"):
        _assert_named_state(name, got[name], nets[name])
    for k, r in banks.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-10, err_msg=k)
