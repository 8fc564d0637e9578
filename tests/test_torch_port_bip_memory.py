"""Port parity for the bip and learnable-memory modes of the joint trainer
and ``cli/train_gan_usl``'s ``--bipath`` and ``--learnable-memory``, in
fp64 at small sizes (images 32x16, the GAN at 16x8 with ngf 8 and img_f 32,
batch 8 in 4 groups of 2, 8 live rows of 256):

- the gradient memory (``init_gradient_memory``, ``gradient_memory_loss``,
  ``update_gradient_clusters``) and ``memory_step`` against the JAX
  functions;
- one ``train_all_bip`` step of a depth-18 ``ResNetBip`` and the AE
  generator, and two ``train_all_with_memory`` steps of resnet18 and the
  pose generator, against the JAX trainer's jitted steps: the port's step
  runs whole (K4's plain version on JAX's draws from the step's ``k_aug``,
  the first of a 2-way split, K9's and K10's plain versions), and the JAX
  step gets the port's augmented image, GAN image and pose maps as its
  batch, its in-step transforms replaced by the identity, with its
  gradients captured, as tests/test_torch_port_joint.py sets it up. The
  JAX clusters are built in fp64 (``init_gradient_memory`` casts them to
  float32) and the cluster step's rate passed in fp64;
- each mode end to end through ``cli/train_gan_usl.main --device cpu`` on
  the synthetic set, and with ``--fp16``, which the JAX CLI runs too.
"""

import os.path as osp

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import ae_variables, jax_ae_gan
from test_torch_port_joint import (
    _assert_grads,
    _assert_state,
    _batch,
    _capture,
    _nhwc64,
    _port_grads,
    joint_setup,
)
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _random_variables, _to64
from test_torch_port_usl import _FLAGS

H, W, GH, GW = 32, 16, 16, 8
B, GROUP, NV, K_PAD, D = 8, 2, 8, 256, 512


def _k_aug(seed):
    """The bip and memory steps' augmentation key: the first of a 2-way
    split (gan_trainers.py:306,401)."""
    return jax.random.split(jax.random.PRNGKey(seed))[0]


# ---------------------------------------------------------------------------
# the gradient memory and memory_step
# ---------------------------------------------------------------------------

def test_init_gradient_memory_matches_jax():
    """Zero-padded float32 clusters and the live count, as JAX's; float64
    centroids stay float64 in the port."""
    from reid_gan_tpu.ops.cluster_memory import init_gradient_memory as jax_init
    from reid_gan_torch.ops.cluster_memory import init_gradient_memory

    c = np.random.RandomState(0).randn(5, 12).astype(np.float32)
    ref, got = jax_init(c, k_pad=16), init_gradient_memory(c, k_pad=16, device="cpu")
    assert got.clusters.dtype == torch.float32 and got.clusters.shape == (16, 12)
    np.testing.assert_array_equal(got.clusters.numpy(), np.asarray(ref.clusters))
    assert int(got.num_valid) == int(ref.num_valid) == 5
    assert init_gradient_memory(c.astype(np.float64), device="cpu").clusters.dtype == \
        torch.float64


@pytest.mark.parametrize("k_pad", [NV, K_PAD])
def test_gradient_memory_loss_matches_jax(k_pad):
    """The mean loss and its gradient with respect to ``x`` within 1e-10 in
    fp64, against clusters that are not unit rows; the clusters get no
    gradient from it."""
    from reid_gan_tpu.ops.cluster_memory import GradientMemoryState as JaxGM
    from reid_gan_tpu.ops.cluster_memory import gradient_memory_loss as jax_loss
    from reid_gan_torch.ops.cluster_memory import (
        gradient_memory_loss,
        init_gradient_memory,
    )

    rng = np.random.RandomState(1)
    x, c = rng.randn(B, 16), rng.randn(NV, 16) * 3.0
    y = np.repeat(rng.permutation(NV)[:B // GROUP], GROUP).astype(np.int32)
    cp = np.pad(c, ((0, k_pad - NV), (0, 0)))
    with jax.enable_x64(True):
        (ref, _), ref_dx = jax.value_and_grad(
            lambda xx: jax_loss(xx, jnp.asarray(y), JaxGM(jnp.asarray(cp), jnp.int32(NV)),
                                temp=0.05), has_aux=True)(jnp.asarray(x))
    gm = init_gradient_memory(c, k_pad=k_pad, device="cpu")
    clusters = gm.clusters.clone().requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    loss, logits = gradient_memory_loss(xt, torch.from_numpy(y),
                                        gm._replace(clusters=clusters), temp=0.05)
    dx, dc = torch.autograd.grad(loss, [xt, clusters], allow_unused=True)
    assert dc is None
    assert abs(float(loss.detach()) - float(ref)) <= 1e-10 * abs(float(ref))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=0, atol=1e-10)
    assert logits.shape == (B, k_pad)


def test_update_gradient_clusters_matches_jax():
    """Touched rows step along their gradient over its norm plus eps,
    untouched ones along the gradient as it is, zero rows not at all."""
    from reid_gan_tpu.ops.cluster_memory import GradientMemoryState as JaxGM
    from reid_gan_tpu.ops.cluster_memory import update_gradient_clusters as jax_update
    from reid_gan_torch.ops.cluster_memory import (
        GradientMemoryState,
        update_gradient_clusters,
    )

    rng = np.random.RandomState(2)
    c, g = rng.randn(10, 6), rng.randn(10, 6)
    g[7] = 0.0
    touched = np.zeros(10, bool)
    touched[[0, 3, 4, 7]] = True
    with jax.enable_x64(True):
        ref = np.asarray(jax_update(JaxGM(jnp.asarray(c), jnp.int32(10)), jnp.asarray(g),
                                    jnp.asarray(touched), cluster_lr=0.3).clusters)
    got = update_gradient_clusters(GradientMemoryState(torch.from_numpy(c), None),
                                   torch.from_numpy(g), torch.from_numpy(touched),
                                   cluster_lr=0.3).clusters.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got - c, axis=1)[[0, 3, 4]], 0.3, rtol=1e-12)
    assert np.array_equal(got[7], c[7])


@pytest.mark.parametrize("use_hard", [False, True], ids=["plain", "hard"])
def test_memory_step_matches_jax(use_hard):
    """The per-sample loss and the folded bank within 1e-10 in fp64; the
    port folds in place and returns the same state."""
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init
    from reid_gan_tpu.ops.cluster_memory import memory_step as jax_step
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_step

    rng = np.random.RandomState(3)
    x, bank = rng.randn(B, 16), rng.randn(NV, 16)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    y = np.repeat(rng.permutation(NV)[:B // GROUP], GROUP).astype(np.int32)
    with jax.enable_x64(True):
        ref_loss, ref_state = jax_step(jnp.asarray(x), jnp.asarray(y),
                                       jax_init(bank, k_pad=16), use_hard=use_hard)
    state = init_memory(bank, k_pad=16, device="cpu")
    loss, out = memory_step(torch.tensor(x, requires_grad=True), torch.from_numpy(y),
                            state, use_hard=use_hard)
    assert out is state and loss.requires_grad
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss), rtol=1e-12)
    np.testing.assert_allclose(state.features.numpy(), np.asarray(ref_state.features),
                               rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# train_all_bip
# ---------------------------------------------------------------------------

def _bip_setup(monkeypatch):
    """The port's and JAX's trainers from the same weights: a depth-18
    ``ResNetBip`` at 32x16 and the AE generator with the discriminator at
    16x8, fp64, and the same bank."""
    from types import SimpleNamespace

    from reid_gan_tpu.engine import gan_trainers as jax_gan_trainers
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_tpu.models.resnet_variants import ResNetBip as JaxResNetBip
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models.convert import variant_state_dict_from_jax
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.resnet_variants import ResNetBip
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.transforms import train_augment

    from test_torch_port_augment import _jax_draws

    jmodel = JaxResNetBip(depth=18)
    params, stats = _random_variables(jmodel, np.random.RandomState(23))
    jgan = jax_ae_gan()
    G, Dv = ae_variables(jgan, 24)
    rng = np.random.RandomState(25)
    bank = rng.randn(NV, D)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)

    model = ResNetBip(depth=18)
    model.load_state_dict(variant_state_dict_from_jax(params, stats), strict=True)
    model = model.double()
    gan = AEModel(GANConfig(model="AE", model_gen="AE"), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    trainer = ClusterContrastWithGANTrainer(model, gan, height=H, width=W,
                                            num_instances=GROUP, device="cpu")
    seen = {}

    def augment(img, seed):
        seen["x"] = train_augment(img, torch.from_numpy(
            _jax_draws(_k_aug(seed), img.shape[0], H, W)), H, W)
        return seen["x"]

    trainer.augment = augment
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, device="cpu"),
                               gan.init_state())

    monkeypatch.setattr(jax_gan_trainers, "reid_augment",
                        lambda key, img, height=None, width=None, train=None: img)
    monkeypatch.setattr(jax_gan_trainers, "gan_input_transform", lambda img, h, w: img)
    with jax.enable_x64(True):
        jt = jax_gan_trainers.ClusterContrastWithGANTrainer(
            jmodel, jgan, height=H, width=W, num_instances=GROUP)
        jt.tx = optax.chain(_capture(), jt.tx)
        jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
        jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
        jgs = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                      opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
        jstate = jt.init_state({"params": _to64(params), "batch_stats": _to64(stats)},
                               jgs, jax_init_memory(bank, k_pad=K_PAD))
    return SimpleNamespace(model=model, gan=gan, trainer=trainer, state=state, jt=jt,
                           jstate=jstate, seen=seen)


def _variant_named(tree, stats):
    from reid_gan_torch.models.convert import variant_state_dict_from_jax

    return {k: v.double().numpy() for k, v in variant_state_dict_from_jax(
        jax.tree.map(np.asarray, tree), jax.tree.map(np.asarray, stats)).items()}


def _assert_gan(name, s, noise=None):
    """G's and D's gradients, parameters and buffers against the JAX
    state's. ``noise`` (a dict kept across steps) takes the G parameters
    whose gradient is zero in exact arithmetic (a bias ahead of a
    BatchNorm, which subtracts the batch mean): their reference gradient is
    rounding, within 1e-12 of the net's largest gradient norm as
    ``_assert_grads`` bounds it, and Adam (eps 1e-8) turns a gradient g far
    below eps into a step of lr·g/eps, bias-corrected by at most
    1/(1 − β1) = 2. Each such parameter's tolerance adds
    2·lr·(the two sides' rounding, 2e-12 of the norm)/eps summed over the
    steps it was rounding in."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    gan, gs = s.gan, s.jstate.gan
    for net, opt, var in ((gan.net_G, gs.opt_G, gs.G), (gan.net_D, gs.opt_D, gs.D)):
        label = f"{name} {type(net).__name__}"
        ref = {k: v.numpy() for k, v in state_dict_from_jax(
            net, jax.tree.map(np.asarray, opt[0]["g"])).items()}
        _assert_grads(label, _port_grads(net), ref)
        state = state_dict_from_jax(net, jax.tree.map(np.asarray, var["params"]),
                                    jax.tree.map(np.asarray, var["batch_stats"]))
        if noise is None or net is not gan.net_G:
            _assert_state(label, net, state)
            continue
        scale = max(np.linalg.norm(r) for r in ref.values())
        lr = s.state.gan.opt_G.param_groups[0]["lr"]
        for k, r in ref.items():
            if np.linalg.norm(r) <= 1e-12 * scale:
                noise[k] = noise.get(k, 0.0) + 2 * lr * 2e-12 * scale / 1e-8
        _assert_state(label, net, {k: v for k, v in state.items() if k not in noise})
        got = net.state_dict()
        for k in noise:
            err = float(np.abs(got[k].numpy() - np.asarray(state[k])).max())
            assert err <= 1e-10 + noise[k], f"{label} {k}: {err:.3g}"


def _assert_losses(errs, jerrs):
    for k in ("loss_cl", "G", "D", "loss"):
        assert abs(float(errs[k]) - float(jerrs[k])) <= 1e-9 * abs(float(jerrs[k])), k


def test_train_all_bip_step_matches_jax(monkeypatch):
    """One bip step: the losses within 1e-9 relative; the encoder's (both
    branches), G's and D's gradients (``_assert_grads``); the parameters
    after Adam within 1e-10; running stats within 1e-6 relative; the bank
    after the fold of ``feat + feat2`` within 1e-10."""
    from reid_gan_torch.ops.transforms import gan_input_transform

    s = _bip_setup(monkeypatch)
    batch, _ = _batch(41, size=(H, W, GH, GW))
    dev = {k: torch.from_numpy(batch[k]) for k in ("img", "pid", "Xs")}
    xs = gan_input_transform(dev["Xs"], GH, GW)
    before = s.state.memory.features.clone()
    s.state, errs = s.trainer.train_all_bip_step(s.state, dev, 33)
    with jax.enable_x64(True):
        s.jstate, jerrs = s.jt._get_step("train_all_bip")(
            s.jstate, {"img": _nhwc64(s.seen["x"]), "pid": jnp.asarray(batch["pid"]),
                       "Xs": _nhwc64(xs)}, np.int32(33))
    _assert_losses(errs, jerrs)
    params = {n for n, p in s.model.named_parameters() if p.requires_grad}
    enc_ref = _variant_named(s.jstate.enc_opt[0]["g"], s.jstate.enc_batch_stats)
    _assert_grads("bip encoder", _port_grads(s.model),
                  {k: v for k, v in enc_ref.items() if k in params})
    assert all(np.abs(_port_grads(s.model)[k]).max() > 0
               for k in ("p1_l4.0.conv1.weight", "p2_l4.0.conv1.weight"))
    _assert_state("bip encoder", s.model,
                  _variant_named(s.jstate.enc_params, s.jstate.enc_batch_stats))
    _assert_gan("bip", s)
    bank = s.state.memory.features.numpy()
    np.testing.assert_allclose(bank, np.asarray(s.jstate.memory.features), rtol=0,
                               atol=1e-10)
    touched = np.unique(batch["pid"])
    assert not np.array_equal(bank[touched], before.numpy()[touched])
    assert s.state.step == s.state.gan.step == 1


# ---------------------------------------------------------------------------
# train_all_with_memory
# ---------------------------------------------------------------------------

def test_train_all_with_memory_steps_match_jax(monkeypatch):
    """Two memory steps in a row from clusters that are not unit rows: at
    each step the losses within 1e-9 relative, the encoder's, G's and D's
    gradients, parameters within 1e-10, running stats within 1e-6
    relative, the clusters within 1e-10 (each touched row moved by
    cluster_lr, untouched rows bit-equal), and the momentum bank as it
    was. The G render's input is constant over the map, which leaves G's
    first bias (ahead of a BatchNorm) a rounding gradient of ~1e-15 that
    Adam amplifies: those parameters are held as ``_assert_gan`` states."""
    from reid_gan_tpu.ops.cluster_memory import GradientMemoryState as JaxGM
    from reid_gan_torch.ops.cluster_memory import init_gradient_memory
    from reid_gan_torch.ops.pose import batch_cords_to_map
    from reid_gan_torch.ops.transforms import gan_input_transform

    from test_torch_port_joint import _enc_named

    s = joint_setup(monkeypatch)
    s.trainer.augment = lambda img, seed: s.augment(img, seed, _k_aug)
    rng = np.random.RandomState(26)
    clusters = rng.randn(NV, D) * rng.uniform(0.5, 2.0, (NV, 1))
    gmem = init_gradient_memory(clusters, k_pad=K_PAD, device="cpu")
    with jax.enable_x64(True):
        jgmem = JaxGM(jnp.asarray(np.pad(clusters, ((0, K_PAD - NV), (0, 0)))),
                      jnp.int32(NV))
        assert jgmem.clusters.dtype == jnp.float64
    bank = s.state.memory.features.clone()
    lr, noise = 0.1, {}
    for step_i, seed in enumerate((34, 35)):
        batch, _ = _batch(60 + step_i)
        dev = {k: torch.from_numpy(v) for k, v in batch.items()}
        xs = gan_input_transform(dev["Xs"], GH, GW)
        ps = batch_cords_to_map(dev["keypoints"], dev["old_size"], GH, GW)
        prev = gmem.clusters.clone()
        s.state, gmem, errs = s.trainer.train_all_with_memory_step(s.state, gmem, dev,
                                                                   seed, lr)
        with jax.enable_x64(True):
            s.jstate, jgmem, jerrs = s.jt._get_step("train_all_with_memory")(
                s.jstate, jgmem, {"img": _nhwc64(s.seen["x"]),
                                  "pid": jnp.asarray(batch["pid"]), "Xs": _nhwc64(xs),
                                  "Ps": _nhwc64(ps)},
                np.int32(seed), jnp.asarray(lr, jnp.float64))
        _assert_losses(errs, jerrs)
        enc_ref = _enc_named(s, s.jstate.enc_opt[0]["g"])
        _assert_grads(f"memory step {step_i} encoder", _port_grads(s.model),
                      {k: v for k, v in enc_ref.items()
                       if k in dict(s.model.named_parameters()) and k != "feat_bn.bias"})
        _assert_state(f"memory step {step_i} encoder", s.model,
                      _enc_named(s, s.jstate.enc_params))
        _assert_gan(f"memory step {step_i}", s, noise)
        got = gmem.clusters.numpy()
        np.testing.assert_allclose(got, np.asarray(jgmem.clusters), rtol=0, atol=1e-10)
        touched = np.zeros(K_PAD, bool)
        touched[batch["pid"]] = True
        moved = np.linalg.norm(got - prev.numpy(), axis=1)
        np.testing.assert_allclose(moved[touched], lr, rtol=1e-9)
        assert np.array_equal(got[~touched], prev.numpy()[~touched])
    assert torch.equal(s.state.memory.features, bank)
    np.testing.assert_array_equal(np.asarray(s.jstate.memory.features), bank.numpy())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _bip18(monkeypatch):
    """``cli/train_gan_usl``'s factory with ``resnet_bip50`` built at depth
    18 (the smallest ``ResNetBip`` both packages build), so that the CPU
    runs stay short."""
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.models.resnet_variants import ResNetBip

    create = train_gan_usl.create_model

    def create_model(name, *args, dtype=None, **kwargs):
        if name != "resnet_bip50":
            return create(name, *args, dtype=dtype, **kwargs)
        from reid_gan_torch.models.precision import set_compute_dtype

        return set_compute_dtype(ResNetBip(18, *args, **kwargs), dtype)

    monkeypatch.setattr(train_gan_usl, "create_model", create_model)


_GAN = ["--model", "AE", "--gan-height", "32", "--gan-width", "16"]
CLI_CASES = {
    "bipath": ["--bipath", "--arch", "resnet_bip50", "--model-gen", "AE", "--debug"],
    "bipath_fp16": ["--bipath", "--arch", "resnet_bip50", "--model-gen", "AE", "--debug",
                    "--fp16"],
    "learnable_memory": ["--learnable-memory", "--model-gen", "Pose", "--epochs", "2",
                         "--iters", "2", "--cluster-with-gan-features",
                         "--cluster-lr", "0.05"],
    "learnable_memory_fp16": ["--learnable-memory", "--model-gen", "Pose", "--debug",
                              "--fp16"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_mode_runs_end_to_end_through_the_cli(tmp_path, monkeypatch, capsys, case):
    """``main(... --device cpu)`` on the synthetic set runs the mode (its
    losses logged), evaluates, and writes the checkpoints, ``latest_net_G``,
    ``latest_net_D`` and ``iter.txt`` after each epoch (the repaired save
    block: JAX train_gan_usl.py:249-258). The learnable-memory case runs
    two epochs with GAN-feature clustering: the confidence weights are
    computed in the second, as JAX computes them, and not read."""
    from reid_gan_torch.cli.train_gan_usl import main
    from reid_gan_torch.engine import gan_trainers

    _bip18(monkeypatch)
    seen = []
    run_epoch = gan_trainers.ClusterContrastWithGANTrainer.run_epoch

    def spy(self, state, epoch, loader, mode="train_all", **kw):
        seen.append((mode, kw.get("gmem") is not None, kw.get("cluster_lr")))
        return run_epoch(self, state, epoch, loader, mode=mode, **kw)

    monkeypatch.setattr(gan_trainers.ClusterContrastWithGANTrainer, "run_epoch", spy)
    flags = CLI_CASES[case]
    logs, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    best = main(_FLAGS + _GAN + flags + ["--data-dir", str(tmp_path), "--eval-step", "1",
                                         "--save-dir", str(ckpt), "--logs-dir", str(logs),
                                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert 0.0 <= best <= 1.0 and "Test with the best model" in out
    epochs = 1 if "--debug" in flags else 2
    mode = "train_all_bip" if "--bipath" in flags else "train_all_with_memory"
    lr = 0.05 if "--cluster-lr" in flags else 0.1
    assert seen == [(mode, mode == "train_all_with_memory", lr)] * epochs
    for f in ("checkpoint.pth.tar", "model_best.pth.tar", "loss_log.txt"):
        assert osp.exists(logs / f), f
    for f in ("latest_net_G.pth", "latest_net_D.pth"):
        assert osp.exists(ckpt / "experiment" / f), f
    with open(ckpt / "experiment" / "iter.txt") as fh:
        assert fh.read().strip() == f"{epochs},0"
    with open(logs / "loss_log.txt") as fh:
        line = fh.read().splitlines()[-1]
    assert f"(epoch: {epochs - 1}," in line
    assert all(f"{k}: " in line for k in ("loss", "loss_cl", "G", "D"))
    assert ("calculate confidence weight" in out) == ("--cluster-with-gan-features" in flags)
