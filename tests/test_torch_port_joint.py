"""Port parity for the slice as a whole: the port's
``ClusterContrastWithGANTrainer`` against the JAX trainer's jitted steps, in
fp64, at the JAX smoke shapes (resnet18 at 32x16, GAN 16x8 with ngf 8 and
img_f 32, batch 8 in 4 groups of 2, a bank of 8 live rows of 256).

Two ``train_all`` steps, then one ``train_reid`` step. The port's step runs
whole: K4's plain version on JAX's draws from the step's ``k_aug``, K9's and
K10's plain versions, the encoder, G, D, the losses, Adam and the fold. The
JAX step gets the port's augmented image, GAN image and pose maps as its
batch, in fp64 as the port's step casts them (its in-step transforms
replaced by the identity): the transforms' own parity is held in test_torch_port_augment.py and
test_torch_port_gan_ops.py, and XLA's fused programs round them otherwise by
an ulp. The JAX gradients are read from the step itself through a
pass-through optax transform (as tests/test_joint_parity_oracle.py)."""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from test_torch_port_augment import _jax_draws
from test_torch_port_gan_nets import gan_variables, jax_gan
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _jax_named, _port_model, _random_variables

H, W, GH, GW = 32, 16, 16, 8
B, GROUP, NV, K_PAD, D = 8, 2, 8, 256, 512


def _capture():
    """Pass-through optax transform whose state keeps the last gradients."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


def _batch(seed, size=(H, W, GH, GW)):
    """A ``train_all`` batch of uint8 images at (h, w) and GAN images at
    (gh, gw) (``size``), keypoints and conf weights."""
    h, w, gh, gw = size
    rng = np.random.RandomState(seed)
    old = np.tile(np.asarray([[64, 32]], np.float32), (B, 1))
    kp = np.stack([rng.uniform(0, 64, (B, 18)), rng.uniform(0, 32, (B, 18))], -1)
    kp[rng.rand(B, 18) < 0.2] = -1
    return {"img": rng.randint(0, 256, (B, h, w, 3)).astype(np.uint8),
            "pid": np.repeat(rng.permutation(NV)[:B // GROUP], GROUP).astype(np.int32),
            "Xs": rng.randint(0, 256, (B, gh, gw, 3)).astype(np.uint8),
            "keypoints": kp.astype(np.float32), "old_size": old}, \
        (rng.rand(B) < 0.75).astype(np.float32)


def _nhwc64(t):
    """A port NCHW float32 batch as the NHWC float64 array the port's step
    casts it to (the JAX nets would otherwise pool the fp32 image in fp32)."""
    return jnp.asarray(t.permute(0, 2, 3, 1).double().numpy())


def _assert_grads(name, got, ref):
    """Each gradient within 1e-9 of its norm, plus 1e-12 of the net's largest
    gradient norm (both as vector norms of the difference): a gradient that
    is zero in exact arithmetic, as a convolution bias ahead of a BatchNorm
    (which subtracts the batch mean), is rounding on both sides."""
    assert set(got) == set(ref), name
    scale = max(np.linalg.norm(r) for r in ref.values())
    for k, r in ref.items():
        err = np.linalg.norm(got[k] - r)
        assert err <= 1e-9 * np.linalg.norm(r) + 1e-12 * scale, \
            f"{name} {k}: |g - r| {err:.3g}, |r| {np.linalg.norm(r):.3g}"


def _assert_state(name, module, ref):
    """Parameters within 1e-10; running stats within 1e-6 relative (fp32 on
    the JAX side, ROADMAP C); spectral u/sigma within 1e-9."""
    got = module.state_dict()
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
        np.testing.assert_allclose(got[k].numpy(), r, err_msg=f"{name} {k}", **tol)


def joint_setup(monkeypatch, gan_bank=None, size=(H, W, GH, GW), vgg_params=None):
    """The port's trainer and the JAX trainer from the same weights (resnet18,
    the pose G and D, fp64) and bank, with a GAN bank of ``gan_bank`` rows
    where given, images at (h, w) and the GAN at (gh, gw) (``size``), and
    with ``vgg_params`` (a JAX VGG19 tree) ``use_vgg`` on both sides; the
    JAX step's in-step transforms replaced by the identity and its gradients
    captured. Returns a namespace with the port's ``model``, ``gan``,
    ``trainer``, ``state``, the JAX ``jt``, ``jstate``, and ``size``;
    ``seen["x"]`` is the port's last augmented batch."""
    from types import SimpleNamespace

    from reid_gan_tpu.engine import gan_trainers as jax_gan_trainers
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.dual_gan.external_function import VGG19
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.transforms import train_augment

    h, w, gh, gw = size
    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(20))
    jgan = jax_gan(gh=gh, gw=gw, vgg_params=vgg_params)
    G, Dv = gan_variables(jgan, 21)
    rng = np.random.RandomState(22)
    bank = rng.randn(NV, D)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)

    # ---- the port
    model = _port_model(params, stats, torch.float64)
    vgg = {} if vgg_params is None else dict(use_vgg=True, lambda_style=500.0,
                                             lambda_content=0.5)
    gan = AEModel(GANConfig(model="AE", model_gen="Pose", **vgg),
                  gan_height=gh, gan_width=gw, num_feats=32, ngf=8, reid_feat_dim=D,
                  vgg_params=None if vgg_params is None else state_dict_from_jax(
                      VGG19(), vgg_params), device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    if gan.vgg is not None:
        gan.vgg.double()
    trainer = ClusterContrastWithGANTrainer(model, gan, height=h, width=w,
                                            num_instances=GROUP, device="cpu")
    seen = {}

    def augment(img, seed, key_of=lambda s: jax.random.split(jax.random.PRNGKey(s), 3)[0]):
        draws = _jax_draws(key_of(seed), img.shape[0], h, w)
        seen["x"] = train_augment(img, torch.from_numpy(draws), h, w)
        return seen["x"]

    trainer.augment = augment
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, gan_centroids=gan_bank,
                                           device="cpu"), gan.init_state())

    # ---- JAX: the in-step transforms give back what the batch carries
    monkeypatch.setattr(jax_gan_trainers, "reid_augment",
                        lambda key, img, height=None, width=None, train=None: img)
    monkeypatch.setattr(jax_gan_trainers, "gan_input_transform", lambda img, h, w: img)
    with jax.enable_x64(True):
        jt = jax_gan_trainers.ClusterContrastWithGANTrainer(
            jmodel, jgan, height=h, width=w, num_instances=GROUP)
        jt.tx = optax.chain(_capture(), jt.tx)
        jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
        jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
        to64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        jgs = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                      opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
        jstate = jt.init_state({"params": to64(params), "batch_stats": to64(stats)},
                               jgs, jax_init_memory(bank, k_pad=K_PAD, gan_centroids=gan_bank))
    return SimpleNamespace(model=model, gan=gan, trainer=trainer, state=state, jt=jt,
                           jstate=jstate, seen=seen, augment=augment, size=size)


def _port_grads(module):
    return {n: p.grad.numpy() for n, p in module.named_parameters() if p.grad is not None}


def _enc_named(s, tree):
    return _jax_named(jax.tree.map(np.asarray, tree),
                      jax.tree.map(np.asarray, s.jstate.enc_batch_stats))


def train_all_step_matches_jax(s, step_i, seed, batch, conf):
    """One ``train_all`` step of ``joint_setup``'s pair on ``batch`` with
    the weights ``conf``, held as the test below states: the losses, the
    encoder's, G's and D's gradients, the parameters and buffers, and the
    bank and the GAN bank (within 1e-10)."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.ops.pose import batch_cords_to_map
    from reid_gan_torch.ops.transforms import gan_input_transform

    _, _, gh, gw = s.size
    dev = {k: torch.from_numpy(v) for k, v in batch.items()}
    xs = gan_input_transform(dev["Xs"], gh, gw)
    ps = batch_cords_to_map(dev["keypoints"], dev["old_size"], gh, gw)
    s.state, errs = s.trainer.train_all_step(s.state, dev, seed, torch.from_numpy(conf))
    with jax.enable_x64(True):
        s.jstate, jerrs = s.jt._get_step("train_all")(
            s.jstate, {"img": _nhwc64(s.seen["x"]), "pid": jnp.asarray(batch["pid"]),
                       "Xs": _nhwc64(xs), "Ps": _nhwc64(ps)},
            np.int32(seed), jnp.asarray(conf))
    for k in ("loss_cl", "G", "D", "loss"):
        assert abs(float(errs[k]) - float(jerrs[k])) <= 1e-9 * abs(float(jerrs[k])), k
    model, gan = s.model, s.gan
    enc_ref = _enc_named(s, s.jstate.enc_opt[0]["g"])
    _assert_grads(f"step {step_i} encoder", _port_grads(model),
                  {k: v for k, v in enc_ref.items() if k in dict(model.named_parameters())
                   and k != "feat_bn.bias"})
    g_ref = jax.tree.map(np.asarray, s.jstate.gan.opt_G[0]["g"])
    d_ref = jax.tree.map(np.asarray, s.jstate.gan.opt_D[0]["g"])
    _assert_grads(f"step {step_i} G", _port_grads(gan.net_G),
                  {k: v.numpy() for k, v in state_dict_from_jax(gan.net_G, g_ref).items()})
    _assert_grads(f"step {step_i} D", _port_grads(gan.net_D),
                  {k: v.numpy() for k, v in state_dict_from_jax(gan.net_D, d_ref).items()})
    _assert_state(f"step {step_i} encoder", model, _enc_named(s, s.jstate.enc_params))
    for net, var in ((gan.net_G, s.jstate.gan.G), (gan.net_D, s.jstate.gan.D)):
        _assert_state(f"step {step_i} {type(net).__name__}", net,
                      state_dict_from_jax(net, jax.tree.map(np.asarray, var["params"]),
                                          jax.tree.map(np.asarray, var["batch_stats"])))
    for name in ("features", "gan_features"):
        np.testing.assert_allclose(getattr(s.state.memory, name).numpy(),
                                   np.asarray(getattr(s.jstate.memory, name)), rtol=0,
                                   atol=1e-10, err_msg=name)


def test_train_all_and_train_reid_steps_match_jax(monkeypatch):
    """At each step: the losses (loss_cl, G, D; the train_reid loss) within
    1e-9 relative; the encoder's, G's and D's gradients (``_assert_grads``);
    the parameters after Adam within 1e-10; G's and the
    encoder's running stats within 1e-6 relative; D's spectral u/sigma within
    1e-9; the bank within 1e-10."""
    s = joint_setup(monkeypatch)
    for step_i, seed in enumerate((30, 31)):
        batch, conf = _batch(40 + step_i)
        train_all_step_matches_jax(s, step_i, seed, batch, conf)
    assert s.state.step == s.state.gan.step == 2

    # ---- one train_reid (warm-up) step from there
    batch, _ = _batch(50)
    s.trainer.augment = lambda img, seed: s.augment(img, seed, jax.random.PRNGKey)
    state, loss = s.trainer.step(s.state, torch.from_numpy(batch["img"]),
                                 torch.from_numpy(batch["pid"]), 32)
    with jax.enable_x64(True):
        jstate, jerrs = s.jt._get_step("train_reid")(
            s.jstate, {"img": _nhwc64(s.seen["x"]), "pid": jnp.asarray(batch["pid"])},
            np.int32(32))
    assert abs(float(loss) - float(jerrs["loss"])) <= 1e-9 * abs(float(jerrs["loss"]))
    s.jstate = jstate
    enc_ref = _enc_named(s, jstate.enc_opt[0]["g"])
    _assert_grads("train_reid encoder", _port_grads(s.model),
                  {k: v for k, v in enc_ref.items() if k in dict(s.model.named_parameters())
                   and k != "feat_bn.bias"})
    _assert_state("train_reid encoder", s.model, _enc_named(s, jstate.enc_params))
    np.testing.assert_allclose(state.memory.features.numpy(),
                               np.asarray(jstate.memory.features), rtol=0, atol=1e-10)
