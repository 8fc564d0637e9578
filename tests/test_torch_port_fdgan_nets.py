"""Port parity for FD-GAN's nets in fp64, weights drawn with numpy into the
JAX trees and carried across by the port's converters: ``CustomPoseGenerator``
(every ``connect_layers`` 0-5, both ``fuse_mode``s; train mode, its output
and running stats; dropout with the JAX step's keep masks),
``NLayerDiscriminator`` (train mode, three forwards), the Siamese net
(``FDResNet`` + ``EltwiseSubEmbed``) in train and eval mode, the ``_di_from_e``
bootstrap, ``gan_loss_bce`` and ``lambda_rule``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

H, W = 64, 32
REID, NOISE, PFEAT, NGF = 48, 8, 16, 8


def random_tree(shapes, seed):
    """A JAX variable tree of ``shapes`` (from ``jax.eval_shape``) drawn
    with numpy in fp64: kernels by 1/sqrt(fan-in), BatchNorm scales and
    variances in [0.5, 1.5), biases and means near 0."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return rng.randn(*leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        if "scale" in name or "var" in name:
            return rng.rand(*leaf.shape) + 0.5
        return rng.randn(*leaf.shape) * 0.1

    return jax.tree_util.tree_map_with_path(draw, shapes)


def generator_pair(seed, connect_layers=2, fuse_mode="cat", drop=0.0, reid=REID, ngf=NGF):
    """(JAX module, its fp64 variables, the port's fp64 generator with them)."""
    from reid_gan_tpu.models.fdgan.networks import CustomPoseGenerator as JaxG
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.fdgan.networks import CustomPoseGenerator

    jg = JaxG(pose_feature_nc=PFEAT, reid_feature_nc=reid, noise_nc=NOISE, dropout=drop,
              fuse_mode=fuse_mode, connect_layers=connect_layers, ngf=ngf)
    shapes = jax.eval_shape(
        lambda k: jg.init({"params": k, "dropout": k}, jnp.zeros((2, H, W, 18)),
                          jnp.zeros((2, reid)), jnp.zeros((2, NOISE)), train=True),
        jax.random.PRNGKey(0))
    v = random_tree(shapes, seed)
    g = CustomPoseGenerator(pose_feature_nc=PFEAT, reid_feature_nc=reid, noise_nc=NOISE,
                            dropout=drop, fuse_mode=fuse_mode, connect_layers=connect_layers,
                            ngf=ngf, height=H, width=W).double()
    g.load_state_dict(state_dict_from_jax(g, v["params"], v["batch_stats"]))
    return jg, v, g


def discriminator_pair(seed, ndf=8):
    from reid_gan_tpu.models.fdgan.networks import NLayerDiscriminator as JaxD
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.fdgan.networks import NLayerDiscriminator

    jd = JaxD(input_nc=21, ndf=ndf)
    shapes = jax.eval_shape(lambda k: jd.init(k, jnp.zeros((2, H, W, 21)), train=True),
                            jax.random.PRNGKey(0))
    v = random_tree(shapes, seed)
    d = NLayerDiscriminator(input_nc=21, ndf=ndf).double()
    d.load_state_dict(state_dict_from_jax(d, v["params"], v["batch_stats"]))
    return jd, v, d


def siamese_pair(seed, num_classes=2):
    """(JAX SiameseNet at depth 18, fp64 variables, the port's fp64 net)."""
    from reid_gan_tpu.models.fdgan.model import _siamese
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax
    from reid_gan_torch.models.multi_branch import siamese_net

    js = _siamese(num_classes, depth=18)
    shapes = jax.eval_shape(lambda k: js.init(k, jnp.zeros((2, H, W, 3)),
                                              jnp.zeros((2, H, W, 3)), train=False),
                            jax.random.PRNGKey(0))
    v = random_tree(shapes, seed)
    net = siamese_net(18, num_classes).double()
    net.load_state_dict(siamese_state_dict_from_jax(v["params"], v["batch_stats"]))
    return js, v, net


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def assert_stats(module, ref_sd, rtol=1e-6):
    """Running stats within 1e-6 relative and 1e-7 absolute: the JAX side
    folds and stores them in fp32 under x64 too (ROADMAP C), so a mean that
    cancels to near 0 keeps the fp32 rounding of its terms."""
    got = module.state_dict()
    for k, r in ref_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=rtol, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("connect_layers,fuse_mode",
                         [(0, "cat"), (1, "cat"), (2, "cat"), (3, "add"), (4, "cat"),
                          (5, "add")])
def test_generator_train_forward_matches_jax(connect_layers, fuse_mode):
    """Train mode: the fake within 1e-10 and every running stat after the
    fold within 1e-6 relative (fp32 on the JAX side)."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    jg, v, g = generator_pair(30 + connect_layers, connect_layers, fuse_mode)
    rng = np.random.RandomState(31)
    pose, reid, noise = rng.rand(4, H, W, 18), rng.randn(4, REID), rng.randn(4, NOISE)
    with jax.enable_x64(True):
        fake, mut = jg.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(pose),
                             jnp.asarray(reid), jnp.asarray(noise), train=True,
                             mutable=["batch_stats"])
        ref_sd = state_dict_from_jax(g, v["params"], jax.tree.map(np.asarray,
                                                                  mut["batch_stats"]))
    out = g.train()(nchw(pose), torch.from_numpy(reid), torch.from_numpy(noise))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(fake),
                               rtol=0, atol=1e-10)
    assert_stats(g, ref_sd)


def test_generator_dropout_with_the_jax_keep_masks_matches_jax(monkeypatch):
    """Dropout 0.2: the keep masks JAX's ``nn.Dropout`` draws (recorded from
    ``jax.random.bernoulli``), handed to the port's generator in NCHW, give
    the same fake within 1e-10."""
    jg, v, g = generator_pair(40, 2, "cat", drop=0.2)
    rng = np.random.RandomState(41)
    pose, reid, noise = rng.rand(4, H, W, 18), rng.randn(4, REID), rng.randn(4, NOISE)
    masks = []
    bernoulli = jax.random.bernoulli

    def recording(key, p=0.5, shape=None):
        out = bernoulli(key, p, shape)
        masks.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    with jax.enable_x64(True):
        fake, _ = jg.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(pose),
                           jnp.asarray(reid), jnp.asarray(noise), train=True,
                           rngs={"dropout": jax.random.PRNGKey(3)}, mutable=["batch_stats"])
    assert len(masks) == 5 and all(0.6 < m.mean() < 0.95 for m in masks)
    out = g.train()(nchw(pose), torch.from_numpy(reid), torch.from_numpy(noise),
                    masks=[nchw(m) for m in masks])
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(fake),
                               rtol=0, atol=1e-10)
    drawn = g(nchw(pose), torch.from_numpy(reid), torch.from_numpy(noise),
              generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(drawn, out)


def test_discriminator_three_train_forwards_match_jax():
    """Dp in train mode on three inputs in a row (as a step's D real, D fake
    and G forwards): each output within 1e-10, the running stats after the
    three folds within 1e-9 relative."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    jd, v, d = discriminator_pair(50)
    rng = np.random.RandomState(51)
    xs = [rng.rand(4, H, W, 21) * 2 - 1 for _ in range(3)]
    with jax.enable_x64(True):
        var = jax.tree.map(jnp.asarray, v)
        refs = []
        for x in xs:
            out, mut = jd.apply(var, jnp.asarray(x), train=True, mutable=["batch_stats"])
            refs.append(np.asarray(out))
            var = {"params": var["params"], "batch_stats": mut["batch_stats"]}
        ref_sd = state_dict_from_jax(d, v["params"], jax.tree.map(np.asarray,
                                                                  var["batch_stats"]))
    d.train()
    for x, ref in zip(xs, refs):
        np.testing.assert_allclose(d(nchw(x)).detach().permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=0, atol=1e-10)
    assert_stats(d, ref_sd)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_siamese_net_matches_jax(train):
    """The Siamese net (weight-tied FDResNet-18 on both inputs, square
    difference, BN1d, classifier): features and logits within 1e-9; in
    train mode the running stats after the two base folds and the head's
    within 1e-6 relative."""
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax

    js, v, net = siamese_pair(60)
    rng = np.random.RandomState(61)
    x1, x2 = rng.randn(4, H, W, 3), rng.randn(4, H, W, 3)
    with jax.enable_x64(True):
        out = js.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x1), jnp.asarray(x2),
                       train=train, mutable=["batch_stats"] if train else False)
        (f1, f2, logits), mut = out if train else (out, None)
        ref = [np.asarray(a) for a in (f1, f2, logits)]
        if train:
            ref_sd = siamese_state_dict_from_jax(v["params"], jax.tree.map(
                np.asarray, mut["batch_stats"]))
    net.train(train)
    got = net(nchw(x1), nchw(x2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-9, atol=1e-9)
    assert got[2].shape == (4, 2)
    if train:
        assert_stats(net, ref_sd)


def test_di_from_e_matches_jax():
    """Di from E's state: the classifier's positive row, all else copied, as
    JAX's ``_di_from_e``."""
    from reid_gan_tpu.models.fdgan.model import FDGANModel as JaxModel
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax
    from reid_gan_torch.models.fdgan.model import FDGANModel

    _, ve, net_e = siamese_pair(70, 2)
    js_di, vdi, _ = siamese_pair(71, 1)
    ref = JaxModel._di_from_e(ve, vdi)
    want = siamese_state_dict_from_jax(ref["params"], ref["batch_stats"])
    got = FDGANModel._di_from_e(net_e.state_dict())
    assert set(got) == set(want)
    for k, r in want.items():
        np.testing.assert_array_equal(got[k].numpy(), r.numpy(), err_msg=k)
    assert got["embed_model.classifier.weight"].shape == (1, 512)


@pytest.mark.parametrize("smooth", [False, True])
def test_gan_loss_and_lambda_rule_match_jax(smooth):
    from reid_gan_tpu.models.fdgan.losses import gan_loss_bce as jax_loss
    from reid_gan_tpu.models.fdgan.model import lambda_rule as jax_rule
    from reid_gan_torch.models.fdgan.losses import gan_loss_bce
    from reid_gan_torch.models.fdgan.model import lambda_rule

    logits = np.random.RandomState(80).randn(4, 1, 6, 2) * 5
    key = jax.random.PRNGKey(81)
    with jax.enable_x64(True):
        u = float(jax.random.uniform(key, ()))
        for real in (True, False):
            ref = float(jax_loss(key, jnp.asarray(logits), real, smooth))
            got = float(gan_loss_bce(torch.from_numpy(logits), real, smooth, u))
            assert abs(got - ref) <= 1e-12 * abs(ref), (real, got, ref)
    for e in (0, 10, 48, 49, 60, 99):
        assert lambda_rule(e, 50, 50) == jax_rule(e, 50, 50)
