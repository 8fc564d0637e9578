"""Port parity for the joint recipe's GAN: ``PoseGenerator1`` and
``ResDiscriminator`` train-mode forwards in fp64 against the JAX nets with
weights carried across by ``models/dual_gan/convert.py`` (outputs, G's
BatchNorm running stats, D's spectral ``u``/``sigma``), D's eval forward,
``gan_loss`` in its four modes, the WGAN-GP penalty, and the engine's
defaults.

The JAX smoke shapes (tests/test_joint_smoke.py): GAN 16x8, ngf 8, img_f 32,
a 512-channel re-ID map at 2x1, batch 8. Weights are drawn with numpy in the
JAX trees (``jax.eval_shape`` gives them without compiling ``init``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

GH, GW, B, REID = 16, 8, 8, 512


def jax_gan(gan_mode="lsgan"):
    from reid_gan_tpu.config import GANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel

    return AEModel(GANConfig(model="AE", model_gen="Pose", gan_mode=gan_mode),
                   gan_height=GH, gan_width=GW, num_feats=32, ngf=8, num_blocks=1,
                   reid_feat_dim=REID)


def gan_variables(gan, seed):
    """(G, D) JAX variable trees for ``gan`` drawn with numpy in fp64:
    kernels scaled by 1/sqrt(fan-in), BatchNorm scales and variances in
    [0.5, 1.5), biases and means near 0, spectral ``u`` normal, ``sigma``
    1."""
    shapes = jax.eval_shape(gan.init_state, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name and len(leaf.shape) >= 2:
            return rng.randn(*leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        if "scale" in name or "var" in name:
            return rng.rand(*leaf.shape) + 0.5
        if "sigma" in name:
            return np.ones(leaf.shape)
        if "/u" in name:
            return rng.randn(*leaf.shape)
        return rng.randn(*leaf.shape) * 0.1

    return (jax.tree_util.tree_map_with_path(draw, shapes.G),
            jax.tree_util.tree_map_with_path(draw, shapes.D))


def port_nets(G, D):
    """The port's G and D in fp64 with the JAX variables loaded."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.dual_gan.networks import define_D, define_G

    g = define_G("Pose", pose_nc=18, ngf=8, img_f=32, reid_nc=REID).double()
    d = define_D().double()
    g.load_state_dict(state_dict_from_jax(g, G["params"], G["batch_stats"]), strict=True)
    d.load_state_dict(state_dict_from_jax(d, D["params"], D["batch_stats"]), strict=True)
    return g, d


def assert_stats_match(net, jax_stats, name):
    """Running mean/var within 1e-6 relative (fp32 on the JAX side, ROADMAP
    C); spectral ``u``/``sigma`` within 1e-9."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    ref = state_dict_from_jax(net, {}, jax.tree.map(np.asarray, jax_stats))
    got = net.state_dict()
    assert ref
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-6, atol=1e-7) if "running" in k else dict(rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=f"{name} {k}", **tol)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_pose_generator_and_discriminator_train_forwards_match_jax():
    """fp64 train-mode forwards: the fake image within 1e-9 and G's running
    stats after it; D's scores within 1e-9 and its ``u``/``sigma`` after the
    power iteration; then an eval forward of D, which iterates from the
    stored ``u`` and stores nothing."""
    gan = jax_gan()
    G, D = gan_variables(gan, 0)
    rng = np.random.RandomState(1)
    fmap = rng.randn(B, GH // 8, GW // 8, REID)
    pose = rng.rand(B, GH, GW, 18)
    img = rng.rand(B, GH, GW, 3) * 2 - 1
    with jax.enable_x64(True):
        @jax.jit
        def fwd(G, D, fmap, pose, img):
            fake, g_bs = gan.apply_G(G, fmap, pose, train=True, mutable=True)
            pred, d_bs = gan.apply_D(D, img, train=True, mutable=True)
            pred_eval = gan.apply_D(D, img, train=False)
            return fake, g_bs, pred, d_bs, pred_eval

        fake, g_bs, pred, d_bs, pred_eval = jax.tree.map(
            np.asarray, fwd(G, D, fmap, pose, img))
    g, d = port_nets(G, D)
    g.train()
    d.eval()
    with torch.no_grad():
        got_eval = d(_nchw(img))
    before = {k: v.clone() for k, v in d.state_dict().items()}
    d.train()
    with torch.no_grad():
        got_fake = g(_nchw(fmap), _nchw(pose))
        got_pred = d(_nchw(img))
    np.testing.assert_allclose(got_eval.numpy().transpose(0, 2, 3, 1), pred_eval,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_fake.numpy().transpose(0, 2, 3, 1), fake,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_pred.numpy().transpose(0, 2, 3, 1), pred,
                               rtol=0, atol=1e-9)
    assert_stats_match(g, g_bs, "G")
    assert_stats_match(d, d_bs, "D")
    assert not torch.equal(before["block0.conv1.u"], d.state_dict()["block0.conv1.u"])


@pytest.mark.parametrize("transpose", [False, True])
def test_spectral_convs_match_flax(transpose):
    """``SpectralConv`` and ``SpectralConvTranspose`` with spectral norm on:
    one train forward (output, then the stored u/sigma) and one eval forward
    (iterates from the stored u, stores nothing), fp64, within 1e-12."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    cin, cout = 5, 6
    if transpose:
        jmod = jbf.SpectralConvTranspose(cout, (3, 3), (2, 2), use_spect=True)
        mod = bf.SpectralConvTranspose(cin, cout, 3, 2, use_spect=True).double()
    else:
        jmod = jbf.SpectralConv(cout, (4, 4), (2, 2), padding=1, use_spect=True)
        mod = bf.SpectralConv(cin, cout, 4, 2, 1, use_spect=True).double()
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 4, cin)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, train=True))
    v = jax.tree.map(lambda leaf: rng.randn(*leaf.shape), shapes)
    with jax.enable_x64(True):
        y, mut = jmod.apply(v, x, train=True, mutable=["batch_stats"])
        y_eval = jmod.apply(v, x, train=False)
    mod.load_state_dict(state_dict_from_jax(mod, v["params"], v["batch_stats"]))
    with torch.no_grad():
        got_eval = mod.eval()(_nchw(x))
        got = mod.train()(_nchw(x))
    np.testing.assert_allclose(got_eval.numpy().transpose(0, 2, 3, 1), y_eval,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), y, rtol=0, atol=1e-12)
    assert_stats_match(mod, mut["batch_stats"], type(mod).__name__)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "hinge", "wgangp"])
def test_gan_loss_modes_match_jax(mode):
    """Every mode, real and fake targets, the discriminator's and the
    generator's reduction: within 1e-12."""
    from reid_gan_tpu.models.dual_gan.external_function import gan_loss as jax_loss
    from reid_gan_torch.models.dual_gan.external_function import gan_loss

    pred = np.random.RandomState(2).randn(B, 2, 1, 1) * 2
    with jax.enable_x64(True):
        for real in (True, False):
            for disc in (True, False):
                ref = np.asarray(jax_loss(jnp.asarray(pred.transpose(0, 2, 3, 1)),
                                          real, disc, mode))
                got = gan_loss(torch.from_numpy(pred), real, disc, mode).numpy()
                if got.ndim:
                    got = got.transpose(0, 2, 3, 1)
                assert got.shape == ref.shape
                np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_gradient_penalty_matches_jax():
    """The WGAN-GP penalty of a D in eval mode on the same mixing weights:
    within 1e-9, and its gradient for D's parameters flows."""
    from reid_gan_tpu.models.dual_gan.external_function import (
        cal_gradient_penalty as jax_gp,
    )
    from reid_gan_torch.models.dual_gan.external_function import cal_gradient_penalty

    gan = jax_gan("wgangp")
    G, D = gan_variables(gan, 3)
    rng = np.random.RandomState(4)
    real, fake = rng.rand(B, GH, GW, 3) * 2 - 1, rng.rand(B, GH, GW, 3) * 2 - 1
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        alpha = np.array(jax.random.uniform(key, (B, 1, 1, 1)))
        ref, _ = jax_gp(lambda x: gan.apply_D(D, x, train=False), key,
                        jnp.asarray(real), jnp.asarray(fake))
    _, d = port_nets(G, D)
    d.eval()
    gp, _ = cal_gradient_penalty(d, _nchw(real), _nchw(fake),
                                 alpha=torch.from_numpy(alpha))
    np.testing.assert_allclose(float(gp.detach()), float(ref), rtol=1e-9)
    gp.backward()
    assert d.block0.conv1.conv.weight.grad.abs().sum() > 0


def test_engine_defaults_and_unported_options():
    """The AE defaults override only fields left at the dataclass default,
    as JAX's option setter; G and D Adam with β1 0.5 at gan_lr and
    gan_lr·ratio_g2d; ``set_epoch_lr``; the generators and options that wait
    raise, and the AE generator builds."""
    from reid_gan_tpu.config import GANConfig as JaxGANConfig
    from reid_gan_tpu.models.dual_gan.models import get_option_setter as jax_setter
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.models import create_model

    cfg = GANConfig(model="AE", model_gen="Pose", lambda_g=3.0)
    ref = jax_setter("AE")(JaxGANConfig(model="AE", model_gen="Pose", lambda_g=3.0))
    gan = create_model(cfg, gan_height=GH, gan_width=GW, num_feats=32, ngf=8,
                       reid_feat_dim=REID, device="cpu")
    assert (cfg.lambda_rec, cfg.lambda_g, cfg.ratio_g2d) == \
        (ref.lambda_rec, ref.lambda_g, ref.ratio_g2d) == (2.0, 3.0, 0.1)
    state = gan.init_state()
    assert state.opt_G.defaults["betas"] == state.opt_D.defaults["betas"] == (0.5, 0.999)
    assert state.opt_G.defaults["lr"] == cfg.gan_lr
    assert state.opt_D.defaults["lr"] == pytest.approx(cfg.gan_lr * 0.1)
    gan.set_epoch_lr(state, 0.5)
    assert state.opt_D.param_groups[0]["lr"] == pytest.approx(cfg.gan_lr * 0.05)
    for bad in (GANConfig(model_gen="DEC"), GANConfig(model_gen="Pose", use_vgg=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A: other generators and DPTN"):
            create_model(bad, device="cpu")
    assert type(create_model(GANConfig(model_gen="AE"), gan_height=GH, gan_width=GW,
                             num_feats=32, ngf=8, device="cpu").net_G).__name__ == \
        "AEGenerator"
    with pytest.raises(NotImplementedError, match="ROADMAP A: other generators and DPTN"):
        create_model(GANConfig(model="DPTN"), device="cpu")
