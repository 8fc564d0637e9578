"""Port parity for the generators the DEC, FD, PoseAE and DPTN recipes build:
``SourceEncoder``, ``ResizeReID``, ``DECGenerator1``, ``FDGenerator``
(fusion ``add``, ``cat``, ``none``), ``PoseAEGenerator``, ``DPTNGenerator``
(``is_train`` true and false) and the pose generator with instance norm,
each in train mode in fp64 against the JAX module on carried weights (the
outputs within 1e-9, the BatchNorm running stats within 1e-6 relative; the
instance-norm generator within 1e-5, as JAX reduces instance norm in fp32);
``define_G``'s six names; and one standalone step of the ``PoseAE`` engine
in fp64 against JAX's ``AEModel._step`` (losses, G's and D's gradients,
parameters, running stats and spectral stats).

Small sizes: ngf 8, img_f 32, 3 layers, the GAN at 32x16 (the step at
16x8), a 64-channel re-ID input, batch 4."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import ae_variables
from test_torch_port_dual_gan_blocks import check_module, nchw
from test_torch_port_joint import _assert_grads, _assert_state, _capture
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

B, GH, GW, REID = 4, 32, 16, 64


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s) for s in shapes]


def test_source_encoder_and_resize_reid_match_jax():
    """DPTN's source encoder; ``ResizeReID``'s JAX bicubic 2x upsample of a
    6-channel map and its three ResBlocks."""
    from reid_gan_tpu.models.dual_gan import networks as jnet
    from reid_gan_torch.models.dual_gan import networks as net

    img, fmap = _inputs(1, (B, GH, GW, 3), (B, 4, 2, 6))
    got, _ = check_module(jnet.SourceEncoder(ngf=8, img_f=32, layers=3),
                          net.SourceEncoder(3, 8, 32, 3), [img], seed=2)
    assert got.shape == (B, 32, GH // 8, GW // 8)
    got, _ = check_module(jnet.ResizeReID(ngf=8), net.ResizeReID(6, 8), [fmap], seed=3)
    assert got.shape == (B, 6, 8, 4)


def test_dec_generator_matches_jax():
    """``DECGenerator1`` on the spatial re-ID map: the 1x1 adapter to ngf·4,
    2 ResBlocks, the decoder."""
    from reid_gan_tpu.models.dual_gan import networks as jnet
    from reid_gan_torch.models.dual_gan import networks as net

    fmap, = _inputs(4, (B, GH // 8, GW // 8, REID))
    got, _ = check_module(jnet.DECGenerator1(ngf=8, img_f=32, layers=3, num_blocks=2),
                          net.DECGenerator1(8, 32, 3, num_blocks=2, reid_nc=REID), [fmap],
                          seed=5)
    assert got.shape == (B, 3, GH, GW)


@pytest.mark.parametrize("fuse_mode", ["add", "cat", "none"])
def test_fd_generator_matches_jax(fuse_mode):
    """``FDGenerator`` from a 64-wide vector and 16-wide noise: the fusion
    (bias-free Dense layers), the VALID (2, 1) bottleneck transposed conv,
    the five SAME 4x4 stride-2 transposed convs (torch's padding 1), the
    BatchNorms, tanh."""
    from reid_gan_tpu.models.dual_gan import networks as jnet
    from reid_gan_torch.models.dual_gan import networks as net

    reid, noise = _inputs(6, (B, REID), (B, 16))
    got, _ = check_module(
        jnet.FDGenerator(32, ngf=4, noise_nc=16, fuse_mode=fuse_mode, bottleneck_hw=(2, 1)),
        net.FDGenerator(32, 4, 16, fuse_mode=fuse_mode, bottleneck_hw=(2, 1), reid_nc=REID,
                        noise_in=16), [reid, noise], seed=7)
    assert got.shape == (B, 3, 64, 32)


def test_pose_ae_generator_matches_jax():
    """``PoseAEGenerator``: the image and pose encoders, PCTM (query the pose
    features), the decoder."""
    from reid_gan_tpu.models.dual_gan import networks as jnet
    from reid_gan_torch.models.dual_gan import networks as net

    img, pose = _inputs(8, (B, GH, GW, 3), (B, GH, GW, 18))
    got, _ = check_module(jnet.PoseAEGenerator(ngf=8, img_f=32, layers=3),
                          net.PoseAEGenerator(8, 3, 18, 32, 3), [img, pose], seed=9)
    assert got.shape == (B, 3, GH, GW)


@pytest.mark.parametrize("is_train", [True, False])
def test_dptn_generator_matches_jax(is_train):
    """``DPTNGenerator``: the shared encoder twice in one forward (its
    running stats fold twice), PTM, the decoder on the target branch and,
    with ``is_train``, the source branch."""
    from reid_gan_tpu.models.dual_gan import networks as jnet
    from reid_gan_torch.models.dual_gan import networks as net

    img, ps, pt = _inputs(10, (B, GH, GW, 3), (B, GH, GW, 18), (B, GH, GW, 18))
    mod = net.DPTNGenerator(3, 18, 8, 32, 3, num_blocks=2)
    (fake_t, fake_s), _ = check_module(
        jnet.DPTNGenerator(ngf=8, img_f=32, layers=3, num_blocks=2), mod, [img, ps, pt],
        seed=11, jax_kw={"is_train": is_train}, is_train=is_train)
    assert fake_t.shape == (B, 3, GH, GW) and (fake_s is not None) == is_train
    assert int(mod.block0.norm1.num_batches_tracked) == 2


def test_pose_generator_with_instance_norm_matches_jax():
    """The pose generator with ``norm="instance"``: every encoder, decoder
    and PCTM norm per sample (the JAX instance norms reduce in fp32)."""
    from reid_gan_tpu.models.dual_gan import networks as jnet
    from reid_gan_torch.models.dual_gan import networks as net

    fmap, pose = _inputs(12, (B, GH // 8, GW // 8, REID), (B, GH, GW, 18))
    mod = net.PoseGenerator1(8, 18, 32, 3, norm="instance", reid_nc=REID)
    assert not any("running" in k for k in mod.state_dict())
    check_module(jnet.PoseGenerator1(ngf=8, img_f=32, layers=3, norm="instance"), mod,
                 [fmap, pose], seed=13, atol=1e-5)


def test_define_g_builds_every_generator():
    """``define_G`` builds JAX's six generators and raises ``ValueError`` on
    another name, as JAX's factory; the FD generator takes ``img_f`` as its
    feature width, ``reid_nc``-wide vectors and 512-wide noise."""
    from reid_gan_torch.models.dual_gan.networks import define_G

    names = {"AE": "AEGenerator", "DEC": "DECGenerator1", "FD": "FDGenerator",
             "Pose": "PoseGenerator1", "PoseAE": "PoseAEGenerator",
             "DPTN": "DPTNGenerator"}
    for gen, cls in names.items():
        assert type(define_G(gen, ngf=8, img_f=32, reid_nc=REID)).__name__ == cls
    fd = define_G("FD", ngf=8, img_f=32, reid_nc=REID)
    assert fd.W_reid.weight.shape == (512, REID) and fd.W_noise.weight.shape == (512, 512)
    with pytest.raises(ValueError, match="generator Res not implemented"):
        define_G("Res")


def test_pose_ae_standalone_step_matches_jax_step():
    """One fp64 standalone D→G step of the PoseAE engine on (image, pose
    maps) against JAX's ``_step`` with ``Ps`` in its batch: the losses
    within 1e-9 relative, the fake, G's and D's gradients
    (``_assert_grads``), the parameters after Adam within 1e-10, G's running
    stats within 1e-6 relative and D's spectral stats within 1e-9."""
    from reid_gan_tpu.config import GANConfig as JaxGANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel as JaxAEModel
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    gh, gw = 16, 8
    jgan = JaxAEModel(JaxGANConfig(model="AE", model_gen="PoseAE"), gan_height=gh,
                      gan_width=gw, num_feats=32, ngf=8)
    G, Dv = ae_variables(jgan, 41)
    gan = AEModel(GANConfig(model="AE", model_gen="PoseAE"), gan_height=gh, gan_width=gw,
                  num_feats=32, ngf=8, device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    state = gan.init_state()
    with jax.enable_x64(True):
        jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
        jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
        jstate = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                         opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
    src, pose = _inputs(42, (8, gh, gw, 3), (8, gh, gw, 18))
    src = np.tanh(src)
    state, errs, fake = gan.step(state, nchw(src), pose=nchw(pose))
    with jax.enable_x64(True):
        jstate, jerrs, jfake = jgan._step(jstate, {"Xs": jnp.asarray(src),
                                                   "Ps": jnp.asarray(pose)},
                                          jax.random.PRNGKey(0))
    for k in ("G", "D"):
        assert abs(float(errs[k]) - float(jerrs[k])) <= 1e-9 * abs(float(jerrs[k])), k
    np.testing.assert_allclose(fake.numpy().transpose(0, 2, 3, 1), np.asarray(jfake),
                               rtol=0, atol=1e-9)
    for net, opt, var in ((gan.net_G, jstate.opt_G, jstate.G),
                          (gan.net_D, jstate.opt_D, jstate.D)):
        ref = jax.tree.map(np.asarray, opt[0]["g"])
        _assert_grads(type(net).__name__,
                      {n: p.grad.numpy() for n, p in net.named_parameters()},
                      {k: v.numpy() for k, v in state_dict_from_jax(net, ref).items()})
        _assert_state(type(net).__name__, net, state_dict_from_jax(
            net, jax.tree.map(np.asarray, var["params"]),
            jax.tree.map(np.asarray, var["batch_stats"])))
    with pytest.raises(ValueError, match="needs the pose maps"):
        gan.step(state, nchw(src))
