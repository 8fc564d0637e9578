"""Port parity for the steps ``--use-vgg`` changes, in fp64 against the JAX
steps, with the VGG19 taps carried across (λ_style 500, λ_content 0.5, the
AE defaults): one joint ``train_all`` step (``test_torch_port_joint.py``'s
oracle at resnet18 64x32, the pose G and D at 32x16) and two standalone
warm-up steps of the AE generator at 32x16. VGG needs 32x16 at least: its
``relu5`` taps sit after four 2x2 pools. A file of its own, so that its two
JAX compiles run beside ``test_torch_port_vgg.py``'s CLI runs."""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import ae_variables
from test_torch_port_dual_gan_blocks import nchw
from test_torch_port_joint import (
    _assert_grads,
    _assert_state,
    _batch,
    _capture,
    joint_setup,
    train_all_step_matches_jax,
)
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_vgg import GH, GW, jax_vgg_params, port_vgg_params


def test_train_all_step_with_vgg_matches_jax(monkeypatch):
    """One ``train_all`` step with ``use_vgg``: the losses (the G loss with
    its style and content terms) within 1e-9 relative, the encoder's, G's
    and D's gradients (G's through VGG's backward), the parameters, running
    stats, spectral stats and the bank as ``train_all_step_matches_jax``
    holds them; the VGG weights get no gradient."""
    s = joint_setup(monkeypatch, size=(64, 32, GH, GW), vgg_params=jax_vgg_params(21))
    vgg = s.gan.vgg
    assert vgg is not None and s.jt.gan.use_vgg
    batch, conf = _batch(44, size=s.size)
    train_all_step_matches_jax(s, 0, 34, batch, conf)
    assert all(p.grad is None for p in vgg.parameters())
    xs = torch.from_numpy(np.tanh(np.random.RandomState(45).randn(4, 3, GH, GW)))
    content, style = vgg(xs, xs.flip(0))
    assert float(style) * 500.0 > 1e-3 and float(content) * 0.5 > 1e-3


def test_warmup_step_with_vgg_matches_jax():
    """Two standalone D→G steps of the AE generator with ``use_vgg`` (the G
    loss against the updated D plus the VGG terms of the fake against the
    source): the losses within 1e-9 relative, the fake within 1e-9, G's and
    D's gradients, the parameters, G's running stats and D's spectral stats
    as the warm-up step test holds them."""
    from reid_gan_tpu.config import GANConfig as JaxGANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel as JaxAEModel
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    vgg = dict(use_vgg=True, lambda_style=500.0, lambda_content=0.5)
    kw = dict(gan_height=GH, gan_width=GW, num_feats=32, ngf=8)
    params = jax_vgg_params(22)
    jgan = JaxAEModel(JaxGANConfig(model="AE", model_gen="AE", **vgg), vgg_params=params,
                      **kw)
    G, Dv = ae_variables(jgan, 23)
    gan = AEModel(GANConfig(model="AE", model_gen="AE", **vgg),
                  vgg_params=port_vgg_params(params), device="cpu", **kw)
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    gan.vgg.double()
    state = gan.init_state()
    with jax.enable_x64(True):
        jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
        jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
        jstate = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                         opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(24)
    for i in range(2):
        src = np.tanh(rng.randn(4, GH, GW, 3))
        state, errs, fake = gan.step(state, nchw(src))
        with jax.enable_x64(True):
            jstate, jerrs, jfake = jgan._step(jstate, {"Xs": jnp.asarray(src)},
                                              jax.random.PRNGKey(i))
        for k in ("G", "D"):
            assert abs(float(errs[k]) - float(jerrs[k])) <= 1e-9 * abs(float(jerrs[k])), k
        np.testing.assert_allclose(fake.numpy().transpose(0, 2, 3, 1), np.asarray(jfake),
                                   rtol=0, atol=1e-9)
        for net, opt, var in ((gan.net_G, jstate.opt_G, jstate.G),
                              (gan.net_D, jstate.opt_D, jstate.D)):
            ref = jax.tree.map(np.asarray, opt[0]["g"])
            _assert_grads(f"step {i} {type(net).__name__}",
                          {n: p.grad.numpy() for n, p in net.named_parameters()},
                          {k: v.numpy() for k, v in state_dict_from_jax(net, ref).items()})
            _assert_state(f"step {i} {type(net).__name__}", net, state_dict_from_jax(
                net, jax.tree.map(np.asarray, var["params"]),
                jax.tree.map(np.asarray, var["batch_stats"])))
