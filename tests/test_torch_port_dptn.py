"""Port parity for the DPTN engine: ``DPTNModel.step`` in fp64 against the
JAX ``DPTNModel._step``, with ``lsgan`` and with ``wgangp`` (the penalty's
mixing weights recomputed from the step's key and fed in), and with
``use_vgg`` (lsgan, the VGG19 taps carried from the JAX tree), two steps each:
the losses, G's and D's gradients, the parameters after Adam, Adam's first
and second moments, G's running stats (1e-6 relative: fp32 on the JAX
side, ROADMAP C) and D's spectral ``u``/``sigma``; ``synthesize_pair``; and
the engine's factory name and option defaults.

Small sizes: the DPTN generator at 16x8 with ngf 8, img_f 32, 3 layers, 2
blocks, 2 CABs and 2 TTBs (32x16 with ``use_vgg``, the smallest size whose
``relu5`` taps are not empty); the discriminator with ndf 32, img_f 128;
batch 4. Weights are drawn with numpy into the JAX trees."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import ae_variables
from test_torch_port_dual_gan_blocks import nchw
from test_torch_port_joint import _assert_grads, _assert_state, _capture
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_vgg import jax_vgg_params, port_vgg_params

B, GH, GW = 4, 16, 8


def _engines(gan_mode, seed, size=(GH, GW), vgg_params=None):
    """The JAX and the port's DPTN engines from the same weights (fp64), the
    JAX optimizers' gradients captured; with ``vgg_params`` (a JAX VGG19
    tree) ``use_vgg`` at the DPTN defaults' λ_style 500 and λ_content 0.5,
    and ``t_s_ratio`` 0.3, so that the two branches' weights differ and a
    term on the wrong branch shows. Returns (jgan, jstate, gan, state)."""
    from reid_gan_tpu.config import GANConfig as JaxGANConfig
    from reid_gan_tpu.models.dual_gan.dptn_model import DPTNModel as JaxDPTNModel
    from reid_gan_tpu.models.dual_gan.dptn_model import DPTNState
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.dual_gan.dptn_model import DPTNModel

    kw = dict(gan_height=size[0], gan_width=size[1], num_feats=32, ngf=8, num_blocks=2)
    vgg = {} if vgg_params is None else dict(use_vgg=True, lambda_style=500.0,
                                             lambda_content=0.5, t_s_ratio=0.3)
    jgan = JaxDPTNModel(JaxGANConfig(model="DPTN", gan_mode=gan_mode, **vgg),
                        vgg_params=vgg_params, **kw)
    G, Dv = ae_variables(jgan, seed)
    gan = DPTNModel(GANConfig(model="DPTN", gan_mode=gan_mode, **vgg), device="cpu",
                    vgg_params=None if vgg_params is None else port_vgg_params(vgg_params),
                    **kw)
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    if gan.vgg is not None:
        gan.vgg.double()
    with jax.enable_x64(True):
        jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
        jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
        jstate = DPTNState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                           opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
    return jgan, jstate, gan, gan.init_state()


def _batch(seed, size=(GH, GW)):
    rng = np.random.RandomState(seed)
    h, w = size
    return {"Xs": np.tanh(rng.randn(B, h, w, 3)), "Ps": rng.rand(B, h, w, 18),
            "Xt": np.tanh(rng.randn(B, h, w, 3)), "Pt": rng.rand(B, h, w, 18)}


def _adam_moments(opt_state):
    """(mu, nu) of the optax Adam inside the captured chain."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return adam[0].mu, adam[0].nu


@pytest.mark.parametrize("gan_mode,use_vgg", [("lsgan", False), ("wgangp", False),
                                              ("lsgan", True)])
def test_dptn_steps_match_jax(gan_mode, use_vgg):
    """Two fp64 steps: the G and D losses (with ``use_vgg`` the G loss holds
    both branches' style and content terms) within 1e-9 relative, the target
    branch's fake within 1e-9, the gradients and Adam's moments
    (``_assert_grads``), the parameters within 1e-10, G's running stats
    (the encoder folds twice a step) within 1e-6 relative, D's ``u``/``sigma``
    (advanced by the D step's two train forwards; the G loss reads D in
    eval mode) within 1e-9."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    size = (32, 16) if use_vgg else (GH, GW)
    jgan, jstate, gan, state = _engines(gan_mode, 51, size,
                                        jax_vgg_params(53) if use_vgg else None)
    assert (gan.vgg is not None) == use_vgg == bool(jgan.use_vgg)
    assert gan.t_s_ratio == jgan.t_s_ratio == (0.3 if use_vgg else 0.5)
    for i in range(2):
        batch = _batch(60 + i, size)
        key = jax.random.PRNGKey(70 + i)
        with jax.enable_x64(True):
            alpha = np.array(jax.random.uniform(key, (B, 1, 1, 1)))
            jstate, jerrs, jfake = jgan._step(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        state, errs, fake = gan.step(state, *(nchw(batch[k]) for k in ("Xs", "Ps", "Xt", "Pt")),
                                     alpha=torch.from_numpy(alpha))
        for k in ("G", "D"):
            assert abs(float(errs[k]) - float(jerrs[k])) <= 1e-9 * abs(float(jerrs[k])), k
        np.testing.assert_allclose(fake.numpy().transpose(0, 2, 3, 1), np.asarray(jfake),
                                   rtol=0, atol=1e-9)
        for net, opt, jopt, var in ((gan.net_G, state.opt_G, jstate.opt_G, jstate.G),
                                    (gan.net_D, state.opt_D, jstate.opt_D, jstate.D)):
            name = f"step {i} {type(net).__name__}"
            params = dict(net.named_parameters())
            as_port = lambda t: {k: v.numpy() for k, v in state_dict_from_jax(  # noqa: E731
                net, jax.tree.map(np.asarray, t)).items()}
            _assert_grads(name, {n: p.grad.numpy() for n, p in params.items()},
                          as_port(jopt[0]["g"]))
            mu, nu = _adam_moments(jopt)
            for slot, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
                _assert_grads(f"{name} {slot}",
                              {n: opt.state[p][slot].numpy() for n, p in params.items()},
                              as_port(ref))
            _assert_state(name, net, state_dict_from_jax(
                net, jax.tree.map(np.asarray, var["params"]),
                jax.tree.map(np.asarray, var["batch_stats"])))
    assert state.step == 2
    assert int(gan.net_G.block0.norm1.num_batches_tracked) == 4


def test_synthesize_pair_matches_jax():
    """The flipped batch rendered into this batch's target poses in eval
    mode (running stats), detached: within 1e-9 of JAX's; G's stats
    unchanged."""
    jgan, jstate, gan, _ = _engines("lsgan", 52)
    batch = _batch(61)
    with jax.enable_x64(True):
        ref = jgan.synthesize_pair(jstate.G, *(jnp.asarray(batch[k]) for k in ("Xs", "Ps", "Pt")))
    before = {k: v.clone() for k, v in gan.net_G.state_dict().items()}
    got = gan.synthesize_pair(*(nchw(batch[k]) for k in ("Xs", "Ps", "Pt")))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref), rtol=0,
                               atol=1e-9)
    assert all(torch.equal(v, gan.net_G.state_dict()[k]) for k, v in before.items())


def test_dptn_factory_and_defaults():
    """``create_model`` builds the DPTN engine for ``--model DPTN`` with JAX's
    option defaults (λ_rec 2.5, λ_g 2.0) over the fields left at their
    dataclass default; ``find_model_using_name`` knows AE and DPTN only."""
    from reid_gan_tpu.config import GANConfig as JaxGANConfig
    from reid_gan_tpu.models.dual_gan.models import get_option_setter as jax_setter
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.models import create_model, find_model_using_name

    cfg = GANConfig(model="DPTN", lambda_g=3.0)
    ref = jax_setter("DPTN")(JaxGANConfig(model="DPTN", lambda_g=3.0))
    gan = create_model(cfg, gan_height=GH, gan_width=GW, num_feats=32, ngf=8, device="cpu")
    assert type(gan).__name__ == "DPTNModel" and type(gan.net_G).__name__ == "DPTNGenerator"
    assert (cfg.lambda_rec, cfg.lambda_g, cfg.lambda_style, cfg.lambda_content) == \
        (ref.lambda_rec, ref.lambda_g, ref.lambda_style, ref.lambda_content) == \
        (2.5, 3.0, 500.0, 0.5)
    assert not hasattr(gan, "synthesize_p")
    assert find_model_using_name("AE").__name__ == "AEModel"
    with pytest.raises(KeyError, match="unknown dual_gan model"):
        find_model_using_name("Cycle")
