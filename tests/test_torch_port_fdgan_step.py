"""Port parity for FD-GAN's train steps in fp64 against the JAX package's
jitted steps, at resnet18 and 64x32 (G with ngf 64, Dp with ndf 64), the
weights drawn with numpy into the JAX trees and carried across:

- the inputs of a GAN step: the port's ``preprocess`` (K14's and K13's
  plain versions, the pose sharing) on the draws recomputed from JAX's keys
  against JAX's ``_preprocess``, in fp32, within 1e-6, for each ``pose_aug``;
- one ``SiameseTrainer`` step (stage I), the augmentation draws recomputed
  from JAX's keys; the JAX step gets the port's augmented halves (its
  ``fd_train_augment`` pinned to them: inside a jit, XLA divides by the
  constant 255 as a product with its rounded reciprocal, an ulp off the
  function it compiles; K14's parity is the ops tests');
- one ``FDGANModel`` step of stage 1 (paper stage II) with ``pose_aug``
  ``gauss`` (and, in ``test_torch_port_fdgan_stage3.py``, one of stage 2,
  paper stage III, with ``erase``), smoothing
  on, the smoothing and label-flip uniforms and the noise recomputed from
  JAX's keys. The JAX step gets the port's inputs (its ``_preprocess``
  pinned to them, as XLA's fused programs round the transforms by an ulp;
  their parity is the first test's).

Losses and gradients within 1e-9 relative, parameters after the update
within 1e-10, running stats within 1e-6 relative (fp32 on the JAX side,
ROADMAP C). The JAX gradients are read from the step through a pass-through
optax transform."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fdgan_nets import random_tree
from test_torch_port_fdgan_ops import fdgan_draws, siamese_draws
from test_torch_port_joint import _capture
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

H, W, B = 64, 32, 4


def _assert_grads(name, got, ref):
    """Each gradient within 1e-9 of its norm, plus 1e-12 of the net's
    largest gradient norm: a gradient that is zero in exact arithmetic (a
    bias ahead of a BatchNorm) is rounding on both sides."""
    assert set(got) == set(ref), (name, set(got) ^ set(ref))
    scale = max(np.linalg.norm(r) for r in ref.values())
    for k, r in ref.items():
        err = np.linalg.norm(got[k] - r)
        assert err <= 1e-9 * np.linalg.norm(r) + 1e-12 * scale, \
            f"{name} {k}: |g - r| {err:.3g}, |r| {np.linalg.norm(r):.3g}"


def _assert_state(name, module, ref):
    """Parameters within 1e-10; running stats within 1e-6 relative and 1e-7
    absolute (fp32 on the JAX side)."""
    got = module.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-6, atol=1e-7) if "running" in k else dict(rtol=0, atol=1e-10)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), err_msg=f"{name} {k}", **tol)


def _grads(module):
    return {n: p.grad.numpy() for n, p in module.named_parameters() if p.grad is not None}


def _pairs(seed, b=B):
    """Two host pair batches in ``fdgan_pose`` form: positives in pairs 0
    and 2, landmarks with missing joints, per-side flips."""
    rng = np.random.RandomState(seed)

    def side(pid):
        lm = np.stack([rng.randint(0, H, (b, 18)), rng.randint(0, W, (b, 18))], -1)
        lm[rng.rand(b, 18) < 0.15] = -1
        return {"img": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
                "target": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
                "landmark": lm.astype(np.float32), "flip": rng.rand(b) < 0.5,
                "pid": pid.astype(np.int32)}

    pid1 = np.arange(b)
    pid2 = np.where(np.arange(b) % 2 == 0, pid1, pid1 + 10)
    return side(pid1), side(pid2)


def _cfgs(stage, pose_aug):
    from reid_gan_tpu.config import FDGANConfig as JaxCfg
    from reid_gan_torch.config import FDGANConfig

    kw = dict(stage=stage, lr=1e-3, lambda_recon=100.0, lambda_veri=10.0, lambda_sp=10.0,
              smooth_label=True, pose_aug=pose_aug, drop=0.0, connect_layers=2,
              fuse_mode="cat")
    return JaxCfg(**kw), FDGANConfig(**kw)


def _port_model(cfg, dtype=torch.float64):
    from reid_gan_torch.models.fdgan.model import FDGANModel

    model = FDGANModel(cfg, height=H, width=W, depth=18, device="cpu")
    for net in model.nets().values():
        net.to(dtype)
    return model


@pytest.mark.parametrize("pose_aug", ["no", "gauss", "erase"])
def test_preprocess_matches_jax(pose_aug):
    """origin (K14 with erasing, the fill from the erase key), target (K14
    without, flipped with the maps), posemap (K13) after the pose sharing,
    labels and noise, against JAX's ``_preprocess`` on the same key."""
    from reid_gan_tpu.models.fdgan.model import FDGANModel as JaxModel

    jcfg, cfg = _cfgs(1, pose_aug)
    b1, b2 = _pairs(1)
    key = jax.random.PRNGKey(2)
    jmodel = JaxModel(jcfg, height=H, width=W, depth=18)
    ref = jmodel._preprocess(jax.random.split(key, 8)[0],
                             {k: jnp.asarray(v) for k, v in b1.items()},
                             {k: jnp.asarray(v) for k, v in b2.items()})
    model = _port_model(cfg, torch.float32)
    draws = fdgan_draws(key, B, H, W, pose_aug, cfg.noise_size)
    got = model.preprocess(b1, b2, draws)
    for name, g, r in zip(("origin", "target", "posemap"), got[:3], ref[:3]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_siamese_trainer_step_matches_jax(monkeypatch):
    """One stage-I step: loss and logits, every gradient, the parameters
    after SGD (momentum 0.9, coupled decay 5e-4) and the running stats after
    the two base folds and the head's."""
    from reid_gan_tpu.engine import fdgan as jax_fdgan
    from reid_gan_tpu.engine.fdgan import SiameseTrainer as JaxTrainer
    from reid_gan_torch.ops.transforms import fd_augment
    from reid_gan_tpu.models.multi_branch import siamese_baseline as jax_siamese
    from reid_gan_torch.engine.fdgan import SiameseTrainer
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax
    from reid_gan_torch.models.multi_branch import siamese_baseline

    rng = np.random.RandomState(3)
    img1 = rng.randint(0, 256, (8, H, W, 3)).astype(np.uint8)
    img2 = rng.randint(0, 256, (8, H, W, 3)).astype(np.uint8)
    targets = np.asarray([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    key = jax.random.PRNGKey(4)
    jmodel = jax_siamese(depth=18)
    with jax.enable_x64(True):
        p1, p2 = siamese_draws(key, 8, H, W)
        halves = iter([jnp.asarray(fd_augment(torch.from_numpy(i), torch.from_numpy(p))
                                   .permute(0, 2, 3, 1).numpy())
                       for i, p in ((img1, p1), (img2, p2))])
        monkeypatch.setattr(jax_fdgan, "fd_train_augment", lambda k, img: next(halves))
        shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((2, H, W, 3)),
                                                      jnp.zeros((2, H, W, 3)), train=False),
                                jax.random.PRNGKey(0))
        v = random_tree(shapes, 5)
        jt = JaxTrainer(jmodel, lr=0.01, momentum=0.9, weight_decay=5e-4)
        jt.tx = optax.chain(_capture(), jt.tx)
        state = jt.init_state(jax.tree.map(jnp.asarray, v))
        new, loss, logits = jt._step(state, jnp.asarray(img1), jnp.asarray(img2),
                                     jnp.asarray(targets), key)
        ref_loss, ref_logits = float(loss), np.asarray(logits)
        ref_grads = siamese_state_dict_from_jax(jax.tree.map(np.asarray, new.opt_state[0]["g"]),
                                                v["batch_stats"])
        ref_after = siamese_state_dict_from_jax(jax.tree.map(np.asarray, new.params),
                                                jax.tree.map(np.asarray, new.batch_stats))

    model = siamese_baseline(depth=18).double()
    model.load_state_dict(siamese_state_dict_from_jax(v["params"], v["batch_stats"]))
    trainer = SiameseTrainer(model, lr=0.01, momentum=0.9, weight_decay=5e-4, device="cpu")
    loss, logits = trainer.step(torch.from_numpy(img1), torch.from_numpy(img2),
                                torch.from_numpy(targets.astype(np.int64)),
                                torch.from_numpy(p1), torch.from_numpy(p2))
    assert abs(float(loss) - ref_loss) <= 1e-9 * abs(ref_loss)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-9, atol=1e-12)
    _assert_grads("siamese", _grads(model),
                  {k: r.numpy() for k, r in ref_grads.items() if k in dict(
                      model.named_parameters())})
    _assert_state("siamese", model, ref_after)


def _jax_state(jmodel, seed):
    """An FDGANState of fp64 variables drawn with numpy (no ``init``
    compile), with the optimisers' states."""
    from reid_gan_tpu.models.fdgan.model import FDGANState

    img, pose = jnp.zeros((2, H, W, 3)), jnp.zeros((2, H, W, 18))
    k = jax.random.PRNGKey(0)
    E = random_tree(jax.eval_shape(lambda: jmodel.net_E.init(k, img, img, train=False)), seed)
    Di = random_tree(jax.eval_shape(lambda: jmodel.net_Di.init(k, img, img, train=False)),
                     seed + 1)
    G = random_tree(jax.eval_shape(lambda: jmodel.net_G.init(
        {"params": k, "dropout": k}, pose, jnp.zeros((2, 512)),
        jnp.zeros((2, jmodel.noise_size)), train=True)), seed + 2)
    Dp = random_tree(jax.eval_shape(lambda: jmodel.net_Dp.init(
        k, jnp.zeros((2, H, W, 21)), train=True)), seed + 3)
    E, Di, G, Dp = (jax.tree.map(jnp.asarray, t) for t in (E, Di, G, Dp))
    g_params = {"G": G["params"], **({"E": E["params"]} if jmodel.stage == 2 else {})}
    return FDGANState(E=E, G=G, Di=Di, Dp=Dp, opt_G=jmodel.tx_G.init(g_params),
                      opt_Di=jmodel.tx_Di.init(Di["params"]),
                      opt_Dp=jmodel.tx_Dp.init(Dp["params"]), step=jnp.zeros((), jnp.int32))


def fdgan_step_parity(stage, pose_aug):
    """One Di → Dp → G iteration: the eight losses, the fake, the gradients
    of G, Di, Dp (and E in stage 2), every parameter after the updates, G's
    and Dp's running stats; E and Di keep theirs."""
    from reid_gan_tpu.models.fdgan.model import FDGANModel as JaxModel
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax as sia
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    jcfg, cfg = _cfgs(stage, pose_aug)
    b1, b2 = _pairs(6 + stage)
    key = jax.random.PRNGKey(8 + stage)
    model = _port_model(cfg)
    nets = model.nets()
    with jax.enable_x64(True):
        jmodel = JaxModel(jcfg, height=H, width=W, depth=18)
        for name in ("tx_G", "tx_Di", "tx_Dp"):
            setattr(jmodel, name, optax.chain(_capture(), getattr(jmodel, name)))
        state = _jax_state(jmodel, 20 + stage)
        host = jax.tree.map(np.asarray, state)
        model.net_E.load_state_dict(sia(host.E["params"], host.E["batch_stats"]))
        model.net_Di.load_state_dict(sia(host.Di["params"], host.Di["batch_stats"]))
        for n in ("G", "Dp"):
            var = getattr(host, n)
            nets[n].load_state_dict(state_dict_from_jax(nets[n], var["params"],
                                                        var["batch_stats"]))
        draws = fdgan_draws(key, B, H, W, pose_aug, cfg.noise_size)
        inputs = model.preprocess(b1, b2, draws)
        pinned = tuple(jnp.asarray(t.permute(0, 2, 3, 1).numpy()) if t.dim() == 4
                       else jnp.asarray(t.numpy()) for t in inputs)
        jmodel._preprocess = lambda *_: pinned
        new, errors, fake = jmodel._step(state, {}, {}, key)
        ref_err = {k: float(v) for k, v in errors.items()}
        new = jax.tree.map(np.asarray, new)

    errs, got_fake = model.optimize_step(b1, b2, draws)
    for k, r in ref_err.items():
        assert abs(float(errs[k]) - r) <= 1e-9 * abs(r) + 1e-15, (k, float(errs[k]), r)
    np.testing.assert_allclose(got_fake.permute(0, 2, 3, 1).numpy(), np.asarray(fake),
                               rtol=0, atol=1e-10)
    names = {n: dict(net.named_parameters()) for n, net in nets.items()}
    g_ref = new.opt_G[0]["g"]
    ref_grads = {"G": state_dict_from_jax(nets["G"], g_ref["G"]),
                 "Di": sia(new.opt_Di[0]["g"], host.Di["batch_stats"]),
                 "Dp": state_dict_from_jax(nets["Dp"], new.opt_Dp[0]["g"])}
    if stage == 2:
        ref_grads["E"] = sia(g_ref["E"], host.E["batch_stats"])
    else:
        assert all(p.grad is None for p in nets["E"].parameters())
    for n, ref in ref_grads.items():
        _assert_grads(n, _grads(nets[n]), {k: r.numpy() for k, r in ref.items()
                                           if k in names[n]})
    _assert_state("E", nets["E"], sia(new.E["params"], new.E["batch_stats"]))
    _assert_state("Di", nets["Di"], sia(new.Di["params"], new.Di["batch_stats"]))
    for n in ("G", "Dp"):
        var = getattr(new, n)
        _assert_state(n, nets[n], state_dict_from_jax(nets[n], var["params"],
                                                      var["batch_stats"]))


def test_fdgan_stage1_step_matches_jax():
    """Paper stage II (E frozen, Di lr × 0.01), ``pose_aug`` gauss; stage 2
    is ``test_torch_port_fdgan_stage3.py``'s, a file of its own so that the
    two JAX compiles run on two test workers."""
    fdgan_step_parity(1, "gauss")
