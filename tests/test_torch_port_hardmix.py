"""Port parity for the AE hard-mix ``train`` step
(``ClusterContrastWithGANTrainer.train_step``), in fp64 at small sizes:
resnet18 at 32x16, the AE generator at 16x8 (ngf 8, img_f 32, 3 blocks),
batch 8 in 4 groups of 2, so 4 extra negatives, a bank of 8 live rows of
256.

- One step against the JAX trainer's jitted ``train`` step, with the JAX
  BatchNorm as it is (stats stored in float32) and with its stats folded in
  float64 (ROADMAP C). The port's step
  runs whole: K4's plain version on JAX's draws from the step's ``k_aug``
  (the first of a 2-way split), K9's plain version, the encoder, G's
  encode → ``hard_mix`` → decode in train mode, the plain K12, the eval-mode
  re-encode, InfoNCE with the extra negatives, Adam and the fold. The JAX
  step gets the port's augmented image and GAN image as its batch, in fp64
  (its in-step transforms replaced by the identity, as in
  test_torch_port_joint.py); its ``diff_transform`` runs as it is.
- The same step against a torch transcription of the reference's control
  flow (tests/test_joint_parity_oracle.py:374, CC/clustercontrast/
  trainers.py:52-98), written out here on the port's modules, which also
  holds the encoder's running stats.
- ``memory_loss`` with the extra negatives against JAX, gradient included.
"""

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import ae_variables, jax_ae_gan
from test_torch_port_augment import _jax_draws
from test_torch_port_joint import _assert_grads, _assert_state, _capture, _nhwc64
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _jax_named, _port_model, _random_variables

H, W, GH, GW = 32, 16, 16, 8
B, GROUP, NV, K_PAD, D = 8, 2, 8, 256, 512
SEED = 30


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
            "pid": np.repeat(rng.permutation(NV)[:B // GROUP], GROUP).astype(np.int32),
            "Xs": rng.randint(0, 256, (B, GH, GW, 3)).astype(np.uint8)}


def _port_trainer(params, stats, G, Dv, bank):
    """The port's trainer in fp64 with the JAX weights; its augmentation
    takes JAX's draws from the step's ``k_aug`` and keeps its output in
    ``seen["x"]``."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.transforms import train_augment

    model = _port_model(params, stats, torch.float64)
    gan = AEModel(GANConfig(model="AE", model_gen="AE"), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    trainer = ClusterContrastWithGANTrainer(model, gan, height=H, width=W,
                                            num_instances=GROUP, device="cpu")
    seen = {}

    def augment(img, seed):
        k_aug = jax.random.split(jax.random.PRNGKey(seed))[0]
        seen["x"] = train_augment(img, torch.from_numpy(_jax_draws(k_aug, B, H, W)), H, W)
        return seen["x"]

    trainer.augment = augment
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, device="cpu"),
                               gan.init_state())
    return trainer, state, seen


def _weights():
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet

    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(20))
    jgan = jax_ae_gan()
    G, Dv = ae_variables(jgan, 21)
    rng = np.random.RandomState(22)
    bank = rng.randn(NV, D)
    return jmodel, jgan, params, stats, G, Dv, bank / np.linalg.norm(bank, axis=1,
                                                                     keepdims=True)


def _port_grads(module):
    return {n: p.grad.numpy() for n, p in module.named_parameters() if p.grad is not None}


def _float64_norm_stats(monkeypatch):
    """Lift the JAX BatchNorm's float32 casts of the stats it folds
    (``ops/norm.py:55-69``, ROADMAP C) to float64 in this process: its
    module's ``jnp`` is swapped for a namespace whose ``float32`` is
    ``float64``. The package's files do not change."""
    import types

    import reid_gan_tpu.ops.norm as jax_norm

    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.float32 = jnp.float64
    monkeypatch.setattr(jax_norm, "jnp", ns)


@pytest.mark.parametrize("jax_stats", ["float32", "float64"])
def test_train_step_matches_jax_train_step(monkeypatch, jax_stats):
    """``float64``: with the JAX BatchNorm's stats folded in float64, the
    loss within 1e-9 relative, the encoder's gradients (``_assert_grads``),
    its parameters after Adam within 1e-10 and its running stats within
    1e-12 of each tensor's largest element, the bank within 1e-10, G's running stats after its two
    train-mode forwards within 1e-6 relative.

    ``float32``: the JAX package as it is, storing each folded batch stat
    in float32. The eval-mode re-encode then reads running stats 1e-8
    apart, and the extra negatives' columns enter the softmax at 1/temp =
    20x, so this case holds the calibrated floor of
    tests/test_joint_parity_oracle.py:374 on the gradients (1e-6 relative
    and absolute per element, direction within 1e-9, norm within 1e-6), the
    loss within 1e-8 relative (1.9e-9 seen), the parameters within 1e-5
    (Adam's first step turns a 6e-8 gradient offset on a gradient near zero
    into up to lr · 2.3e-6 / 3.5e-4; 2.3e-6 seen), the running stats within
    1e-6 relative and the bank within 1e-10 (the bank folds ``feat`` alone).

    Both: G's parameters and D untouched, and G's running stats moved."""
    from reid_gan_tpu.engine import gan_trainers as jax_gan_trainers
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.ops.transforms import gan_input_transform

    jmodel, jgan, params, stats, G, Dv, bank = _weights()
    trainer, state, seen = _port_trainer(params, stats, G, Dv, bank)
    model, gan = trainer.model, trainer.gan
    g_before = {k: v.clone() for k, v in gan.net_G.state_dict().items()}
    d_before = {k: v.clone() for k, v in gan.net_D.state_dict().items()}

    if jax_stats == "float64":
        _float64_norm_stats(monkeypatch)
    monkeypatch.setattr(jax_gan_trainers, "reid_augment",
                        lambda key, img, height=None, width=None, train=None: img)
    monkeypatch.setattr(jax_gan_trainers, "gan_input_transform", lambda img, h, w: img)
    with jax.enable_x64(True):
        jt = jax_gan_trainers.ClusterContrastWithGANTrainer(
            jmodel, jgan, height=H, width=W, num_instances=GROUP)
        jt.tx = optax.chain(_capture(), jt.tx)
        to64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        jgs = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                      opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
        jstate = jt.init_state({"params": to64(params), "batch_stats": to64(stats)},
                               jgs, jax_init_memory(bank, k_pad=K_PAD))

    batch = _batch(40)
    dev = {k: torch.from_numpy(v) for k, v in batch.items()}
    xs = gan_input_transform(dev["Xs"], GH, GW)
    state, errs = trainer.train_step(state, dev, SEED)
    with jax.enable_x64(True):
        jstate, jerrs = jt._get_step("train")(
            jstate, {"img": _nhwc64(seen["x"]), "pid": jnp.asarray(batch["pid"]),
                     "Xs": _nhwc64(xs)}, np.int32(SEED))

    def enc_named(tree):
        return _jax_named(jax.tree.map(np.asarray, tree),
                          jax.tree.map(np.asarray, jstate.enc_batch_stats))

    loss, ref_loss = float(errs["loss"]), float(jerrs["loss"])
    names = dict(model.named_parameters())
    grads = _port_grads(model)
    grads_ref = {k: v for k, v in enc_named(jstate.enc_opt[0]["g"]).items()
                 if k in names and k != "feat_bn.bias"}
    params_ref = enc_named(jstate.enc_params)
    if jax_stats == "float64":
        assert abs(loss - ref_loss) <= 1e-9 * abs(ref_loss)
        _assert_grads("encoder", grads, grads_ref)
        for k, v in model.state_dict().items():
            if k in params_ref and not k.endswith("num_batches_tracked"):
                tol = dict(rtol=0, atol=1e-12 * np.abs(params_ref[k]).max()) \
                    if "running" in k else dict(rtol=0, atol=1e-10)
                np.testing.assert_allclose(v.numpy(), params_ref[k], err_msg=k, **tol)
    else:
        assert abs(loss - ref_loss) <= 1e-8 * abs(ref_loss)
        assert set(grads) == set(grads_ref)
        for k, r in grads_ref.items():
            np.testing.assert_allclose(grads[k], r, rtol=1e-6, atol=1e-6, err_msg=k)
            nr, ng = np.linalg.norm(r), np.linalg.norm(grads[k])
            if nr > 1e-10:
                assert float(np.dot(grads[k].ravel(), r.ravel())) / (ng * nr) > 1 - 1e-9, k
                assert abs(ng / nr - 1) < 1e-6, k
        for k, v in model.state_dict().items():
            if k in params_ref and not k.endswith("num_batches_tracked"):
                tol = dict(rtol=1e-6, atol=1e-7) if "running" in k else dict(rtol=0,
                                                                             atol=1e-5)
                np.testing.assert_allclose(v.numpy(), params_ref[k], err_msg=k, **tol)
    np.testing.assert_allclose(state.memory.features.numpy(),
                               np.asarray(jstate.memory.features), rtol=0, atol=1e-10)
    _assert_state("G", gan.net_G, state_dict_from_jax(
        gan.net_G, jax.tree.map(np.asarray, jstate.gan.G["params"]),
        jax.tree.map(np.asarray, jstate.gan.G["batch_stats"])))
    g_after, d_after = gan.net_G.state_dict(), gan.net_D.state_dict()
    moved = [k for k in g_before if "running" in k and not torch.equal(g_before[k], g_after[k])]
    assert moved and all(torch.equal(v, g_after[k]) for k, v in g_before.items()
                         if "running" not in k and "num_batches" not in k)
    assert all(torch.equal(v, d_after[k]) for k, v in d_before.items())
    assert not any(p.grad is not None for p in gan.net_G.parameters())
    assert state.step == 1 and state.gan.step == 0


def _transcribed_step(model, G, x, xs, y, bank, lr=3.5e-4, wd=5e-4):
    """The reference's hard-mix iteration written out in torch
    (tests/test_joint_parity_oracle.py:374; CC/clustercontrast/trainers.py:
    52-98, AE_model.py:256-292, cm.py:158-182), on ``model`` (a ReIDResNet)
    and ``G`` (an AEGenerator), with the bicubic re-encode transform in
    place of the oracle's nearest stand-in. Returns (loss, the encoder's
    gradients, the folded bank); trains ``model`` in place."""
    from reid_gan_torch.models.resnet import ResNetBackbone
    from reid_gan_torch.ops.transforms import diff_transform_plain

    def l2n(v):
        return v * (v.pow(2).sum(-1, keepdim=True) + 1e-12).rsqrt()

    def head(fmap):
        p = model.gap.p
        pooled = fmap.clamp(min=1e-6).pow(p).mean(dim=(2, 3)).pow(1.0 / p)
        bn = model.feat_bn(pooled)
        return bn * (bn.pow(2).sum(1, keepdim=True).sqrt() + 1e-12).reciprocal()

    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=lr, weight_decay=wd)
    model.train()
    f_out = head(ResNetBackbone.forward(model, x))
    G.train()
    with torch.no_grad():
        f_s = G.forward_enc(xs)
        reid_f = f_out.detach()
        groups = B // GROUP
        anchor = l2n(reid_f.reshape(groups, GROUP, -1).mean(dim=1))
        sim = torch.exp(anchor @ l2n(reid_f).t())
        id_mask = ((torch.arange(B) // GROUP)[None, :] ==
                   torch.arange(groups)[:, None]).double()
        in_id = torch.argmin(id_mask * sim + (1 - id_mask) * sim.max(), dim=1)
        out_id = torch.argmax((1 - id_mask) * sim, dim=1)
        fc_image = G.forward_dec(0.8 * f_s[in_id] + 0.2 * f_s[out_id])
        model.eval()
        f_ex = head(ResNetBackbone.forward(model, diff_transform_plain(fc_image, H, W)))
        model.train()
    inputs = l2n(f_out)
    ex = l2n(f_ex)
    lex = inputs @ ex.t()
    mask = (torch.arange(B) // GROUP)[:, None] == torch.arange(groups)[None, :]
    logits = torch.cat([inputs @ bank.t(), lex + torch.where(mask, -10000.0, 0.0)],
                       dim=1) / 0.05
    loss = F.cross_entropy(logits, y.long(), reduction="none").mean()
    opt.zero_grad()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    bank = bank.clone()
    with torch.no_grad():
        for xi, yi in zip(inputs.detach(), y.long()):
            row = 0.2 * bank[yi] + 0.8 * xi
            bank[yi] = row * (row.pow(2).sum() + 1e-24).rsqrt()
    return loss.detach(), grads, bank


def test_train_step_matches_torch_transcription():
    """The port's step against the transcription from the same weights,
    batch and draws (both fp64 torch): loss within 1e-12 relative, the
    encoder's gradients and parameters after Adam within 1e-12 of each
    tensor's largest element, the folded bank within 1e-12, and the
    encoder's and G's running stats within 1e-12 relative: both persist
    the encoder's train-forward stats and G's two folds."""
    import copy

    _, _, params, stats, G, Dv, bank = _weights()
    trainer, state, seen = _port_trainer(params, stats, G, Dv, bank)
    model, gan = trainer.model, trainer.gan
    ref_model, ref_g = copy.deepcopy(model), copy.deepcopy(gan.net_G)
    batch = _batch(41)
    dev = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, errs = trainer.train_step(state, dev, SEED)

    from reid_gan_torch.ops.transforms import gan_input_transform

    loss, grads, ref_bank = _transcribed_step(
        ref_model, ref_g, seen["x"].double(), gan_input_transform(dev["Xs"], GH, GW).double(),
        dev["pid"], torch.from_numpy(bank))
    assert abs(float(errs["loss"]) - float(loss)) <= 1e-12 * abs(float(loss))
    for n, p in model.named_parameters():
        if n in grads:
            scale = float(grads[n].abs().max()) or 1.0
            assert float((p.grad - grads[n]).abs().max()) <= 1e-12 * max(scale, 1e-3), n
    for (n, a), b in zip(model.state_dict().items(), ref_model.state_dict().values()):
        if a.dtype.is_floating_point:   # Adam divides by the gradient's root moment
            tol = 1e-12 * float(b.abs().max()) if "running" in n else 1e-10
            assert float((a - b).abs().max()) <= tol, n
    np.testing.assert_allclose(state.memory.features[:NV].numpy(), ref_bank.numpy(),
                               rtol=0, atol=1e-12)
    assert not state.memory.features[NV:].any()
    for (n, a), b in zip(gan.net_G.state_dict().items(), ref_g.state_dict().values()):
        assert torch.equal(a, b) if not a.dtype.is_floating_point else \
            float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1e-3), n


def test_memory_loss_extra_negatives_and_gradient_match_jax():
    """The plain K6 with 4 extra negatives in groups of 2 (fp64): the
    loss, the logits (−inf past num_valid, the −10000 self-mask) within
    1e-12, and d(mean loss)/dx against ``jax.grad`` within 1e-12; the
    negatives get no gradient."""
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_tpu.ops.cluster_memory import memory_loss as jax_loss
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss

    rng = np.random.RandomState(7)
    x, ex = rng.randn(B, 64), rng.randn(B // GROUP, 64)
    y = rng.randint(0, 5, B).astype(np.int32)
    bank = rng.randn(5, 64)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    with jax.enable_x64(True):
        jstate = jax_init_memory(bank, k_pad=12)

        def f(xx):
            loss, logits = jax_loss(xx, jnp.asarray(y), jstate, ex_f=jnp.asarray(ex),
                                    group_size=GROUP)
            return loss.mean(), (loss, logits)

        (_, (ref_loss, ref_logits)), ref_dx = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ext = torch.from_numpy(ex).requires_grad_(True)
    loss, logits = memory_loss(xt, torch.from_numpy(y),
                               init_memory(bank, k_pad=12, device="cpu"), ex_f=ext,
                               group_size=GROUP)
    loss.mean().backward()
    ref_logits = np.asarray(ref_logits)
    fin = np.isfinite(ref_logits)
    assert logits.shape == (B, 12 + B // GROUP) and (~fin).sum() == B * 7
    np.testing.assert_array_equal(np.isfinite(logits.detach().numpy()), fin)
    np.testing.assert_allclose(logits.detach().numpy()[fin], ref_logits[fin], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=0, atol=1e-12)
    assert ext.grad is None
    masked = logits.detach().numpy()[np.arange(B), 12 + np.arange(B) // GROUP]
    assert np.all(masked < -10000.0 / 0.05 + 1.0 / 0.05 + 1e-9)
