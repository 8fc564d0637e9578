"""Port parity for ``--fp16`` in the joint loop: one ``train_all`` step of
the port's ``ClusterContrastWithGANTrainer`` with the bf16 encoder (resnet18
at 32x16) and the bf16 pose G and D (16x8, ngf 8), against the JAX
trainer's step with ``dtype=jnp.bfloat16`` on both, and its fp32 step, on
the same weights, bank, batch and draws (the JAX smoke shapes of
``test_torch_port_joint.py``, in fp32).

As in ``test_torch_port_fp16.py``: the port's gap to JAX's bf16 step (the
losses, or 2 bf16 ulps of them; each net's whole gradient tree, relative
L2) must be at most a factor times JAX's bf16 step's gap to its fp32 step,
and JAX's bf16 step is compiled with every bf16 rounding it asks for
(``bf16_jit``). The factor is ``STEP_FACTOR`` = 3 here, not 2: one step's
gradients rest on few noisy values (D's on its 32 output scores), so the
ratio of the two gaps spreads more than a forward's. Measured on batch
seeds 40-43: D's ratio 2.65 at seed 40, under 2 at the other three.

The bf16 encoder and G gradients sit about 35% (relative L2) from their
fp32 ones on either side (0.37 and 0.36 for JAX at seed 40), at
temperature 0.05 or 0.5, on noise images or on images of blocks of one
colour: the rounding grows through the BatchNorm backward passes, which
take out most of the gradient (its batch mean and its projection on the
normalised input). Three times that gap would pass any tree, so each
tree's gap must also stay under ``TREE_CAP`` and its norm within
``NORM_RATIO`` of JAX's bf16 tree's (``assert_tree_closer``). The encoder takes
its gradient from the confidence-weighted InfoNCE loss alone: G's input is
detached, in JAX as in the reference (trainers_b.py:756)."""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from test_torch_port_augment import _jax_draws
from test_torch_port_fp16 import _gan, assert_closer, assert_tree_closer, bf16_jit
from test_torch_port_gan_nets import gan_variables
from test_torch_port_joint import B, D, GH, GROUP, GW, H, K_PAD, NV, W, _batch, _capture
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _port_model, _random_variables

STEP_FACTOR = 3.0


def _jax_side(monkeypatch, dtype, params, stats, G, Dv, bank):
    from reid_gan_tpu.config import GANConfig
    from reid_gan_tpu.engine import gan_trainers as jax_gan_trainers
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel, AEState
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory

    monkeypatch.setattr(jax_gan_trainers, "reid_augment",
                        lambda key, img, height=None, width=None, train=None: img)
    monkeypatch.setattr(jax_gan_trainers, "gan_input_transform", lambda img, h, w: img)
    jmodel = JaxReIDResNet(depth=18, norm=True, dtype=dtype)
    jgan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=GH, gan_width=GW,
                   num_feats=32, ngf=8, num_blocks=1, reid_feat_dim=D, dtype=dtype)
    jt = jax_gan_trainers.ClusterContrastWithGANTrainer(jmodel, jgan, height=H, width=W,
                                                        num_instances=GROUP)
    jt.tx = optax.chain(_capture(), jt.tx)
    jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
    jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
    jgs = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                  opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
    return jt, jt.init_state({"params": params, "batch_stats": stats}, jgs,
                             jax_init_memory(bank, k_pad=K_PAD))


def test_train_all_step_bf16_matches_jax(monkeypatch):
    """loss_cl, G and D, and the encoder's, G's and D's gradients."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.precision import set_compute_dtype
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.pose import batch_cords_to_map
    from reid_gan_torch.ops.transforms import gan_input_transform, train_augment
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet

    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    params, stats = _random_variables(JaxReIDResNet(depth=18, norm=True),
                                      np.random.RandomState(20))
    G, Dv = (f32(t) for t in gan_variables(_gan("Pose", None), 21))
    rng = np.random.RandomState(22)
    bank = rng.randn(NV, D)
    bank = (bank / np.linalg.norm(bank, axis=1, keepdims=True)).astype(np.float32)

    # ---- the port, bf16
    model = set_compute_dtype(_port_model(params, stats, torch.float32), torch.bfloat16)
    gan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, num_blocks=1, reid_feat_dim=D, device="cpu",
                  dtype=torch.bfloat16)
    for net, var in ((gan.net_G, G), (gan.net_D, Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    trainer = ClusterContrastWithGANTrainer(model, gan, height=H, width=W,
                                            num_instances=GROUP, device="cpu")
    seen = {}

    def augment(img, seed):
        draws = _jax_draws(jax.random.split(jax.random.PRNGKey(seed), 3)[0], img.shape[0], H, W)
        seen["x"] = train_augment(img, torch.from_numpy(draws), H, W)
        return seen["x"]

    trainer.augment = augment
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, device="cpu"), gan.init_state())
    batch, conf = _batch(40)
    dev = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, errs = trainer.train_all_step(state, dev, 30, torch.from_numpy(conf))
    assert len(seen["x"]) == B

    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())  # noqa: E731
    jbatch = {"img": nhwc(seen["x"]), "pid": jnp.asarray(batch["pid"]),
              "Xs": nhwc(gan_input_transform(dev["Xs"], GH, GW)),
              "Ps": nhwc(batch_cords_to_map(dev["keypoints"], dev["old_size"], GH, GW))}
    ref = {}
    for name, dtype in (("32", None), ("16", jnp.bfloat16)):
        jt, jstate = _jax_side(monkeypatch, dtype, params, stats, G, Dv, bank)
        step = jt._get_step("train_all")
        args = (jstate, jbatch, np.int32(30), jnp.asarray(conf))
        jstate, jerrs = step(*args) if dtype is None else bf16_jit(step, *args)
        enc = {k: v.numpy() for k, v in resnet_state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.enc_opt[0]["g"]), stats).items()}
        ref[name] = (jerrs, enc, jax.tree.map(np.asarray, jstate.gan.opt_G[0]["g"]),
                     jax.tree.map(np.asarray, jstate.gan.opt_D[0]["g"]),
                     len(jax.tree.leaves(jstate.enc_opt[0]["g"])))

    for k in ("loss_cl", "G", "D"):
        assert_closer(float(errs[k]), float(ref["16"][0][k]), float(ref["32"][0][k]), k,
                      factor=STEP_FACTOR)
    grads = {n: q.grad.numpy() for n, q in model.named_parameters() if q.grad is not None}
    assert sorted(grads) == sorted(n for n, q in model.named_parameters() if q.requires_grad)
    assert len(grads) == ref["16"][4], "the port and JAX train different encoder leaves"
    enc = {name: {k: r[1][k] for k in grads} for name, r in ref.items()}
    assert_tree_closer(grads, enc["16"], enc["32"], "encoder gradients", STEP_FACTOR)
    for i, net in ((2, gan.net_G), (3, gan.net_D)):
        got = {n: q.grad.numpy() for n, q in net.named_parameters() if q.grad is not None}
        want = {name: {k: v.numpy() for k, v in state_dict_from_jax(net, r[i]).items()}
                for name, r in ref.items()}
        assert sorted(got) == sorted(want["16"])
        assert all(q.dtype == torch.float32 for q in net.parameters())
        assert_tree_closer(got, want["16"], want["32"], f"{type(net).__name__} gradients",
                           STEP_FACTOR)
