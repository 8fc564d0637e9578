"""Port parity for FD-GAN's steps under the data mesh, in fp64 at resnet18
and 64x32, on four gloo ranks (``torch_mesh_ranks.spawn``):

- one ``SiameseTrainer`` step (stage I) against JAX's ``SiameseTrainer``
  under ``get_mesh(4)`` on the conftest's virtual CPU devices, 2 pairs a
  rank: every rank's BatchNorms global, K14's draws the whole batch's
  sliced, the gradients averaged before SGD;
- one ``FDGANModel`` step of stage 1 (paper stage II) against JAX's
  ``FDGANModel`` step under ``get_mesh(4)``, one pair a rank, the positive
  pairs on ranks 0 and 2 and none on ranks 1 and 3, so that the same-pose
  loss's denominator is the whole batch's;
- one stage-1 step with G's dropout on, its masks drawn from the model's
  generator, on four ranks against the port's step in one process on the
  whole batch: each rank takes its rows of both halves of every draw.

The JAX steps get the port's inputs as the single-device tests give them
(``test_torch_port_fdgan_step.py``), placed over the mesh's data axis.
Losses and gradients within 1e-9 relative, parameters after the update
within 1e-10, running stats within 1e-6 relative."""

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fdgan_nets import random_tree
from test_torch_port_fdgan_ops import fdgan_draws, siamese_draws
from test_torch_port_fdgan_step import (
    H,
    W,
    _assert_grads,
    _assert_state,
    _cfgs,
    _jax_state,
    _pairs,
)
from test_torch_port_joint import _capture
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from torch_mesh_ranks import spawn


def _sharded(mesh, t):
    """``t`` laid out over the mesh's data axis inside a jitted program."""
    from reid_gan_tpu.parallel.mesh import batch_sharding

    return jax.lax.with_sharding_constraint(t, batch_sharding(mesh, t.ndim))


def _params_only(sd):
    """A converted gradient tree without its BatchNorm buffers."""
    return {k: np.asarray(r) for k, r in sd.items()
            if "running" not in k and not k.endswith("num_batches_tracked")}


def _errors_close(got, ref):
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-9 * abs(r) + 1e-15, (k, got[k], r)


def test_siamese_step_on_four_ranks_matches_the_jax_mesh_step(tmp_path, monkeypatch):
    """One stage-I step on 8 pairs: the loss (the ranks' mean), every
    rank's logits, every gradient, the parameters after SGD and the running
    stats after the two base folds and the head's; the nets' BatchNorms are
    all global."""
    import torch_mesh_ranks
    from reid_gan_tpu.engine import fdgan as jax_fdgan
    from reid_gan_tpu.engine.fdgan import SiameseTrainer as JaxTrainer
    from reid_gan_tpu.models.multi_branch import siamese_baseline as jax_siamese
    from reid_gan_tpu.parallel.mesh import get_mesh, shard_batch
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax
    from reid_gan_torch.ops.transforms import fd_augment

    n = 8
    rng = np.random.RandomState(13)
    img1 = rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    img2 = rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    targets = np.asarray([1, 0, 0, 1, 1, 1, 0, 0], np.int32)
    key = jax.random.PRNGKey(14)
    mesh = get_mesh(4)
    jmodel = jax_siamese(depth=18)
    with jax.enable_x64(True):
        p1, p2 = siamese_draws(key, n, H, W)
        halves = iter([jnp.asarray(fd_augment(torch.from_numpy(i), torch.from_numpy(p))
                                   .permute(0, 2, 3, 1).numpy())
                       for i, p in ((img1, p1), (img2, p2))])
        monkeypatch.setattr(jax_fdgan, "fd_train_augment",
                            lambda k, img: _sharded(mesh, next(halves)))
        shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((2, H, W, 3)),
                                                      jnp.zeros((2, H, W, 3)), train=False),
                                jax.random.PRNGKey(0))
        v = random_tree(shapes, 15)
        jt = JaxTrainer(jmodel, lr=0.01, momentum=0.9, weight_decay=5e-4, mesh=mesh)
        jt.tx = optax.chain(_capture(), jt.tx)
        state = jt.init_state(jax.tree.map(jnp.asarray, v))
        new, loss, logits = jt._step(state, *shard_batch(mesh, (img1, img2, targets)), key)
        ref_loss, ref_logits = float(loss), np.asarray(logits)
        ref_grads = siamese_state_dict_from_jax(jax.tree.map(np.asarray, new.opt_state[0]["g"]),
                                                v["batch_stats"])
        ref_after = siamese_state_dict_from_jax(jax.tree.map(np.asarray, new.params),
                                                jax.tree.map(np.asarray, new.batch_stats))

    sd = {k: t.numpy() for k, t in siamese_state_dict_from_jax(v["params"],
                                                               v["batch_stats"]).items()}
    got = spawn(torch_mesh_ranks.siamese_step, 4, tmp_path, sd, img1, img2,
                targets.astype(np.int64), p1, p2)
    assert got["norms"] == ["GlobalBatchNorm"]
    assert abs(got["loss"] - ref_loss) <= 1e-9 * abs(ref_loss)
    np.testing.assert_allclose(got["logits"], ref_logits, rtol=1e-9, atol=1e-12)
    _assert_grads("siamese", got["grads"], _params_only(ref_grads))
    model = torch.nn.Module()
    model.state_dict = lambda: {k: torch.from_numpy(a) for k, a in got["state"].items()}
    _assert_state("siamese", model, ref_after)


def _port_nets(host, nets):
    """The JAX state's variables as the port's state dicts (numpy)."""
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax as sia
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    out = {"E": sia(host.E["params"], host.E["batch_stats"]),
           "Di": sia(host.Di["params"], host.Di["batch_stats"])}
    for n in ("G", "Dp"):
        var = getattr(host, n)
        out[n] = state_dict_from_jax(nets[n], var["params"], var["batch_stats"])
    return {n: {k: t.numpy() for k, t in sd.items()} for n, sd in out.items()}


def _spec(cfg, nets, draws, b1, b2, seed=0):
    return {"cfg": {k: getattr(cfg, k) for k in (
                "stage", "lr", "lambda_recon", "lambda_veri", "lambda_sp", "smooth_label",
                "pose_aug", "drop", "connect_layers", "fuse_mode")},
            "size": (H, W), "seed": seed, "nets": nets, "b1": b1, "b2": b2,
            "draws": {k: [m.numpy() for m in v] if k == "masks" else v.numpy()
                      for k, v in draws._asdict().items() if v is not None}}


def _assert_same_step(got, ref_err, ref_fake, ref_grads, ref_state):
    _errors_close(got["errors"], ref_err)
    np.testing.assert_allclose(got["fake"], ref_fake, rtol=0, atol=1e-10)
    for n, ref in ref_grads.items():
        _assert_grads(n, got["grads"][n], _params_only(ref))
    for n, ref in ref_state.items():
        module = torch.nn.Module()
        module.state_dict = lambda n=n: {k: torch.from_numpy(a)
                                         for k, a in got["state"][n].items()}
        _assert_state(n, module, ref)


def test_fdgan_stage1_step_on_four_ranks_matches_the_jax_mesh_step(tmp_path):
    """Paper stage II, ``pose_aug`` gauss, one pair a rank with positives on
    ranks 0 and 2: the eight losses (the whole batch's, ``loss_sp`` over
    every rank's positive pairs), the fake, the gradients of G, Di and Dp,
    every parameter after the updates, G's and Dp's running stats (Dp's
    folded three times over the whole batch); E takes no gradient."""
    import torch_mesh_ranks
    from reid_gan_tpu.models.fdgan.model import FDGANModel as JaxModel
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_torch.models.convert import siamese_state_dict_from_jax as sia
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.fdgan.model import FDGANModel

    b = 4
    jcfg, cfg = _cfgs(1, "gauss")
    b1, b2 = _pairs(16, b)
    assert list(b1["pid"] == b2["pid"]) == [True, False, True, False]
    key = jax.random.PRNGKey(17)
    mesh = get_mesh(4)
    local = FDGANModel(cfg, height=H, width=W, depth=18, device="cpu")
    for net in local.nets().values():
        net.double()
    nets = local.nets()
    with jax.enable_x64(True):
        jmodel = JaxModel(jcfg, height=H, width=W, depth=18, mesh=mesh)
        for name in ("tx_G", "tx_Di", "tx_Dp"):
            setattr(jmodel, name, optax.chain(_capture(), getattr(jmodel, name)))
        state = _jax_state(jmodel, 30)
        host = jax.tree.map(np.asarray, state)
        port_nets = _port_nets(host, nets)
        for n, net in nets.items():
            net.load_state_dict({k: torch.from_numpy(a) for k, a in port_nets[n].items()})
        draws = fdgan_draws(key, b, H, W, "gauss", cfg.noise_size)
        inputs = local.preprocess(b1, b2, draws)
        pinned = tuple(jnp.asarray(t.permute(0, 2, 3, 1).numpy()) if t.dim() == 4
                       else jnp.asarray(t.numpy()) for t in inputs)
        jmodel._preprocess = lambda *_: tuple(_sharded(mesh, t) for t in pinned)
        new, errors, fake = jmodel._step(replicate(mesh, state), {}, {}, key)
        ref_err = {k: float(v) for k, v in errors.items()}
        new = jax.tree.map(np.asarray, new)
        ref_fake = np.asarray(fake).transpose(0, 3, 1, 2)

    got = spawn(torch_mesh_ranks.fdgan_step, 4, tmp_path,
                _spec(cfg, port_nets, draws, b1, b2))
    assert not got["grads"]["E"]
    ref_grads = {"G": state_dict_from_jax(nets["G"], new.opt_G[0]["g"]["G"]),
                 "Di": sia(new.opt_Di[0]["g"], host.Di["batch_stats"]),
                 "Dp": state_dict_from_jax(nets["Dp"], new.opt_Dp[0]["g"])}
    ref_state = {"E": sia(new.E["params"], new.E["batch_stats"]),
                 "Di": sia(new.Di["params"], new.Di["batch_stats"])}
    for n in ("G", "Dp"):
        var = getattr(new, n)
        ref_state[n] = state_dict_from_jax(nets[n], var["params"], var["batch_stats"])
    _assert_same_step(got, ref_err, ref_fake,
                      ref_grads,
                      ref_state)


def test_fdgan_step_with_dropout_on_four_ranks_matches_one_process(tmp_path):
    """Stage 1 with G's dropout (0.2), ``pose_aug`` erase, 2 pairs a rank:
    the masks are drawn for the whole batch from the model's generator and
    each rank takes its rows of both halves, as it does of the origin, σ,
    erase and noise draws; the losses, the fake, every gradient and state
    against one process on the whole batch with the same seed."""
    import torch_mesh_ranks
    from reid_gan_torch.config import FDGANConfig
    from reid_gan_torch.models.fdgan.model import FDGANModel

    b = 8
    cfg = FDGANConfig(stage=1, lr=1e-3, lambda_veri=10.0, lambda_sp=10.0, pose_aug="erase",
                      drop=0.2, connect_layers=2)
    torch.manual_seed(18)
    model = FDGANModel(cfg, height=H, width=W, depth=18, device="cpu", seed=19)
    nets = {n: {k: v.double().numpy() if v.is_floating_point() else v.numpy()
                for k, v in net.state_dict().items()} for n, net in model.nets().items()}
    draws = model.sample_draws(b)
    b1, b2 = _pairs(20, b)
    spec = _spec(cfg, nets, draws, b1, b2, seed=21)
    ref = torch_mesh_ranks.fdgan_step(None, spec)
    got = spawn(torch_mesh_ranks.fdgan_step, 4, tmp_path, spec)
    _assert_same_step(got, ref["errors"], ref["fake"],
                      {n: g for n, g in ref["grads"].items() if g}, ref["state"])
