"""Port parity for the data mesh through the bip and learnable-memory modes
of the joint trainer: one fp64 ``train_all_bip`` step and one
``train_all_with_memory`` step on four gloo ranks (2 rows each) against the
JAX trainer's jitted step on the batch sharded over ``get_mesh(4)`` with
the state replicated, from the one-card oracles' set-ups
(test_torch_port_bip_memory.py, test_torch_port_joint.py). The port's
augmentation is its own, fed to the JAX step as its batch
(test_torch_port_ddp_gan.py's conventions and tolerances)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ddp import _assert_named_state
from test_torch_port_ddp_gan import (
    _assert_losses,
    _augmented,
    _gan_input,
    _jax_nets,
    _numpy_state,
)
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from torch_mesh_ranks import spawn

H, W, GH, GW = 32, 16, 16, 8
NV, K_PAD, D = 8, 256, 512


def test_bip_step_on_four_ranks_matches_the_jax_mesh_step(tmp_path, monkeypatch):
    """One ``train_all_bip`` step of a depth-18 ``ResNetBip`` and the AE
    generator: both branches' BatchNorms over the whole batch, K6 twice on
    the rank's rows with its labels, the fold of the gathered ``feat +
    feat2``. Held: the four losses (the ranks' means), the encoder's, G's
    and D's parameters, running stats and spectral u/sigma, the bank."""
    import torch_mesh_ranks
    from test_torch_port_bip_memory import _bip_setup, _variant_named
    from test_torch_port_joint import _batch
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard

    s = _bip_setup(monkeypatch)
    batch, _ = _batch(43, size=(H, W, GH, GW))
    batch = {k: batch[k] for k in ("img", "pid", "Xs")}
    seed = 37
    got = spawn(torch_mesh_ranks.mode_step, 4, tmp_path, dict(
        mode="train_all_bip", enc=_numpy_state(s.model), bip=True, gen="AE",
        G=_numpy_state(s.gan.net_G), D=_numpy_state(s.gan.net_D),
        bank=s.state.memory.features[:NV].numpy(), batch=batch, seed=seed,
        sizes=(H, W, GH, GW), group=2))

    mesh = get_mesh(4)
    with jax.enable_x64(True):
        dev = jax_shard(mesh, {"img": _augmented(batch["img"], seed), "pid": batch["pid"],
                               "Xs": _gan_input(batch["Xs"])})
        jstate, jerrs = s.jt._get_step("train_all_bip")(replicate(mesh, s.jstate), dev,
                                                       np.int32(seed))
        ref_enc = _variant_named(jstate.enc_params, jstate.enc_batch_stats)
        nets = _jax_nets(s.gan, jstate.gan.G, jstate.gan.D)
        ref_bank = np.asarray(jstate.memory.features)
    _assert_losses(got["errs"], jerrs, ["loss_cl", "G", "D", "loss"])
    _assert_named_state("bip encoder", got["enc"], ref_enc)
    for name in ("G", "D"):
        _assert_named_state(name, got[name], nets[name])
    np.testing.assert_allclose(got["bank"], ref_bank, rtol=0, atol=1e-10)
    touched = np.unique(batch["pid"])
    assert not np.allclose(got["bank"][touched], s.state.memory.features.numpy()[touched])


def test_memory_step_on_four_ranks_matches_the_jax_mesh_step(tmp_path, monkeypatch):
    """One ``train_all_with_memory`` step (resnet18, the pose G and D) from
    clusters that are not unit rows: G renders each of the rank's rows from
    its cluster, the clusters' gradient is averaged over the ranks with the
    encoder's and G's before their SGD step on the rows the whole batch
    touched. Held: the four losses, the encoder's and D's parameters,
    running stats and u/sigma, G's likewise (G's first bias ahead of a
    BatchNorm gets a rounding gradient from the render's input, constant
    over the map, which Adam amplifies: held as
    test_torch_port_bip_memory._assert_gan holds it), the clusters within
    1e-10 on rank 0, and every rank's clusters equal to rank 0's bit for
    bit; the momentum bank as it was."""
    import torch_mesh_ranks
    from test_torch_port_joint import _batch, _enc_named, joint_setup
    from reid_gan_tpu.ops.cluster_memory import GradientMemoryState as JaxGM
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.ops.pose import batch_cords_to_map

    s = joint_setup(monkeypatch)
    rng = np.random.RandomState(27)
    clusters = rng.randn(NV, D) * rng.uniform(0.5, 2.0, (NV, 1))
    batch, _ = _batch(64)
    seed, lr = 38, 0.1
    bank = s.state.memory.features[:NV].numpy()
    got = spawn(torch_mesh_ranks.mode_step, 4, tmp_path, dict(
        mode="train_all_with_memory", enc=_numpy_state(s.model), gen="Pose",
        G=_numpy_state(s.gan.net_G), D=_numpy_state(s.gan.net_D), bank=bank,
        batch=batch, seed=seed, sizes=(H, W, GH, GW), group=2, clusters=clusters,
        cluster_lr=lr))

    ps = batch_cords_to_map(torch.from_numpy(batch["keypoints"]),
                            torch.from_numpy(batch["old_size"]), GH, GW)
    mesh = get_mesh(4)
    with jax.enable_x64(True):
        jgmem = JaxGM(jnp.asarray(np.pad(clusters, ((0, K_PAD - NV), (0, 0)))),
                      jnp.int32(NV))
        dev = jax_shard(mesh, {"img": _augmented(batch["img"], seed), "pid": batch["pid"],
                               "Xs": _gan_input(batch["Xs"]),
                               "Ps": ps.permute(0, 2, 3, 1).double().numpy()})
        jstate, jgmem, jerrs = s.jt._get_step("train_all_with_memory")(
            replicate(mesh, s.jstate), replicate(mesh, jgmem), dev, np.int32(seed),
            jnp.asarray(lr, jnp.float64))
        s.jstate = jstate
        ref_enc = _enc_named(s, jstate.enc_params)
        nets = _jax_nets(s.gan, jstate.gan.G, jstate.gan.D)
        g_grads = {k: v.numpy() for k, v in state_dict_from_jax(
            s.gan.net_G, jax.tree.map(np.asarray, jstate.gan.opt_G[0]["g"])).items()}
        ref_clusters = np.asarray(jgmem.clusters)
    _assert_losses(got["errs"], jerrs, ["loss_cl", "G", "D", "loss"])
    _assert_named_state("encoder", got["enc"], ref_enc)
    _assert_named_state("D", got["D"], nets["D"])
    # G's parameters whose gradient is rounding (test_torch_port_bip_memory.
    # _assert_gan): a gradient g far below Adam's eps 1e-8 steps by lr·g/eps,
    # bias-corrected by at most 2
    params = {k for k, _ in s.gan.net_G.named_parameters()}
    scale = max(np.linalg.norm(g_grads[k]) for k in params)
    g_lr = s.state.gan.opt_G.param_groups[0]["lr"]
    noise = {k: 2 * g_lr * 2e-12 * scale / 1e-8 for k in params
             if np.linalg.norm(g_grads[k]) <= 1e-12 * scale}
    _assert_named_state("G", got["G"], {k: v for k, v in nets["G"].items()
                                        if k not in noise})
    for k, tol in noise.items():
        err = float(np.abs(got["G"][k] - nets["G"][k]).max())
        assert err <= 1e-10 + tol, f"G {k}: {err:.3g}"
    np.testing.assert_allclose(got["clusters"][0], ref_clusters, rtol=0, atol=1e-10)
    for r in range(1, 4):
        np.testing.assert_array_equal(got["clusters"][r], got["clusters"][0])
    touched = np.zeros(K_PAD, bool)
    touched[batch["pid"]] = True
    moved = np.linalg.norm(got["clusters"][0] - np.pad(clusters, ((0, K_PAD - NV), (0, 0))),
                           axis=1)
    np.testing.assert_allclose(moved[touched], lr, rtol=1e-9)
    assert not moved[~touched].any()
    np.testing.assert_array_equal(got["bank"][:NV], bank)
