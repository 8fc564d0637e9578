"""Port parity for the data mesh through the hard-mix ``train`` step, the
``train_all`` step with the WGAN-GP penalty and the GAN warm-up: each step
in fp64 on four gloo ranks (``torch_mesh_ranks.spawn``) against the JAX
step on the batch sharded over ``get_mesh(4)`` of the conftest's virtual
CPU devices, with the state replicated. The port's augmentation is its
own: each rank draws the whole batch's parameters from the step's seed and
takes its rows, and the JAX step gets that augmented batch (its in-step
transforms are the identity here, as in test_torch_port_joint.py). JAX's
WGAN-GP draws are fed to the port's ranks as the whole batch's
``gp_draws``, which each rank slices. Tolerances: the losses within 1e-9
relative, parameters and banks within 1e-10, running stats within 1e-6
relative, spectral u/sigma within 1e-9 (``_assert_named_state``).

Also K6's plain version with ``row0``: on a rank's rows it is the
whole-batch loss sliced to them.

The bip and learnable-memory steps are in test_torch_port_ddp_gan_modes.py
and the CLIs in test_torch_port_ddp_gan_cli.py, so that the three files
run on three test workers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ddp import _assert_named_state
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_train import _jax_named, _port_model
from torch_mesh_ranks import spawn

H, W, GH, GW = 32, 16, 16, 8
NV, K_PAD, D = 8, 256, 512


def _identity_transforms(monkeypatch):
    from reid_gan_tpu.engine import gan_trainers as jax_gan_trainers

    monkeypatch.setattr(jax_gan_trainers, "reid_augment",
                        lambda key, img, height=None, width=None, train=None: img)
    monkeypatch.setattr(jax_gan_trainers, "gan_input_transform", lambda img, h, w: img)


def _augmented(img, seed):
    """The port's train augmentation of the whole uint8 batch from ``seed``
    (what the ranks compute, each on its rows), as the fp64 NHWC array the
    JAX step takes."""
    from reid_gan_torch.ops.transforms import sample_augment_params, train_augment

    n = img.shape[0]
    x = train_augment(torch.from_numpy(img), sample_augment_params(
        n, H, W, torch.Generator().manual_seed(seed)), H, W)
    return x.permute(0, 2, 3, 1).double().numpy()


def _gan_input(xs, gh=GH, gw=GW):
    from reid_gan_torch.ops.transforms import gan_input_transform

    return gan_input_transform(torch.from_numpy(xs), gh, gw).permute(
        0, 2, 3, 1).double().numpy()


def _numpy_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _port_nets(model_gen, G, Dv, gan_mode="lsgan"):
    """The port's G and D (fp64) with the JAX variables ``G``, ``Dv``."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    gan = AEModel(GANConfig(model="AE", model_gen=model_gen, gan_mode=gan_mode),
                  gan_height=GH, gan_width=GW, num_feats=32, ngf=8, reid_feat_dim=D,
                  device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    return gan


def _jax_nets(gan, var_G, var_D):
    """The JAX G and D variables under the port's state-dict names."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    return {name: {k: v.numpy() for k, v in state_dict_from_jax(
        net, jax.tree.map(np.asarray, var["params"]),
        jax.tree.map(np.asarray, var["batch_stats"])).items()}
        for name, net, var in (("G", gan.net_G, var_G), ("D", gan.net_D, var_D))}


def _assert_losses(got, ref, keys):
    for k in keys:
        r = float(ref[k])
        assert abs(got[k] - r) <= 1e-9 * abs(r), (k, got[k], r)


# ---------------------------------------------------------------------------
# the hard-mix train step
# ---------------------------------------------------------------------------

_HARD_MIX = {"within": (8, 2), "straddle": (12, 4)}


@pytest.fixture(scope="module")
def hard_mix_ranks(tmp_path_factory):
    """Each hard-mix case's weights and batch, and its port step on four
    gloo ranks: both cases in one spawn (``torch_mesh_ranks.each``)."""
    import torch_mesh_ranks
    from test_torch_port_hardmix import _weights

    cases = {}
    for case, (b, group) in _HARD_MIX.items():
        weights = _weights()
        jmodel, jgan, params, stats, G, Dv, bank = weights
        gan = _port_nets("AE", G, Dv)
        enc = _numpy_state(_port_model(params, stats, torch.float64))
        rng = np.random.RandomState(40 + b)
        batch = {"img": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
                 "pid": np.repeat(rng.permutation(NV)[:b // group], group).astype(np.int32),
                 "Xs": rng.randint(0, 256, (b, GH, GW, 3)).astype(np.uint8)}
        spec = dict(mode="train", enc=enc, gen="AE", G=_numpy_state(gan.net_G),
                    D=_numpy_state(gan.net_D), bank=bank, batch=batch, seed=30,
                    sizes=(H, W, GH, GW), group=group)
        cases[case] = (weights, gan, spec)
    got = spawn(torch_mesh_ranks.each, 4, tmp_path_factory.mktemp("hard_mix"),
                torch_mesh_ranks.mode_step, [(c[2],) for c in cases.values()])
    return {case: c + (g,) for (case, c), g in zip(cases.items(), got)}


@pytest.mark.parametrize("case", list(_HARD_MIX))
def test_hard_mix_step_on_four_ranks_matches_the_jax_mesh_step(monkeypatch, hard_mix_ranks,
                                                               case):
    """One fp64 hard-mix ``train`` step (resnet18 at 32x16, the AE generator
    at 16x8) on four gloo ranks against JAX's jitted ``train`` step under
    ``get_mesh(4)``. ``within``: batch 8 in groups of 2, a group a rank;
    ``straddle``: batch 12 in groups of 4, 3 rows a rank, so groups 0 and 2
    straddle two ranks, and ``hard_mix``'s rows and K6's self-mask cross
    them. ``hard_mix`` picks from the gathered ``feat``, G's decoder runs on
    the G mixed rows alike on every rank, the re-encode gives every rank
    all extra negatives. The JAX BatchNorm's stats are folded in float64
    here (``test_torch_port_hardmix._float64_norm_stats``): the eval-mode
    re-encode reads them, and their float32 storage (ROADMAP C) would move
    the loss by 1e-9. Held: the loss, the encoder's parameters and running
    stats, G's running stats after its two train-mode forwards (its
    parameters and D untouched), the bank."""
    from test_torch_port_hardmix import _float64_norm_stats
    from reid_gan_tpu.engine import gan_trainers as jax_gan_trainers
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard

    (jmodel, jgan, params, stats, G, Dv, bank), gan, spec, got = hard_mix_ranks[case]
    batch, seed, group = spec["batch"], spec["seed"], spec["group"]

    _float64_norm_stats(monkeypatch)
    _identity_transforms(monkeypatch)
    mesh = get_mesh(4)
    with jax.enable_x64(True):
        jt = jax_gan_trainers.ClusterContrastWithGANTrainer(
            jmodel, jgan, height=H, width=W, num_instances=group)
        to64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        jgs = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                      opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
        jstate = jt.init_state({"params": to64(params), "batch_stats": to64(stats)},
                               jgs, jax_init_memory(bank, k_pad=K_PAD))
        dev = jax_shard(mesh, {"img": _augmented(batch["img"], seed), "pid": batch["pid"],
                               "Xs": _gan_input(batch["Xs"])})
        jstate, jerrs = jt._get_step("train")(replicate(mesh, jstate), dev, np.int32(seed))
        ref_enc = _jax_named(jax.tree.map(np.asarray, jstate.enc_params),
                             jax.tree.map(np.asarray, jstate.enc_batch_stats))
        nets = _jax_nets(gan, jstate.gan.G, jstate.gan.D)
        ref_bank = np.asarray(jstate.memory.features)
    _assert_losses(got["errs"], jerrs, ["loss"])
    _assert_named_state("encoder", got["enc"], ref_enc)
    _assert_named_state("G", got["G"], nets["G"])
    before = _numpy_state(gan.net_G)
    moved = [k for k in before if "running" in k and not np.array_equal(got["G"][k],
                                                                         before[k])]
    assert moved and all(np.array_equal(got["G"][k], v) for k, v in before.items()
                         if "running" not in k and "num_batches" not in k)
    for k, v in _numpy_state(gan.net_D).items():
        np.testing.assert_array_equal(got["D"][k], v, err_msg=k)
    np.testing.assert_allclose(got["bank"], ref_bank, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# train_all with the WGAN-GP penalty
# ---------------------------------------------------------------------------

def test_train_all_wgangp_step_on_four_ranks_matches_the_jax_mesh_step(tmp_path,
                                                                       monkeypatch):
    """One fp64 ``train_all`` step with ``--gan-mode wgangp`` (resnet18, the
    pose G and D, a GAN bank; batch 8, 2 rows a rank) on four gloo ranks
    against JAX's jitted step under ``get_mesh(4)``, from
    ``test_torch_port_joint.joint_setup``'s weights. The penalty's mixing
    weights are JAX's draws from the step's ``k_d`` for the whole batch;
    each rank takes its rows, and its penalty's mean is averaged with D's
    gradient. Held: the four losses, the encoder's, G's and D's parameters,
    running stats and spectral u/sigma, both banks."""
    import test_torch_port_joint as tj
    import torch_mesh_ranks
    from test_torch_port_gan_nets import jax_gan
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard
    from reid_gan_torch.ops.pose import batch_cords_to_map

    monkeypatch.setattr(tj, "jax_gan", lambda **kw: jax_gan("wgangp", **kw))
    gan_bank = np.random.RandomState(23).randn(NV, D)
    s = tj.joint_setup(monkeypatch, gan_bank=gan_bank)
    batch, conf = tj._batch(62)
    seed = 63
    with jax.enable_x64(True):
        k_d = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
        alpha = np.asarray(jax.random.uniform(k_d, (len(conf), 1, 1, 1)))
    assert alpha.dtype == np.float64
    spec = dict(mode="train_all", enc=_numpy_state(s.model), gen="Pose",
                gan_mode="wgangp", G=_numpy_state(s.gan.net_G),
                D=_numpy_state(s.gan.net_D), bank=s.state.memory.features[:NV].numpy(),
                gan_bank=gan_bank, batch=batch, conf=conf, seed=seed,
                sizes=(H, W, GH, GW), group=2, alpha=alpha)
    got = spawn(torch_mesh_ranks.mode_step, 4, tmp_path, spec)

    ps = batch_cords_to_map(torch.from_numpy(batch["keypoints"]),
                            torch.from_numpy(batch["old_size"]), GH, GW)
    mesh = get_mesh(4)
    with jax.enable_x64(True):
        dev = jax_shard(mesh, {"img": _augmented(batch["img"], seed), "pid": batch["pid"],
                               "Xs": _gan_input(batch["Xs"]),
                               "Ps": ps.permute(0, 2, 3, 1).double().numpy()})
        jstate, jerrs = s.jt._get_step("train_all")(
            replicate(mesh, s.jstate), dev, np.int32(seed), jax_shard(mesh, conf))
        ref_enc = _jax_named(jax.tree.map(np.asarray, jstate.enc_params),
                             jax.tree.map(np.asarray, jstate.enc_batch_stats))
        nets = _jax_nets(s.gan, jstate.gan.G, jstate.gan.D)
        banks = {"bank": np.asarray(jstate.memory.features),
                 "gan_bank": np.asarray(jstate.memory.gan_features)}
    _assert_losses(got["errs"], jerrs, ["loss_cl", "G", "D", "loss"])
    _assert_named_state("encoder", got["enc"], ref_enc)
    for name in ("G", "D"):
        _assert_named_state(name, got[name], nets[name])
    for k, r in banks.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-10, err_msg=k)


# ---------------------------------------------------------------------------
# the GAN warm-up
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warmup_ranks(tmp_path_factory):
    """Each GAN mode's nets, batches and keys, and its two port warm-up
    iterations on four gloo ranks: both modes in one spawn
    (``torch_mesh_ranks.each``)."""
    import torch_mesh_ranks
    from test_torch_port_ae_gan import ae_variables
    from reid_gan_tpu.config import GANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel as JaxAEModel

    cases = {}
    for gan_mode in ("lsgan", "wgangp"):
        jgan = JaxAEModel(GANConfig(model="AE", model_gen="AE", gan_mode=gan_mode),
                          gan_height=GH, gan_width=GW, num_feats=32, ngf=8,
                          reid_feat_dim=64)
        G, Dv = ae_variables(jgan, 31)
        gan = _port_nets("AE", G, Dv, gan_mode)
        rng = np.random.RandomState(32)
        xs = [rng.randint(0, 256, (8, GH, GW, 3)).astype(np.uint8) for _ in range(2)]
        seed = 11
        keys = [jax.random.PRNGKey(seed + i) for i in range(2)]
        with jax.enable_x64(True):
            alphas = [np.asarray(jax.random.uniform(k, (8, 1, 1, 1))) for k in keys] \
                if gan_mode == "wgangp" else None
        spec = dict(G=_numpy_state(gan.net_G), D=_numpy_state(gan.net_D), xs=xs,
                    sizes=(GH, GW), seed=seed, gan_mode=gan_mode, alphas=alphas)
        cases[gan_mode] = (jgan, G, Dv, gan, xs, keys, spec)
    got = spawn(torch_mesh_ranks.each, 4, tmp_path_factory.mktemp("warmup"),
                torch_mesh_ranks.warmup_steps, [(c[-1],) for c in cases.values()])
    return {m: c[:-1] + (g,) for (m, c), g in zip(cases.items(), got)}


@pytest.mark.parametrize("gan_mode", ["lsgan", "wgangp"])
def test_warmup_steps_on_four_ranks_match_the_jax_mesh_step(warmup_ranks, gan_mode):
    """Two ``GANTrainer.train_gan`` iterations in fp64 (the AE generator and
    D at 16x8, batch 8, 2 rows a rank; G's and D's BatchNorms over the whole
    batch, D's gradient averaged before D's Adam, G's fresh loss against the
    updated D, G's gradient averaged before G's Adam) on four gloo ranks
    against two of JAX's jitted standalone steps on the batch sharded over
    ``get_mesh(4)``, each step's key ``PRNGKey(seed + i)`` as
    ``GANTrainer.train_gan`` makes it. With ``wgangp`` the penalty's mixing
    weights are JAX's draws from that key for the whole batch, sliced by
    each rank. Held: each iteration's G and D losses, G's and D's
    parameters, running stats and spectral u/sigma after both."""
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate
    from reid_gan_tpu.parallel.mesh import shard_batch as jax_shard

    jgan, G, Dv, gan, xs, keys, got = warmup_ranks[gan_mode]

    mesh = get_mesh(4)
    with jax.enable_x64(True):
        jstate = replicate(mesh, AEState(
            G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
            opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32)))
        for i, (x, key) in enumerate(zip(xs, keys)):
            jstate, jerrs, _ = jgan._step(jstate, jax_shard(mesh, {"Xs": _gan_input(x)}),
                                          key)
            _assert_losses(got["errs"][i], jerrs, ["G", "D"])
        nets = _jax_nets(gan, jstate.G, jstate.D)
    assert got["step"] == 2
    for name in ("G", "D"):
        _assert_named_state(name, got[name], nets[name])


# ---------------------------------------------------------------------------
# K6's row0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,group,ranks", [(12, 4, 4), (16, 16, 2), (8, 2, 4)])
def test_memory_loss_plain_with_row0_is_the_whole_batch_loss_sliced(b, group, ranks):
    """The plain K6 with extra negatives on each rank's rows, ``row0`` the
    rank's first global row: its loss, logits (the −10000 self-mask at the
    row's global group) and dL/dx equal the whole batch's sliced to those
    rows within 1e-12 (each row's logits and loss are its own; a product of
    fewer rows may round otherwise); ``row0`` 0 is the call without it."""
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss_plain

    rng = np.random.RandomState(b + group)
    x = torch.from_numpy(rng.randn(b, 16)).requires_grad_(True)
    ex = torch.from_numpy(rng.randn(b // group, 16))
    y = torch.from_numpy(rng.randint(0, 5, b).astype(np.int32))
    bank = rng.randn(5, 16)
    state = init_memory(bank / np.linalg.norm(bank, axis=1, keepdims=True), k_pad=8,
                        device="cpu")
    loss, logits = memory_loss_plain(x, y, state, ex_f=ex, group_size=group)
    dx, = torch.autograd.grad(loss.sum(), x)
    again, _ = memory_loss_plain(x, y, state, ex_f=ex, group_size=group, row0=0)
    assert torch.equal(again, loss)
    s = b // ranks
    for r in range(ranks):
        xr = x.detach()[r * s:(r + 1) * s].clone().requires_grad_(True)
        lr, logr = memory_loss_plain(xr, y[r * s:(r + 1) * s], state, ex_f=ex,
                                     group_size=group, row0=r * s)
        dxr, = torch.autograd.grad(lr.sum(), xr)
        ref_logits = logits[r * s:(r + 1) * s].detach()
        assert torch.equal(torch.isfinite(logr), torch.isfinite(ref_logits)), r
        fin = torch.isfinite(ref_logits)
        torch.testing.assert_close(logr.detach()[fin], ref_logits[fin], rtol=0, atol=1e-12)
        torch.testing.assert_close(lr.detach(), loss[r * s:(r + 1) * s].detach(), rtol=0,
                                   atol=1e-12)
        torch.testing.assert_close(dxr, dx[r * s:(r + 1) * s], rtol=0, atol=1e-12)
        masked = logr[torch.arange(s), 8 + (r * s + torch.arange(s)) // group]
        assert bool((masked < -10000.0 / 0.05 + 20.0 + 1e-9).all()), r
