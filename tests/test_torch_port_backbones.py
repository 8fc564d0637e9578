"""Port parity for the model factory's IBN-a encoders and backbone variants:
the ``IBN`` split alone, ``resnet_ibn50a`` in eval, a depth-18
``ReIDResNet(ibn=True)`` in train, the IBN state-dict round trip through the
JAX package's ``import_torch_resnet``, a CC-layout IBN checkpoint through
both eval CLIs, and ``ResNetBip`` (fused and dual), ``ResNetBipD`` and
``ResNetMP`` (``sum``, ``cat``, with the predictor) in eval and train, and
one fp64 USL step of a variant against the JAX step.

Weights are drawn with numpy in the JAX package's tree
(``test_torch_port_train._random_variables``) and moved into the port by
``resnet_state_dict_from_jax`` / ``variant_state_dict_from_jax``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_train import _random_variables, _to64

H, W = 64, 32


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the suite runs six files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _running_stats(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_factory_names_match_jax():
    from reid_gan_torch.models import names
    from reid_gan_tpu.models import names as jax_names

    assert names() == jax_names()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ibn_matches_jax(train, dtype):
    """The IBN split on a (4, 6, 5, 64) map with a channel mean offset:
    instance norm on the first 32 channels (flax's E[x²] - E[x]² against
    torch's two-pass variance), BatchNorm on the rest. fp32 within 1e-5,
    fp64 within 1e-10; the BN half's running stats within 1e-6 relative
    (kept in fp32 on the JAX side, ROADMAP C)."""
    from reid_gan_tpu.models.resnet import IBN as JaxIBN
    from reid_gan_torch.models.resnet import IBN

    rng = np.random.RandomState(3)
    c, half = 64, 32
    x = (rng.randn(4, 6, 5, c) * 1.5 + rng.randn(c)).astype(dtype)
    variables = {
        "params": {"IN": {"scale": rng.rand(half) + 0.5, "bias": rng.randn(half) * 0.1},
                   "BN": {"scale": rng.rand(half) + 0.5, "bias": rng.randn(half) * 0.1}},
        "batch_stats": {"BN": {"mean": rng.randn(half) * 0.1, "var": rng.rand(half) + 0.5}}}
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    with jax.enable_x64(dtype == np.float64):
        v = _to64(variables) if dtype == np.float64 else variables
        out, mut = JaxIBN().apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
        ref = np.asarray(out)
        ref_stats = jax.tree.map(np.asarray, mut["batch_stats"]["BN"])

    ibn = IBN(c)
    sd = {"IN.weight": variables["params"]["IN"]["scale"],
          "IN.bias": variables["params"]["IN"]["bias"],
          "BN.weight": variables["params"]["BN"]["scale"],
          "BN.bias": variables["params"]["BN"]["bias"],
          "BN.running_mean": variables["batch_stats"]["BN"]["mean"],
          "BN.running_var": variables["batch_stats"]["BN"]["var"]}
    ibn.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    assert set(ibn.state_dict()) == set(sd) | {"BN.num_batches_tracked"}
    ibn = ibn.to(torch.float64 if dtype == np.float64 else torch.float32).train(train)
    with torch.no_grad():
        got = ibn(_nchw(x)).permute(0, 2, 3, 1).numpy()
    atol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    np.testing.assert_allclose(ibn.BN.running_mean.numpy(), ref_stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ibn.BN.running_var.numpy(), ref_stats["var"],
                               rtol=1e-6, atol=1e-7)


def test_ibn_keeps_channels_last():
    """A channels_last block stays channels_last through the split."""
    from reid_gan_torch.models.resnet import IBN

    x = torch.randn(2, 8, 4, 3).contiguous(memory_format=torch.channels_last)
    assert IBN(8)(x).is_contiguous(memory_format=torch.channels_last)
    assert IBN(8)(x.contiguous()).is_contiguous()


def test_resnet_ibn50a_eval_matches_jax():
    """``resnet_ibn50a`` eval features at 64x32, batch 3, fp32, JAX at the
    highest matmul precision: rtol 2e-3 / atol 2e-4, as the resnet50 test of
    test_torch_port_resnet.py. The eval head is K2's plain version."""
    from reid_gan_tpu.models import create as jax_create
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    jmodel = jax_create("resnet_ibn50a")
    params, stats = _random_variables(jmodel, np.random.RandomState(50))
    img = np.random.RandomState(51).rand(3, H, W, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False)["feat"])(
            {"params": params, "batch_stats": stats}, jnp.asarray(img)))
    model = create("resnet_ibn50a").eval()
    model.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    with torch.no_grad():
        out = model(_nchw(img))
    assert out.shape == (3, 2048)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-4)


def test_ibn_resnet18_train_outputs_and_running_stats_match_jax():
    """Depth-18 ``ReIDResNet(ibn=True, norm=True)`` in train mode, fp64:
    ``feat`` and the NCHW ``gan_feat`` within 1e-9, every running mean and
    variance after the update (the BN halves of the IBN splits among them)
    within 1e-6 relative (fp32 on the JAX side, ROADMAP C)."""
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax
    from reid_gan_torch.models.resnet import ReIDResNet

    jmodel = JaxReIDResNet(depth=18, ibn=True, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(18))
    x = np.random.RandomState(19).randn(8, H, W, 3)
    with jax.enable_x64(True):
        out, mut = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True,
                                                      mutable=["batch_stats"]))(
            {"params": _to64(params), "batch_stats": _to64(stats)}, jnp.asarray(x))
        ref_feat, ref_gan = np.asarray(out["feat"]), np.asarray(out["gan_feat"])
        ref_stats = {k: v.double().numpy() for k, v in resnet_state_dict_from_jax(
            params, jax.tree.map(np.asarray, mut["batch_stats"])).items()}
    model = ReIDResNet(depth=18, ibn=True, norm=True)
    model.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    model = model.double().train()
    got = model(_nchw(x))
    np.testing.assert_allclose(got["feat"].detach().numpy(), ref_feat, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["gan_feat"].detach().permute(0, 2, 3, 1).numpy(),
                               ref_gan, rtol=0, atol=1e-9)
    port_stats = _running_stats(model)
    assert len(port_stats) == 2 * 21 and any(".bn1.BN." in k for k in port_stats)
    for k, v in port_stats.items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_ibn_state_dict_round_trips_through_jax_importer():
    """``resnet_state_dict_from_jax`` on ``resnet_ibn50a``'s tree writes
    exactly the keys of the port's model (``bn1.IN``, ``bn1.BN`` in stages
    1-3, a plain ``bn1`` in stage 4), loads with ``strict=True``, and
    ``import_torch_resnet`` reads it back to every leaf with no unmatched key
    but the frozen ``feat_bn.bias`` and the GeM ``gap.p``."""
    from reid_gan_tpu.models import create as jax_create
    from reid_gan_tpu.models.resnet import import_torch_resnet
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    jmodel = jax_create("resnet_ibn50a")
    params, stats = _random_variables(jmodel, np.random.RandomState(7))
    sd = resnet_state_dict_from_jax(params, stats)
    model = create("resnet_ibn50a")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert "layer3.5.bn1.IN.weight" in sd and "layer4.0.bn1.IN.weight" not in sd
    assert "layer4.0.bn1.running_mean" in sd and "layer1.0.bn1.BN.running_var" in sd

    back_p, back_s, unmatched = import_torch_resnet(
        {k: v.numpy() for k, v in sd.items()}, jax.tree.map(np.zeros_like, params),
        jax.tree.map(np.zeros_like, stats))
    assert sorted(unmatched) == ["feat_bn.bias", "gap.p"]
    back_p["gap"] = params["gap"]
    for tree, ref in ((back_p, params), (back_s, stats)):
        flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert set(flat_ref) == set(flat_got)
        for path, r in flat_ref.items():
            np.testing.assert_array_equal(np.asarray(flat_got[path]), r,
                                          err_msg=jax.tree_util.keystr(path))


_CC_HEADS = {"conv1": "base.0", "bn1": "base.1", "layer1": "base.4", "layer2": "base.5",
             "layer3": "base.6", "layer4": "base.7"}


def test_cc_layout_ibn_checkpoint_evaluates_as_in_jax_cli(tmp_path, capsys):
    """A random port ``resnet_ibn50a`` saved in the CC ``save_checkpoint``
    layout (``module.base.N`` sequential keys, ``gap.p``), evaluated by the
    port's ``cli/test --resume-torch`` and by JAX's on one synthetic
    directory at 64x32: every key loads (no skipped key on the port's side),
    and CMC top-1/5/10 and mAP agree within 1e-4."""
    from reid_gan_tpu.cli.test import main as jax_main
    from reid_gan_torch.cli.test import main as torch_main
    from reid_gan_torch.models import create

    torch.manual_seed(13)
    model = create("resnet_ibn50a")
    with torch.no_grad():
        model.gap.p.fill_(3.2)
        model.feat_bn.weight.uniform_(0.5, 1.5)
        for name, q in model.named_parameters():
            if ".IN." in name:
                q.uniform_(0.5, 1.5) if name.endswith("weight") else q.normal_(0, 0.1)
    sd = {}
    for k, v in model.state_dict().items():
        head, _, rest = k.partition(".")
        sd["module." + (f"{_CC_HEADS[head]}.{rest}" if head in _CC_HEADS else k)] = v
    assert "module.base.4.0.bn1.IN.weight" in sd
    pth = tmp_path / "model_best.pth.tar"
    torch.save({"state_dict": sd, "epoch": 1, "best_mAP": 0.0}, str(pth))
    args = ["--dataset", "synthetic", "--data-dir", str(tmp_path), "--arch",
            "resnet_ibn50a", "--height", str(H), "--width", str(W), "--batch-size", "64",
            "--workers", "2", "--resume-torch", str(pth)]
    ref_cmc, ref_map = jax_main(args, mesh=False)
    capsys.readouterr()
    cmc, mAP = torch_main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Loaded reference torch checkpoint" in out and "skipped" not in out
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4


# ---------------------------------------------------------------------------
# ResNetBip, ResNetBipD, ResNetMP
# ---------------------------------------------------------------------------

def _variant_pair(kind, depth=18, **kw):
    """The JAX variant, the port's, and the JAX trees drawn with numpy,
    moved into the port with ``strict=True``."""
    from reid_gan_tpu.models import resnet_variants as jv
    from reid_gan_torch.models import resnet_variants as tv
    from reid_gan_torch.models.convert import variant_state_dict_from_jax

    jmodel = getattr(jv, kind)(depth=depth, **kw)
    params, stats = _random_variables(jmodel, np.random.RandomState(depth + len(kind)))
    model = getattr(tv, kind)(depth=depth, **kw)
    model.load_state_dict(variant_state_dict_from_jax(params, stats), strict=True)
    return jmodel, model, params, stats


VARIANTS = [
    ("ResNetBip", {}, {"fuse": True, "output_balance": 0.7}),
    ("ResNetBip", {}, {"fuse": False}),
    ("ResNetBip", {"norm": False}, {"fuse": True, "output_balance": 0.7}),
    ("ResNetBipD", {}, {}),
    ("ResNetMP", {"fusion": "sum"}, {}),
    ("ResNetMP", {"fusion": "cat"}, {}),
    ("ResNetMP", {"fusion": "sum", "need_predictor": True}, {}),
]
VARIANT_IDS = ["bip_fused", "bip_dual", "bip_fused_no_norm", "bipd", "mp_sum", "mp_cat",
               "mp_predictor"]


@pytest.mark.parametrize("kind,kw,call", VARIANTS, ids=VARIANT_IDS)
def test_variant_eval_matches_jax(kind, kw, call):
    """Depth-18 variants in eval at 64x32, batch 3, fp32, JAX at the
    highest matmul precision: every feature within rtol 2e-3 / atol 2e-4
    (the eval heads: K2's plain version for ``bip`` with ``norm`` and for
    ``bipd``, K5's forward on ``mp``'s global and part maps)."""
    jmodel, model, params, stats = _variant_pair(kind, **kw)
    img = np.random.RandomState(5).rand(3, H, W, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, **call))(
            {"params": params, "batch_stats": stats}, jnp.asarray(img))
    with torch.no_grad():
        got = model.eval()(_nchw(img), **call)
    if call.get("fuse", True):
        got = {"feat": got}
    else:
        got = dict(zip(("feat", "feat2"), got))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("kind,kw,call", VARIANTS, ids=VARIANT_IDS)
def test_variant_train_matches_jax(kind, kw, call):
    """Depth-18 variants in train at 64x32, batch 8, fp64 weights and input:
    every output the JAX model returns (``feat``, ``feat2``, ``feat_g``/
    ``feat_p1``/``feat_p2``, ``mp``'s projected ``gan_feat`` and ``pred``)
    within 1e-9, and every running stat after the update within 1e-6
    relative (fp32 on the JAX side, ROADMAP C). Both sides round each
    branch's last map to fp32 and promote it back in the heads, as the JAX
    variants cast it; ``bipd``'s channel-L2 ``gan_feat`` is computed on that
    fp32 map in fp32 arithmetic on both sides, so it is held to 1e-6."""
    from reid_gan_torch.models.convert import variant_state_dict_from_jax

    jmodel, model, params, stats = _variant_pair(kind, **kw)
    x = np.random.RandomState(6).randn(8, H, W, 3)
    with jax.enable_x64(True):
        out, mut = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True,
                                                      mutable=["batch_stats"], **call))(
            {"params": _to64(params), "batch_stats": _to64(stats)}, jnp.asarray(x))
        ref = jax.tree.map(np.asarray, out)
        ref_stats = {k: v.double().numpy() for k, v in variant_state_dict_from_jax(
            params, jax.tree.map(np.asarray, mut["batch_stats"])).items()}
    model = model.double().train()
    got = model(_nchw(x), **call)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].detach()
        if g.dim() == 4:
            g = g.permute(0, 2, 3, 1)
        fp32 = r.dtype == np.float32
        assert g.dtype == (torch.float32 if fp32 else torch.float64), k
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6 if fp32 else 1e-9,
                                   err_msg=k)
    port_stats = _running_stats(model)
    assert port_stats
    for k, v in port_stats.items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["resnet_bip50", "resnet_bipd50", "resnet_mp50"])
def test_variant_factory_trees_convert_strictly(name):
    """Each full-width factory variant's JAX tree converts to exactly the
    port's ``state_dict`` keys and loads with ``strict=True``; the IBN-free
    stems and the stage scopes map by name."""
    from reid_gan_tpu.models import create as jax_create
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import variant_state_dict_from_jax

    kw = {"need_predictor": True} if name == "resnet_mp50" else {}
    params, stats = _random_variables(jax_create(name, **kw), np.random.RandomState(1))
    sd = variant_state_dict_from_jax(params, stats)
    model = create(name, **kw)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)


def test_bip_refuses_an_embedding_as_the_jax_class_does():
    from reid_gan_torch.models import create

    for name in ("resnet_bip50", "resnet_bipd50"):
        with pytest.raises(NotImplementedError, match="reference's embedding branch"):
            create(name, num_features=256)
    assert create("resnet_mp50", num_features=256).feat_bn_g.num_features == 2048


def test_variant_fp64_step_matches_jax_step():
    """One fp64 USL step of a depth-18 ``ResNetBipD`` through the port's
    ``ClusterContrastTrainer.update`` against the JAX pieces composed as
    ``trainers.py:67-87``: the loss within 1e-9 relative, the parameters
    after Adam within 1e-10, the running stats within 1e-6 relative. The
    second branch ``p2`` feeds no loss: its gradient is zero on both sides,
    and Adam's coupled weight decay moves it alike."""
    import optax

    from reid_gan_tpu.engine.trainers import make_optimizer
    from reid_gan_tpu.ops.cluster_memory import MemoryState, memory_loss
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models.convert import variant_state_dict_from_jax
    from reid_gan_torch.ops.cluster_memory import init_memory

    b, d, nv = 16, 512, 8
    jmodel, model, params, stats = _variant_pair("ResNetBipD")
    rng = np.random.RandomState(9)
    x = rng.randn(b, H, W, 3)
    y = np.repeat(rng.permutation(nv)[:4], 4).astype(np.int32)
    bank = rng.randn(nv, d)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)

    with jax.enable_x64(True):
        p, s = _to64(params), _to64(stats)
        feats = jnp.zeros((256, d)).at[:nv].set(bank)

        def loss_fn(p):
            out, mut = jmodel.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
            losses, _ = memory_loss(out["feat"], jnp.asarray(y),
                                    MemoryState(feats, jnp.zeros((0, d)), jnp.int32(nv)),
                                    temp=0.05)
            return losses.mean(), mut["batch_stats"]

        (j_loss, s), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
        tx = make_optimizer(3.5e-4, 5e-4, step_size=20, iters_per_epoch=400)
        updates, _ = tx.update(grads, tx.init(p), p)
        p = optax.apply_updates(p, updates)
        ref = {k: v.numpy() for k, v in variant_state_dict_from_jax(
            jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)).items()}
        assert float(jnp.abs(grads["p2_l4"]["layer4_0"]["conv1"]["kernel"]).max()) == 0.0

    model = model.double()
    trainer = ClusterContrastTrainer(model, height=H, width=W, num_instances=4,
                                     device="cpu")
    state = trainer.init_state(init_memory(bank, k_pad=256, device="cpu"))
    before = model.p2_l4[0].conv1.weight.detach().clone()
    state, loss = trainer.update(state, _nchw(x), torch.from_numpy(y))
    assert abs(float(loss) - float(j_loss)) <= 1e-9 * abs(float(j_loss))
    assert not torch.equal(model.p2_l4[0].conv1.weight, before)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-6, atol=1e-7) if "running" in k else dict(rtol=0, atol=1e-10)
        np.testing.assert_allclose(v.numpy(), ref[k], err_msg=k, **tol)
