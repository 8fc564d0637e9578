"""Port parity for the USL train step: ``ReIDResNet`` in train mode with its
running stats, one whole step (model forward/backward → InfoNCE → Adam →
bank fold) in fp64, two steps of ``ClusterContrastTrainer.train`` in fp32
against the JAX trainer, and the P×K sampler and train loader's streams.

resnet18 at 64x32, batch 16 = 4 ids x 4 instances, a bank of 8 live rows of
256 (D 512). Weights are drawn with numpy in the JAX package's tree and
moved into the port by ``resnet_state_dict_from_jax``; gradients come back
through the JAX package's ``import_torch_resnet``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_augment import _jax_draws

B, P, K = 16, 4, 4
H, W = 64, 32
D, K_PAD, NV = 512, 256, 8


def _to64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _random_variables(jmodel, rng):
    """JAX (params, batch_stats) trees for ``jmodel`` drawn with numpy:
    ``jax.eval_shape`` gives the tree without compiling ``init``. Kaiming
    convolutions, scales in [0.5, 1.5), biases and means near 0, variances
    in [0.5, 1.5), GeM p 3.2."""
    shapes = jax.eval_shape(lambda k, x: jmodel.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_out = leaf.shape[-1] * int(np.prod(leaf.shape[:-2]))
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_out)).astype(np.float32)
        if "scale" in name or "var" in name:
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if "'p'" in name:
            return np.full(leaf.shape, 3.2, np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)   # bias, mean

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return variables["params"], variables["batch_stats"]


def _jax_model_and_weights(seed):
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet

    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(seed))
    return jmodel, params, stats


def _port_model(params, stats, dtype):
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    model = create("resnet18", norm=True)
    model.load_state_dict(resnet_state_dict_from_jax(params, stats), strict=True)
    return model.to(dtype).train()


def _batch(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    y = np.repeat(rng.permutation(NV)[:P], K).astype(np.int32)
    return img, y[rng.permutation(B)]


def _bank(seed, dtype):
    rng = np.random.RandomState(seed)
    c = rng.randn(NV, D)
    return (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(dtype)


def _stats_tree(model):
    """The port's running stats as a torch-named dict of numpy arrays."""
    return {k: v.detach().numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_named(tree_params, tree_stats):
    """A JAX (params, batch_stats) pair under the port's state_dict names."""
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    return {k: v.double().numpy() for k, v in
            resnet_state_dict_from_jax(tree_params, tree_stats).items()}


def test_reid_resnet_train_outputs_and_running_stats_match_jax():
    """Train-mode forward in fp64: ``feat`` (GeM → feat_bn on batch stats →
    L2) and the NCHW ``gan_feat`` within 1e-9; every running mean and
    variance after the update within 1e-6 relative (the JAX side keeps them
    in fp32, ROADMAP C)."""
    jmodel, params, stats = _jax_model_and_weights(0)
    x = np.random.RandomState(1).randn(B, H, W, 3)
    with jax.enable_x64(True):
        out, mut = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True,
                                                      mutable=["batch_stats"]))(
            {"params": _to64(params), "batch_stats": _to64(stats)}, jnp.asarray(x))
        ref_feat, ref_gan = np.asarray(out["feat"]), np.asarray(out["gan_feat"])
        ref_stats = _jax_named(params, jax.tree.map(np.asarray, mut["batch_stats"]))
    model = _port_model(params, stats, torch.float64)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert set(got) == {"feat", "gan_feat"}
    np.testing.assert_allclose(got["feat"].detach().numpy(), ref_feat, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["gan_feat"].detach().permute(0, 2, 3, 1).numpy(),
                               ref_gan, rtol=0, atol=1e-9)
    port_stats = _stats_tree(model)
    assert len(port_stats) == 2 * 21          # 20 backbone BNs + feat_bn
    for k, v in port_stats.items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert "gan_feat" not in model(torch.zeros((2, 3, H, W), dtype=torch.float64),
                                   with_gan_feat=False)


def _cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_fp64_steps_match_jax_steps():
    """Two steps on augmented batches, in fp64: the port's
    ``ClusterContrastTrainer.update`` (train forward/backward, InfoNCE and
    GeM as their plain versions differentiated by autograd, torch Adam with
    coupled weight decay, K7's fold) against the JAX pieces composed as
    ``trainers.py:67-87`` composes them. At each step: the loss within 1e-9
    relative, every gradient's cosine above 1 - 1e-9 and its norm ratio
    within 1e-9, the parameters after Adam within 1e-10 (where a gradient g
    is near Adam's eps 1e-8 its update lr·g/(|g| + eps) moves by up to
    lr·δg/(4 eps): 2e-11 seen for δg of a few 1e-15, the rounding of fp64
    sums), the bank within 1e-12 after step 1 and within 1e-10 after step 2
    (its features come from those parameters; 4e-12 seen), and the running
    stats within 1e-6 relative (fp32 on the JAX side, ROADMAP C)."""
    import optax

    from reid_gan_tpu.engine.trainers import make_optimizer
    from reid_gan_tpu.models.resnet import import_torch_resnet
    from reid_gan_tpu.ops.cluster_memory import MemoryState
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_tpu.ops.cluster_memory import memory_loss, update_memory
    from reid_gan_tpu.ops.transforms import reid_augment
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.ops.cluster_memory import init_memory

    jmodel, params, stats = _jax_model_and_weights(2)
    bank = _bank(4, np.float64)
    steps = []
    for i in range(2):
        img, y = _batch(3 + i)
        x = np.asarray(reid_augment(jax.random.PRNGKey(5 + i), jnp.asarray(img),
                                    height=H, width=W, train=True), np.float64)
        steps.append((x, y))

    model = _port_model(params, stats, torch.float64)
    trainer = ClusterContrastTrainer(model, height=H, width=W, num_instances=K,
                                     device="cpu")
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, device="cpu"))

    with jax.enable_x64(True):
        p, s = _to64(params), _to64(stats)
        memory = jax_init_memory(bank, k_pad=K_PAD)
        tx = make_optimizer(3.5e-4, 5e-4, step_size=20, iters_per_epoch=400)
        opt_state = tx.init(p)
        template = jax.tree.map(np.zeros_like, p)

        @jax.jit
        def grad_fn(p, s, feats, x, y):
            def loss_fn(p):
                out, mut = jmodel.apply({"params": p, "batch_stats": s}, x,
                                        train=True, mutable=["batch_stats"])
                losses, _ = memory_loss(out["feat"], y, MemoryState(
                    feats, jnp.zeros((0, D)), jnp.int32(NV)), temp=0.05)
                return losses.mean(), (mut["batch_stats"], out["feat"])
            return jax.value_and_grad(loss_fn, has_aux=True)(p)

        @jax.jit
        def adam(g, o, p):
            updates, o = tx.update(g, o, p)
            return optax.apply_updates(p, updates), o

        for step, (x, y) in enumerate(steps, 1):
            (j_loss, (s, feats)), j_grads = grad_fn(p, s, memory.features,
                                                    jnp.asarray(x), jnp.asarray(y))
            p, opt_state = adam(j_grads, opt_state, p)
            memory = update_memory(memory, feats, jnp.asarray(y), momentum=0.2,
                                   group_size=K)
            ref = _jax_named(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))

            state, loss = trainer.update(state, torch.from_numpy(x).permute(0, 3, 1, 2),
                                         torch.from_numpy(y))
            assert state.step == step
            assert abs(float(loss) - float(j_loss)) <= 1e-9 * abs(float(j_loss))
            grads = {n: q.grad.numpy() for n, q in model.named_parameters()
                     if q.grad is not None}
            assert "feat_bn.bias" not in grads
            g_tree, _, unmatched = import_torch_resnet(
                {k: v for k, v in grads.items() if k != "gap.p"}, template, s)
            assert unmatched == []
            g_tree["gap"]["p"] = grads["gap.p"]
            flat_ref = dict(jax.tree_util.tree_flatten_with_path(j_grads)[0])
            flat_got = dict(jax.tree_util.tree_flatten_with_path(g_tree)[0])
            assert set(flat_ref) == set(flat_got) and len(flat_ref) == len(grads)
            for path, r in flat_ref.items():
                got, r = np.asarray(flat_got[path], np.float64), np.asarray(r)
                where = f"step {step} {jax.tree_util.keystr(path)}"
                assert _cosine(got, r) > 1 - 1e-9, where
                assert abs(np.linalg.norm(got) / np.linalg.norm(r) - 1) < 1e-9, where
            for k, v in model.state_dict().items():
                if k.endswith("num_batches_tracked"):
                    continue
                tol = dict(rtol=1e-6, atol=1e-7) if "running" in k else \
                    dict(rtol=0, atol=1e-10)
                np.testing.assert_allclose(v.numpy(), ref[k], err_msg=f"step {step} {k}",
                                           **tol)
            np.testing.assert_allclose(state.memory.features.numpy(),
                                       np.asarray(memory.features), rtol=0,
                                       atol=1e-12 if step == 1 else 1e-10)


class _Batches:
    """A loader that serves a fixed list of batches, as ``IterLoader``."""

    def __init__(self, batches):
        self.batches = list(batches)

    def next(self):
        return self.batches.pop(0)


def test_trainer_two_fp32_steps_match_jax_trainer(capsys):
    """``ClusterContrastTrainer.train`` for two steps in fp32 against the
    JAX trainer, with JAX's augmentation draws fed to the port's
    ``train_augment`` for each step's seed. Loose tolerances: the first step agrees to about 1e-6, but temp
    0.05 multiplies each logit's fp32 rounding by 20, and where a gradient
    is at the level of that noise its sign decides the direction of its
    Adam step (lr 3.5e-4 each way), so by the second step the models differ
    in a fifth of their elements by more than 1e-5 (the fp64 test above
    holds both steps to 1e-10). Bounds: the mean loss within 2e-3 relative
    (1e-4 seen); the bank within 1e-2 (2.7e-3 seen); each parameter within
    4 lr, the most two Adam steps on each side can part them (3.9 lr seen),
    and their median difference below 1e-5 (2.2e-6 seen); the same print
    lines."""
    from reid_gan_tpu.engine.trainers import ClusterContrastTrainer as JaxTrainer
    from reid_gan_tpu.ops.cluster_memory import init_memory as jax_init_memory
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.transforms import train_augment

    jmodel, params, stats = _jax_model_and_weights(6)
    batches = [dict(zip(("img", "pid"), _batch(7 + i))) for i in range(2)]
    bank = _bank(8, np.float32)

    jt = JaxTrainer(jmodel, height=H, width=W, num_instances=K)
    jstate = jt.init_state({"params": params, "batch_stats": stats},
                           jax_init_memory(bank, k_pad=K_PAD))
    jstate, j_loss = jt.train(jstate, 3, _Batches(batches), train_iters=2,
                              print_freq=1, base_seed=11)
    j_out = capsys.readouterr().out

    def augment(img_u8, seed):
        draws = _jax_draws(jax.random.PRNGKey(seed), img_u8.shape[0], H, W)
        return train_augment(img_u8, torch.from_numpy(draws), H, W)

    model = _port_model(params, stats, torch.float32)
    trainer = ClusterContrastTrainer(model, height=H, width=W, num_instances=K,
                                     device="cpu")
    trainer.augment = augment
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, device="cpu"))
    state, loss = trainer.train(state, 3, _Batches(batches), train_iters=2,
                                print_freq=1, base_seed=11)
    out = capsys.readouterr().out

    assert abs(loss - j_loss) <= 2e-3 * abs(j_loss)
    np.testing.assert_allclose(state.memory.features.numpy(),
                               np.asarray(jstate.memory.features), rtol=0, atol=1e-2)
    ref = _jax_named(jax.tree.map(np.asarray, jstate.params),
                     jax.tree.map(np.asarray, jstate.batch_stats))
    diffs = []
    for k, v in model.state_dict().items():
        if "running" in k or k.endswith("num_batches_tracked") or k == "feat_bn.bias":
            continue
        d = np.abs(v.numpy() - ref[k])
        assert d.max() <= 4 * 3.5e-4 * (1 + 1e-3), k
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) < 1e-5
    strip = [ln.split("\tTime")[0] for ln in out.splitlines() if ln.startswith("Epoch")]
    assert strip == [ln.split("\tTime")[0] for ln in j_out.splitlines()
                     if ln.startswith("Epoch")] == ["Epoch: [3][1/2]", "Epoch: [3][2/2]"]


def test_sampler_and_train_loader_match_jax(tmp_path):
    """The same seed gives the JAX sampler's index stream, and
    ``make_train_loader`` over the same synthetic files the same batches
    (file names, labels, decoded images)."""
    from reid_gan_tpu.data.datasets import create as jax_dataset
    from reid_gan_tpu.data.sampler import RandomMultipleGallerySampler as JaxSampler
    from reid_gan_tpu.engine.usl import make_train_loader as jax_loader
    from reid_gan_torch.data.sampler import RandomMultipleGallerySampler
    from reid_gan_torch.engine.usl import (
        bank_rows,
        build_pseudo_dataset,
        generate_cluster_features,
        make_train_loader,
    )

    ds = jax_dataset("synthetic", str(tmp_path), num_ids=12, imgs_per_id=6)
    train = list(ds.train)
    rng = np.random.RandomState(0)
    labels = rng.randint(-1, 9, len(train))
    pseudo = build_pseudo_dataset(train, labels)
    assert len(pseudo) == int((labels >= 0).sum())
    for seed in (0, 5):
        assert list(RandomMultipleGallerySampler(pseudo, 4, seed=seed)) == \
            list(JaxSampler(pseudo, 4, seed=seed))
    ref = jax_loader(pseudo, H, W, 8, 4, workers=2, iters=3, seed=9)
    got = make_train_loader(pseudo, H, W, 8, 4, workers=2, iters=3, seed=9)
    for _ in range(3):
        a, b = ref.next(), got.next()
        assert list(a["fname"]) == list(b["fname"])
        np.testing.assert_array_equal(a["pid"], b["pid"])
        np.testing.assert_array_equal(a["img"], b["img"])
    ref.close()
    got.close()

    feats = rng.randn(len(train), 16)
    from reid_gan_tpu.engine.usl import generate_cluster_features as jax_centers

    np.testing.assert_allclose(generate_cluster_features(labels, feats),
                               jax_centers(labels, feats), rtol=0, atol=1e-12)
    assert [bank_rows(n, k) for n, k in ((1, None), (256, None), (257, None),
                                         (700, 1024))] == [256, 256, 512, 1024]


@pytest.mark.slow
def test_reid_resnet50_train_outputs_match_jax():
    """ResNet-50 (2048-d) train forward in fp64 at 64x32: ``feat`` within
    1e-9, running stats within 1e-6 relative."""
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    rng = np.random.RandomState(50)
    jmodel = JaxReIDResNet(depth=50, norm=True)
    params, stats = _random_variables(jmodel, rng)
    x = rng.randn(4, H, W, 3)
    with jax.enable_x64(True):
        out, mut = jmodel.apply({"params": _to64(params), "batch_stats": _to64(stats)},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
        ref_stats = _jax_named(params, jax.tree.map(np.asarray, mut["batch_stats"]))
        ref = np.asarray(out["feat"])
    model = create("resnet50", norm=True)
    model.load_state_dict(resnet_state_dict_from_jax(params, stats))
    model = model.double().train()
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                with_gan_feat=False)["feat"]
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-9)
    for k, v in _stats_tree(model).items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-6, atol=1e-7, err_msg=k)
