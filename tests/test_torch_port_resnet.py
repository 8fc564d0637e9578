"""Port parity: the fused eval head (kernel K2's plain version) and the
eval-mode ``ReIDResNet`` against the JAX package, with weights moved by
``resnet_state_dict_from_jax``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _randomize(tree, rng, kind):
    """Numpy copy of a flax tree with BN stats / scales drawn from ``rng``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(v, rng, kind)
        elif kind == "stats" and k == "mean":
            out[k] = (rng.rand(*v.shape) * 0.2 - 0.1).astype(np.float32)
        elif kind == "stats" and k == "var":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif kind == "params" and k == "scale":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif kind == "params" and k == "bias":
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_gem_bn_l2n_plain_matches_jax_head():
    """GeM(p) → feat_bn (eval, no bias) → ε-outside L2, on one layer4-shaped
    map: rtol 1e-5 (fp32, sums over 128 positions in different orders)."""
    from reid_gan_tpu.models.pooling import GeneralizedMeanPooling
    from reid_gan_tpu.models.resnet import _l2n
    from reid_gan_tpu.ops.norm import TorchBatchNorm
    from reid_gan_torch.models.pooling import gem_bn_l2n

    rng = np.random.RandomState(0)
    n, h, w, c = 3, 16, 8, 64
    fmap = (rng.rand(n, h, w, c) * 2.0).astype(np.float32)
    fmap[0, :, :, 0] = 0.0                           # exercises the clip
    p = np.array([3.2], np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    mean = (rng.rand(c) * 0.2).astype(np.float32)
    var = (rng.rand(c) + 0.5).astype(np.float32)

    pooled = GeneralizedMeanPooling().apply({"params": {"p": jnp.asarray(p)}},
                                            jnp.asarray(fmap))
    bn = TorchBatchNorm(use_running_average=True, use_bias=False).apply(
        {"params": {"scale": jnp.asarray(gamma)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
        pooled)
    ref = np.asarray(_l2n(bn))

    out = gem_bn_l2n(torch.from_numpy(fmap).permute(0, 3, 1, 2),
                     torch.from_numpy(p), torch.from_numpy(gamma),
                     torch.from_numpy(mean), torch.from_numpy(var))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("depth", [18, 50])
def test_reid_resnet_eval_matches_jax(depth):
    """Random JAX weights (BN stats, scales, GeM p drawn from a seed) moved
    into the port: eval features at 64x32, batch 3, fp32, JAX at highest
    matmul precision; rtol 2e-3 / atol 2e-4 as test_torch_interop.py uses."""
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    rng = np.random.RandomState(depth)
    jmodel = JaxReIDResNet(depth=depth)
    variables = jmodel.init(jax.random.PRNGKey(depth),
                            jnp.zeros((2, 64, 32, 3)), train=False)
    params = _randomize(variables["params"], rng, "params")
    params["gap"]["p"] = np.array([3.2], np.float32)
    batch_stats = _randomize(variables["batch_stats"], rng, "stats")
    img = rng.rand(3, 64, 32, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply({"params": params, "batch_stats": batch_stats},
                                      jnp.asarray(img), train=False)["feat"])

    model = create(f"resnet{depth}").eval()
    model.load_state_dict(resnet_state_dict_from_jax(params, batch_stats),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    assert out.shape == (3, 2048 if depth == 50 else 512)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-4)


def test_state_dict_round_trips_through_jax_importer():
    """resnet_state_dict_from_jax inverts import_torch_resnet: every key of
    the port's model is written, and importing the result back into the JAX
    tree reproduces every leaf exactly."""
    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_tpu.models.resnet import import_torch_resnet
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import resnet_state_dict_from_jax

    rng = np.random.RandomState(7)
    variables = JaxReIDResNet(depth=18).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 16, 3)), train=False)
    params = _randomize(variables["params"], rng, "params")
    batch_stats = _randomize(variables["batch_stats"], rng, "stats")
    sd = resnet_state_dict_from_jax(params, batch_stats)
    assert set(sd) == set(create("resnet18").state_dict())

    back_p, back_s, unmatched = import_torch_resnet(
        {k: v.numpy() for k, v in sd.items()}, variables["params"],
        variables["batch_stats"])
    assert sorted(unmatched) == ["feat_bn.bias", "gap.p"]  # frozen zero; GeM p

    def leaves(tree):
        return jax.tree_util.tree_leaves_with_path(tree)

    for (path, a), (_, b) in zip(leaves(back_s), leaves(batch_stats)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    params.pop("gap")
    back_p.pop("gap")
    for (path, a), (_, b) in zip(leaves(back_p), leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
