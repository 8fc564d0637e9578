"""Port parity for domain-specific BatchNorm and the eval CLI's msgpack
``--resume``: the DSBN tree transforms against the JAX package's, and both
packages' ``cli/test`` on one JAX-written checkpoint (following
``tests/test_parity_wiring.py::test_dsbn_eval_cli``): ``--resume`` alone,
and ``--dsbn`` with and without ``--test-source``, CMC top-1/5/10 and mAP
within 1e-4 of the JAX CLI's, the source domain's result apart from the
target's."""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

ARGS = ["--dataset", "synthetic_hard", "--arch", "resnet18", "--height", "64", "--width", "32",
        "--batch-size", "64", "--workers", "2"]


def _variables(seed):
    """resnet18 variables in the JAX layout, drawn with numpy: kernels
    scaled by 1/sqrt(fan-in), BatchNorm scales and variances in [0.5, 1.5),
    biases and means near 0, GeM p 3.2."""
    from reid_gan_tpu.models import create

    m = create("resnet18")
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 32, 3)),
                                           train=True))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if "scale" in name or "var" in name:
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if "'p'" in name:
            return np.full(leaf.shape, 3.2, np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])}


def test_dsbn_transforms_match_jax():
    """``convert_dsbn``, ``select_domain``, ``update_domain`` and
    ``convert_bn`` give the JAX functions' trees, leaf for leaf, with one
    tree of dicts per domain."""
    from reid_gan_tpu.models import dsbn as jd
    from reid_gan_torch.models import dsbn as td

    v = _variables(0)
    ref, got = jd.convert_dsbn(v), td.convert_dsbn(v)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(got)
    assert sorted(got["domains"]) == ["d0", "d1"]
    tgt = jax.tree_util.tree_map(lambda x: x + 1.0, td.select_domain(got, 1))
    ref, got = jd.update_domain(ref, 1, tgt), td.update_domain(got, 1, tgt)
    for use_target in (True, False):
        a, b = jd.convert_bn(ref, use_target), td.convert_bn(got, use_target)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert td.convert_bn(got, False) is not td.convert_bn(got, True)


def _both(tmp_path, extra):
    from reid_gan_tpu.cli.test import main as jax_main
    from reid_gan_torch.cli.test import main as torch_main

    args = ARGS + ["--data-dir", str(tmp_path)] + extra
    ref = jax_main(args, mesh=False)
    sys.stdout = sys.__stdout__
    got = torch_main(args + ["--device", "cpu"])
    (ref_cmc, ref_map), (cmc, mAP) = ref, got
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4
    return [cmc[k - 1] for k in (1, 5, 10)], mAP


def test_resume_msgpack_eval_matches_jax_cli(tmp_path):
    """``cli/test --resume`` of a JAX ``save_checkpoint`` file (params,
    batch_stats, epoch, best_mAP): the port's CMC and mAP within 1e-4 of
    the JAX CLI's."""
    from reid_gan_tpu.utils.serialization import save_checkpoint

    ckpt = str(tmp_path / "model_best.msgpack")
    save_checkpoint(dict(_variables(1), epoch=2, best_mAP=0.25), False, ckpt)
    _both(tmp_path, ["--resume", ckpt])


def test_dsbn_eval_matches_jax_cli_for_both_domains(tmp_path):
    """One DSBN checkpoint written by the JAX package, its target domain's
    BatchNorm stats and scales drawn apart from the source's: ``--dsbn``
    (target) and ``--dsbn --test-source`` each within 1e-4 of the JAX CLI,
    and the two domains' results differ."""
    from reid_gan_tpu.models.dsbn import convert_dsbn, update_domain
    from reid_gan_tpu.utils.serialization import save_checkpoint

    v = _variables(2)
    tgt = _variables(3)
    tgt["params"] = jax.tree_util.tree_map(lambda x: x, v["params"])
    tgt["params"]["feat_bn"] = _variables(4)["params"]["feat_bn"]
    dsbn = update_domain(convert_dsbn(v), 1, tgt)
    ckpt = str(tmp_path / "dsbn.msgpack")
    save_checkpoint({"dsbn": dsbn, "epoch": 3, "best_mAP": 0.5}, False, ckpt)
    target = _both(tmp_path, ["--resume", ckpt, "--dsbn"])
    source = _both(tmp_path, ["--resume", ckpt, "--dsbn", "--test-source"])
    assert target != source


def test_dsbn_needs_a_msgpack_resume(tmp_path):
    """``--dsbn`` reads a DSBN msgpack checkpoint: without ``--resume
    <file>.msgpack`` it raises before any work."""
    from reid_gan_torch.cli.test import main

    for extra in ([], ["--resume", str(tmp_path / "checkpoint.pth.tar")]):
        with pytest.raises(ValueError, match="--dsbn reads a domain-specific BN"):
            main(["--device", "cpu", "--dsbn"] + extra)
