"""The data mesh with ``--fp16`` and ``--dsbn``, on four gloo ranks
(``torch_mesh_ranks.spawn``) against the JAX package under ``get_mesh(4)``
on the conftest's virtual CPU devices:

- one USL update of the bf16 resnet18 (``ClusterContrastTrainer.update``
  on an augmented batch of 16, 4 rows a rank) against JAX's
  ``value_and_grad`` of the same loss with the bf16 and the fp32 module on
  the batch sharded over the mesh, compiled with
  ``xla_allow_excess_precision`` off (``test_torch_port_fp16.bf16_jit``):
  the loss and the gradient tree within twice JAX's own bf16-to-fp32 gap
  (``test_torch_port_fp16.assert_closer``/``assert_tree_closer``). On the
  ranks every BatchNorm is the global one, every averaged gradient fp32,
  and the gradient the first BatchNorm hands back to its convolution bf16;
- ``cli/test --dsbn`` of one JAX-written DSBN checkpoint, with the target
  and with the source domain's BatchNorms, against the JAX CLI on its mesh:
  CMC top-1/5/10 and mAP within 1e-4."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_fp16 import assert_closer, assert_tree_closer, bf16_jit, encoder_pair
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from torch_mesh_ranks import spawn


def test_bf16_usl_update_on_four_ranks_matches_the_jax_mesh_step(tmp_path):
    """The bf16 USL update on four ranks against JAX's bf16 and fp32 steps
    on the sharded batch (the module's docstring)."""
    import torch_mesh_ranks
    from test_torch_port_train import D, K, K_PAD, NV, _bank, _batch
    from reid_gan_tpu.ops.cluster_memory import MemoryState, memory_loss
    from reid_gan_tpu.ops.transforms import reid_augment
    from reid_gan_tpu.parallel.mesh import get_mesh, replicate, shard_batch
    from reid_gan_torch.models.convert import state_dict_from_flax

    j32, j16, v, port = encoder_pair("resnet18", 25)
    img, y = _batch(26)
    x = np.array(reid_augment(jax.random.PRNGKey(27), jnp.asarray(img), height=64, width=32,
                              train=True), np.float32)
    bank = _bank(28, np.float32)
    feats = jnp.asarray(np.concatenate([bank, np.zeros((K_PAD - NV, D), np.float32)]))
    mesh = get_mesh(4)
    params, xs, ys = replicate(mesh, v["params"]), *shard_batch(mesh, (x, y))
    keep = {k for k in port.state_dict() if "running" not in k
            and not k.endswith(("num_batches_tracked", "feat_bn.bias"))}

    def jax_step(m):
        def loss_fn(p, x, y):
            out, _ = m.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
                             mutable=["batch_stats"])
            losses, _ = memory_loss(out["feat"], y, MemoryState(
                feats, jnp.zeros((0, D)), jnp.int32(NV)), temp=0.05)
            return losses.mean()
        loss, g = bf16_jit(jax.value_and_grad(loss_fn), params, xs, ys)
        return float(loss), {k: t.numpy() for k, t in state_dict_from_flax(
            port, {"params": jax.tree.map(np.asarray, g),
                   "batch_stats": v["batch_stats"]}).items() if k in keep}

    ref = {"32": jax_step(j32), "16": jax_step(j16)}
    sd = {k: t.numpy() for k, t in state_dict_from_flax(port, v).items()}
    got = spawn(torch_mesh_ranks.bf16_usl_update, 4, tmp_path, sd, bank,
                np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y, 64, 32, K, K_PAD)
    assert got["norms"] == ["GlobalBatchNorm"]
    assert got["grad_dtypes"] == ["torch.float32"]
    assert got["conv1_out_grad"] == "torch.bfloat16"
    grads = {k: a for k, a in got["grads"].items() if k in keep}
    assert sorted(grads) == sorted(ref["16"][1])
    assert_closer(got["loss"], ref["16"][0], ref["32"][0], "USL loss under the mesh")
    assert_tree_closer(grads, ref["16"][1], ref["32"][1], "USL gradients under the mesh")


_DOMAINS = {"target": [], "source": ["--test-source"]}


@pytest.fixture(scope="module")
def dsbn_ranks(tmp_path_factory):
    """One DSBN checkpoint (``test_torch_port_dsbn``'s: the target domain's
    BatchNorm stats and ``feat_bn`` drawn apart from the source's) and
    ``cli/test --dsbn`` on four gloo ranks for each domain, both in one
    spawn (``torch_mesh_ranks.each``). Returns the CLI's flags without
    ``--test-source`` and each domain's (cmc, mAP)."""
    import torch_mesh_ranks
    from test_torch_port_dsbn import ARGS, _variables
    from reid_gan_tpu.models.dsbn import convert_dsbn, update_domain
    from reid_gan_tpu.utils.serialization import save_checkpoint

    root = tmp_path_factory.mktemp("dsbn")
    v, tgt = _variables(32), _variables(33)
    tgt["params"] = jax.tree_util.tree_map(lambda a: a, v["params"])
    tgt["params"]["feat_bn"] = _variables(34)["params"]["feat_bn"]
    ckpt = str(root / "dsbn.msgpack")
    save_checkpoint({"dsbn": update_domain(convert_dsbn(v), 1, tgt), "epoch": 3,
                     "best_mAP": 0.5}, False, ckpt)
    args = ARGS + ["--data-dir", str(root), "--resume", ckpt, "--dsbn"]
    calls = []
    for domain, flag in _DOMAINS.items():
        (root / domain).mkdir()
        calls.append(("test", args + flag + ["--device", "cpu"], str(root / domain)))
    got = spawn(torch_mesh_ranks.each, 4, root, torch_mesh_ranks.cli_main, calls)
    return args, dict(zip(_DOMAINS, got))


@pytest.mark.parametrize("domain", list(_DOMAINS))
def test_dsbn_eval_cli_on_four_ranks_matches_the_jax_cli_on_its_mesh(dsbn_ranks, domain):
    """Every rank loads the DSBN checkpoint and folds the domain's
    BatchNorms before the sharded eval; the result is the JAX CLI's on
    ``get_mesh(4)``."""
    from reid_gan_tpu.cli.test import main as jax_main
    from reid_gan_tpu.parallel.mesh import get_mesh

    args, got = dsbn_ranks
    ref_cmc, ref_map = jax_main(args + _DOMAINS[domain], mesh=get_mesh(4))
    sys.stdout = sys.__stdout__
    cmc, mAP = got[domain]
    for k in (1, 5, 10):
        assert abs(cmc[k - 1] - ref_cmc[k - 1]) <= 1e-4, k
    assert abs(mAP - ref_map) <= 1e-4
