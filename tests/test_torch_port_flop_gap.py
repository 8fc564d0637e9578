"""The gap between the port's FLOP count (``utils/profiling.flops_of``,
torch's ``FlopCounterMode``) and XLA's ``cost_analysis``, which the JAX
speed scripts report, on ResNet-50's forward and backward in train mode:
torch counts the matmuls and convolutions, XLA every operation of the
compiled program, so torch's count is a few percent under XLA's. The
speed scripts' TFLOP/s of a backward read against the JAX scripts' through
this ratio. A file of its own: it compiles a JAX program of its own
(``test_torch_port_speed_scripts.py`` holds the eval forward, within 1%)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp


def test_flops_of_forward_backward_against_xla():
    """Batch 2 at 64x32, the gradient of ``feat.sum()`` with respect to the
    parameters: torch's count between 0.9 and 1.0 of XLA's (about 3.02
    against 3.17 GFLOP)."""
    from reid_gan_tpu.models import create as create_jax

    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.utils.profiling import flops_of

    torch.manual_seed(0)
    model = create("resnet50", norm=True).train()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 64, 32).astype(np.float32))
    params = [p for p in model.parameters() if p.requires_grad]
    got = flops_of(lambda: torch.autograd.grad(
        model(x, with_gan_feat=False)["feat"].sum(), params))
    jm = create_jax("resnet50", norm=True)
    v = flax_variables_from_model(model)

    def loss(p, bs, xx):
        out, _ = jm.apply({"params": p, "batch_stats": bs}, xx, train=True,
                          mutable=["batch_stats"])
        return out["feat"].sum()

    cost = jax.jit(jax.grad(loss)).lower(
        v["params"], v["batch_stats"],
        jnp.asarray(x.permute(0, 2, 3, 1).numpy())).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = cost["flops"] / 1e9
    print(f"forward and backward: torch {got:.4f} GFLOP, XLA {xla:.4f} GFLOP, "
          f"ratio {got / xla:.4f}")
    assert 0.9 < got / xla <= 1.0
