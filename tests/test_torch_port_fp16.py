"""Port parity for ``--fp16``: bf16 compute as the JAX package defines it
(``dtype=jnp.bfloat16``: bf16 convolutions and dense layers, norms reducing
in and emitting fp32, fp32 parameters), against the JAX modules with
``dtype=jnp.bfloat16`` on XLA:CPU.

Each check holds the port's bf16 result against JAX's bf16 result, and
measures in the same test how far JAX's bf16 result lies from JAX's fp32
one: the port's gap (max |port - jax_bf16|, or the relative L2 of a
gradient tree) must be at most ``FACTOR`` = 2 times JAX's own bf16 gap. Two
bf16 evaluations of the same function round different fp32 sums to bf16
(the summation orders differ), and each such rounding flip moves what
follows by a bf16 ulp, so the two part by about the bf16 gap itself: over
a tensor the ratio of the gaps settles near sqrt(2). A scalar (a loss) is
one draw of that ratio, so a loss may also lie within ``SCALAR_ULPS`` = 2
bf16 ulps (2 x 2^-8 of its fp32 value) of JAX's bf16 loss. A gradient
tree's gap must also stay under ``TREE_CAP`` = 0.5 and its norm within
``NORM_RATIO`` = 1.2 of JAX's bf16 tree's (``assert_tree_closer``), since
JAX's own bf16 gap over a tree can reach a third.

JAX's bf16 programs are compiled with ``xla_allow_excess_precision`` off
(``bf16_jit``): by default XLA keeps a bf16 value in fp32 where an fp32 op
consumes it, which the modules' ``dtype`` does not ask for and the card
does not do (on the USL step's weights below the default program's loss
sat 0.0038 from the fp32 loss, the exact one's 0.0052, the port's 0.0144).
Weights are drawn with numpy in the JAX trees and moved across by the
port's converters. Also the dtypes at JAX's boundaries: parameters and
gradients fp32, BatchNorm and instance-norm outputs fp32, convolution
outputs bf16, the map promoted before the heads, G's and D's outputs fp32.

resnet18, resnet18 with IBN-a, the bi-path ResNetBipD at depth 18, at
64x32, batch 4; the pose G, the AE G and D at 16x8 (ngf 8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

FACTOR = 2.0
SCALAR_ULPS = 2
TREE_CAP = 0.5
NORM_RATIO = 1.2
H, W, N = 64, 32, 4


def bf16_jit(fn, *args):
    """``fn(*args)`` compiled by XLA with every bf16 rounding the program
    asks for (``xla_allow_excess_precision`` off)."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def assert_closer(port, j16, j32, what, gap=_gap, factor=FACTOR):
    """The port's bf16 result within ``factor`` times JAX's bf16 gap (a
    scalar also within ``SCALAR_ULPS`` bf16 ulps of its value); a tensor's
    gap to JAX's fp32 result at least a tenth of JAX's bf16 gap (the port
    does compute in bf16)."""
    port_gap, jax_gap = gap(port, j16), gap(j16, j32)
    assert jax_gap > 0, f"{what}: JAX's bf16 result equals its fp32 one"
    if np.ndim(j32) == 0 and not isinstance(j32, dict):
        jax_gap = max(jax_gap, SCALAR_ULPS * 2.0 ** -8 * abs(float(j32)) / factor)
    else:
        assert gap(port, j32) >= jax_gap / 10, f"{what}: the port's result is fp32's"
    assert port_gap <= factor * jax_gap, \
        f"{what}: |port - jax_bf16| {port_gap:.3g} > {factor} x |jax_bf16 - jax_fp32| {jax_gap:.3g}"
    return port_gap, jax_gap


def _draw(shapes, rng):
    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if "scale" in name or "var" in name:
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if "'p'" in name:
            return np.full(leaf.shape, 3.2, np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def encoder_pair(kind, seed):
    """(JAX fp32 module, JAX bf16 module, variables, the port's bf16 model
    with the same weights) for ``kind``: resnet18, ibn18 or bipd18."""
    from reid_gan_tpu.models.resnet import ReIDResNet as JR
    from reid_gan_tpu.models.resnet_variants import ResNetBipD as JB
    from reid_gan_torch.models.convert import state_dict_from_flax
    from reid_gan_torch.models.precision import set_compute_dtype
    from reid_gan_torch.models.resnet import ReIDResNet
    from reid_gan_torch.models.resnet_variants import ResNetBipD

    if kind == "bipd18":
        j32, j16, port = JB(depth=18), JB(depth=18, dtype=jnp.bfloat16), ResNetBipD(depth=18)
    else:
        ibn = kind == "ibn18"
        j32, j16 = JR(depth=18, ibn=ibn, norm=True), JR(depth=18, ibn=ibn, norm=True,
                                                        dtype=jnp.bfloat16)
        port = ReIDResNet(depth=18, ibn=ibn, norm=True)
    shapes = jax.eval_shape(lambda: j32.init(jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)),
                                             train=True))
    v = _draw({"params": shapes["params"], "batch_stats": shapes["batch_stats"]},
              np.random.RandomState(seed))
    port.load_state_dict(state_dict_from_flax(port, v))
    return j32, j16, v, set_compute_dtype(port, torch.bfloat16)


@pytest.mark.parametrize("kind", ["resnet18", "ibn18", "bipd18"])
def test_encoder_bf16_forwards_match_jax(kind):
    """Eval (``feat``) and train (``feat``, the NCHW ``gan_feat`` map and
    the updated running stats) forwards of the bf16 encoder."""
    from reid_gan_torch.models.convert import state_dict_from_flax

    j32, j16, v, port = encoder_pair(kind, 0)
    x = np.random.RandomState(1).rand(N, H, W, 3).astype(np.float32) * 2 - 1
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()

    def feat(out):
        return np.asarray(out["feat"] if isinstance(out, dict) else out)

    ref = {n: feat(m.apply(v, x, train=False)) for n, m in (("32", j32), ("16", j16))}
    with torch.no_grad():
        got = port.eval()(xt)
    assert got.dtype == torch.float32
    assert_closer(got.numpy(), ref["16"], ref["32"], f"{kind} eval feat")

    ref = {n: m.apply(v, x, train=True, mutable=["batch_stats"]) for n, m in
           (("32", j32), ("16", j16))}
    got = port.train()(xt)
    assert_closer(got["feat"].detach().numpy(), np.asarray(ref["16"][0]["feat"]),
                  np.asarray(ref["32"][0]["feat"]), f"{kind} train feat")
    assert_closer(got["gan_feat"].permute(0, 2, 3, 1).numpy(),
                  np.asarray(ref["16"][0]["gan_feat"]), np.asarray(ref["32"][0]["gan_feat"]),
                  f"{kind} gan_feat")
    stats = {n: {k: t.numpy() for k, t in state_dict_from_flax(port, dict(
        v, batch_stats=jax.tree.map(np.asarray, r[1]["batch_stats"]))).items()
        if "running" in k} for n, r in ref.items()}
    for k, t in port.state_dict().items():
        if "running" in k:
            assert_closer(t.numpy(), stats["16"][k], stats["32"][k], f"{kind} {k}")


def _gan(gen, dtype):
    from test_torch_port_gan_nets import GH, GW, REID
    from reid_gan_tpu.config import GANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel

    return AEModel(GANConfig(model="AE", model_gen=gen), gan_height=GH, gan_width=GW,
                   num_feats=32, ngf=8, num_blocks=1, reid_feat_dim=REID, dtype=dtype)


def gan_pair(gen, seed):
    """(JAX fp32 engine, JAX bf16 engine, G and D variables, the port's bf16
    G and D with the same weights)."""
    from test_torch_port_gan_nets import REID, gan_variables
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.dual_gan.networks import define_D, define_G
    from reid_gan_torch.models.precision import set_compute_dtype

    j32, j16 = _gan(gen, None), _gan(gen, jnp.bfloat16)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    G, D = (f32(t) for t in gan_variables(j32, seed))
    g = define_G(gen, pose_nc=18, ngf=8, img_f=32, reid_nc=REID, num_blocks=1)
    d = define_D()
    for net, var in ((g, G), (d, D)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
        set_compute_dtype(net, torch.bfloat16)
    return j32, j16, G, D, g, d


def _gan_inputs(gen, rng):
    from test_torch_port_gan_nets import B, GH, GW, REID

    if gen == "Pose":
        args = (rng.rand(B, GH // 8, GW // 8, REID).astype(np.float32),
                rng.rand(B, GH, GW, 18).astype(np.float32))
    else:
        args = (rng.rand(B, GH, GW, 3).astype(np.float32) * 2 - 1,)
    return args, tuple(torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in args)


@pytest.mark.parametrize("gen", ["Pose", "AE"])
def test_gan_bf16_forwards_match_jax(gen):
    """The bf16 G (eval and train) and D (eval) forwards, in fp32 out."""
    j32, j16, G, D, g, d = gan_pair(gen, 0)
    args, targs = _gan_inputs(gen, np.random.RandomState(1))
    for train in (False, True):
        ref = {}
        for n, j in (("32", j32), ("16", j16)):
            out = j.net_G.apply(G, *args, train=train, mutable=["batch_stats"])[0] \
                if train else j.net_G.apply(G, *args, train=False)
            ref[n] = np.asarray(out)
        out = g.train(train)(*targs)
        assert out.dtype == torch.float32
        assert_closer(out.detach().permute(0, 2, 3, 1).numpy(), ref["16"], ref["32"],
                      f"{gen} G train={train}")
    x = ref["32"]
    ref = {n: np.asarray(j.net_D.apply(D, x, train=False)) for n, j in (("32", j32),
                                                                         ("16", j16))}
    with torch.no_grad():
        out = d.eval()(torch.from_numpy(x.copy()).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32
    assert_closer(out.permute(0, 2, 3, 1).numpy(), ref["16"], ref["32"], f"{gen} D")


def test_bf16_dtypes_at_the_jax_boundaries():
    """resnet18 with IBN-a in bf16, train mode, one backward: every
    convolution emits bf16, every BatchNorm and instance norm fp32, the IBN
    split fp32, layer4's map fp32 before the heads; parameters and
    gradients stay fp32. The pose and AE G emit fp32, D fp32, and an
    instance-norm generator block's norms fp32."""
    from reid_gan_torch.models.dual_gan.base_function import ResBlock
    from reid_gan_torch.models.precision import Conv2d, set_compute_dtype
    from reid_gan_torch.models.resnet import IBN

    _, _, _, port = encoder_pair("ibn18", 2)
    seen = []

    def hook(m, inp, out):
        seen.append((type(m).__name__, out.dtype))

    for m in port.modules():
        if isinstance(m, (Conv2d, torch.nn.BatchNorm2d, torch.nn.InstanceNorm2d, IBN)):
            m.register_forward_hook(hook)
    maps = []
    port.layer4.register_forward_hook(lambda m, i, o: maps.append(o.dtype))
    out = port.train()(torch.rand(N, 3, H, W))
    out["feat"].sum().backward()
    kinds = {}
    for name, dtype in seen:
        kinds.setdefault(name, set()).add(dtype)
    assert kinds == {"Conv2d": {torch.bfloat16}, "BatchNorm2d": {torch.float32},
                     "InstanceNorm2d": {torch.float32}, "IBN": {torch.float32}}
    assert maps == [torch.float32] and out["feat"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(p.grad.dtype == torch.float32 for p in port.parameters() if p.grad is not None)

    _, _, _, _, g, d = gan_pair("Pose", 3)
    _, targs = _gan_inputs("Pose", np.random.RandomState(4))
    fake = g.train()(*targs)
    assert fake.dtype == torch.float32 and d(fake).dtype == torch.float32
    block = set_compute_dtype(ResBlock(8, 8, norm="instance"), torch.bfloat16)
    norms = []
    for m in (block.norm1, block.norm2):
        m.register_forward_hook(lambda m, i, o: norms.append(o.dtype))
    assert block(torch.rand(2, 8, 4, 4)).dtype == torch.bfloat16
    assert norms == [torch.float32, torch.float32]


def _rel(a, b):
    """Relative L2 gap of two gradient dicts (the same keys)."""
    num = sum(float(np.sum((np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)) ** 2))
              for k in b)
    den = sum(float(np.sum(np.asarray(b[k], np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def _sq(tree):
    return sum(float(np.sum(np.asarray(v, np.float64) ** 2)) for v in tree.values())


def assert_tree_closer(port, j16, j32, what, factor=FACTOR):
    """A gradient tree (relative L2): ``assert_closer``, and, since JAX's
    own bf16 gap can be large (0.37 for the joint step's encoder; the
    BatchNorm backward passes take out most of a gradient and leave the
    rounding), the port's gap under ``TREE_CAP`` and its norm within
    ``NORM_RATIO`` of JAX's bf16 tree's: a zero tree (gap 1) or a
    half-scaled one (norm ratio 0.5) fails whatever JAX's gap."""
    port_gap, _ = assert_closer(port, j16, j32, what, gap=_rel, factor=factor)
    ratio = (_sq(port) / _sq(j16)) ** 0.5
    assert port_gap <= TREE_CAP, f"{what}: |port - jax_bf16| {port_gap:.3g} > {TREE_CAP}"
    assert 1 / NORM_RATIO <= ratio <= NORM_RATIO, f"{what}: |port| / |jax_bf16| {ratio:.3g}"


def test_usl_step_bf16_matches_jax():
    """One USL step (forward, InfoNCE against a bank of 8 live rows, backward)
    of the bf16 resnet18 in the port's ``ClusterContrastTrainer.update``
    against JAX's ``value_and_grad`` of the same loss with the bf16 and fp32
    modules: the loss, and the whole gradient tree (relative L2)."""
    from test_torch_port_train import D, K, K_PAD, NV, _bank, _batch
    from reid_gan_tpu.models.resnet import ReIDResNet as JR
    from reid_gan_tpu.ops.cluster_memory import MemoryState, memory_loss
    from reid_gan_tpu.ops.transforms import reid_augment
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models.convert import flax_variables_from_model, state_dict_from_flax
    from reid_gan_torch.ops.cluster_memory import init_memory

    j32, j16, v, port = encoder_pair("resnet18", 5)
    img, y = _batch(6)
    x = np.array(reid_augment(jax.random.PRNGKey(7), jnp.asarray(img), height=H, width=W,
                                train=True), np.float32)
    bank = _bank(8, np.float32)
    feats = jnp.asarray(np.concatenate([bank, np.zeros((K_PAD - NV, D), np.float32)]))

    def jax_step(m):
        def loss_fn(p):
            out, _ = m.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
                             mutable=["batch_stats"])
            losses, _ = memory_loss(out["feat"], jnp.asarray(y), MemoryState(
                feats, jnp.zeros((0, D)), jnp.int32(NV)), temp=0.05)
            return losses.mean()
        loss, g = bf16_jit(jax.value_and_grad(loss_fn), v["params"])
        return float(loss), {k: t.numpy() for k, t in state_dict_from_flax(
            port, {"params": jax.tree.map(np.asarray, g),
                   "batch_stats": v["batch_stats"]}).items() if "running" not in k
            and not k.endswith(("num_batches_tracked", "feat_bn.bias"))}

    ref = {"32": jax_step(j32), "16": jax_step(j16)}
    trainer = ClusterContrastTrainer(port, height=H, width=W, num_instances=K, device="cpu")
    state = trainer.init_state(init_memory(bank, k_pad=K_PAD, device="cpu"))
    _, loss = trainer.update(state, torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(y))
    grads = {n: q.grad.numpy() for n, q in port.named_parameters() if n in ref["16"][1]}
    assert sorted(grads) == sorted(ref["16"][1])
    assert all(q.dtype == torch.float32 for q in port.parameters())
    assert all(t.dtype == torch.float32 for s in state.optimizer.state.values()
               for t in s.values() if torch.is_tensor(t) and t.dim())
    assert_closer(float(loss), ref["16"][0], ref["32"][0], "USL loss")
    assert_tree_closer(grads, ref["16"][1], ref["32"][1], "USL gradients")
    assert flax_variables_from_model(port)["params"]["base"]["conv1"]["kernel"].dtype == \
        np.float32
