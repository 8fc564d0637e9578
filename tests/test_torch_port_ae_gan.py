"""Port parity for the AE generator path's modules, in fp64 against the JAX
package: ``ResBlock`` in its three sample types, the ``AEGenerator``'s
``forward_enc``/``forward_dec`` in train and eval mode (outputs and the
BatchNorm running stats), ``convert.py`` on the AE generator's tree,
``hard_mix`` (ties included) and the plain ``diff_transform`` (K12's plain
version) with its edge rows.

Small sizes: the AE generator at 16x8 with ngf 8, img_f 32 (3 layers, 3
blocks), batch 8 in 4 groups of 2. Weights are drawn with numpy into the
JAX trees (``jax.eval_shape`` gives them without compiling ``init``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_gan_nets import assert_stats_match
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

GH, GW, B, GROUP = 16, 8, 8, 2


def draw_tree(shapes, seed):
    """Numpy fp64 leaves for a tree of shapes: kernels scaled by
    1/sqrt(fan-in), BatchNorm scales and variances in [0.5, 1.5), biases
    and means near 0, spectral ``u`` normal, ``sigma`` 1."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name and len(leaf.shape) >= 2:
            return rng.randn(*leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        if "scale" in name or "var" in name:
            return rng.rand(*leaf.shape) + 0.5
        if "sigma" in name:
            return np.ones(leaf.shape)
        if "/u" in name:
            return rng.randn(*leaf.shape)
        return rng.randn(*leaf.shape) * 0.1

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_ae_gan():
    from reid_gan_tpu.config import GANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel

    return AEModel(GANConfig(model="AE", model_gen="AE"), gan_height=GH, gan_width=GW,
                   num_feats=32, ngf=8, reid_feat_dim=64)


def ae_variables(gan, seed):
    """(G, D) JAX variable trees of ``gan`` drawn by ``draw_tree``."""
    shapes = jax.eval_shape(gan.init_state, jax.random.PRNGKey(0))
    return draw_tree(shapes.G, seed), draw_tree(shapes.D, seed + 1)


def port_ae_generator(G):
    """The port's AE generator in fp64 with the JAX variables loaded."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.dual_gan.networks import define_G

    g = define_G("AE", ngf=8, img_f=32).double()
    g.load_state_dict(state_dict_from_jax(g, G["params"], G["batch_stats"]), strict=True)
    return g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("sample_type", ["none", "up", "down"])
def test_resblock_matches_jax(sample_type):
    """Train forward (output and the two BatchNorms' running stats), then an
    eval forward from the stored stats, fp64, outputs within 1e-9."""
    from reid_gan_tpu.models.dual_gan.base_function import ResBlock as JaxResBlock
    from reid_gan_torch.models.dual_gan.base_function import ResBlock
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    jblock = JaxResBlock(6, sample_type=sample_type)
    x = np.random.RandomState(3).randn(4, 8, 6, 5)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), x, train=True))
    var = draw_tree(shapes, 4)
    with jax.enable_x64(True):
        y, mut = jblock.apply(var, x, train=True, mutable=["batch_stats"])
        y_eval = jblock.apply({"params": var["params"],
                               "batch_stats": mut["batch_stats"]}, x, train=False)
    block = ResBlock(5, 6, sample_type=sample_type).double()
    block.load_state_dict(state_dict_from_jax(block, var["params"], var["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = block.train()(_nchw(x))
    want = {"none": (4, 8, 6, 6), "up": (4, 16, 12, 6), "down": (4, 4, 3, 6)}
    assert np.asarray(y).shape == want[sample_type]
    np.testing.assert_allclose(_nhwc(got), np.asarray(y), rtol=0, atol=1e-9)
    assert_stats_match(block, mut["batch_stats"], "ResBlock")
    # the eval forward reads the stats JAX stored (float32, ROADMAP C)
    block.load_state_dict(state_dict_from_jax(block, var["params"], mut["batch_stats"]))
    with torch.no_grad():
        got_eval = block.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got_eval), np.asarray(y_eval), rtol=0, atol=1e-9)


@pytest.mark.parametrize("train", [True, False])
def test_ae_generator_enc_dec_match_jax(train):
    """``forward_enc`` on the GAN images, then ``forward_dec`` on its
    features, each as the JAX method: outputs within 1e-9 and, in train
    mode, the running stats after both (each forward folds its own
    BatchNorms once)."""
    gan = jax_ae_gan()
    G, _ = ae_variables(gan, 0)
    img = np.tanh(np.random.RandomState(1).randn(B, GH, GW, 3))
    with jax.enable_x64(True):
        @jax.jit
        def fwd(G, img):
            if train:
                f, bs1 = gan.apply_G(G, img, train=True, method=gan.net_G.forward_enc,
                                     mutable=True)
                out, bs2 = gan.apply_G({"params": G["params"], "batch_stats": bs1}, f,
                                       train=True, method=gan.net_G.forward_dec,
                                       mutable=True)
                return f, out, bs2
            f = gan.apply_G(G, img, method=gan.net_G.forward_enc)
            return f, gan.apply_G(G, f, method=gan.net_G.forward_dec), G["batch_stats"]

        f, out, stats = jax.tree.map(np.asarray, fwd(G, img))
    g = port_ae_generator(G).train(train)
    with torch.no_grad():
        got_f = g.forward_enc(_nchw(img))
        got = g.forward_dec(got_f)
    assert f.shape == (B, GH // 8, GW // 8, 32) and out.shape == (B, GH, GW, 3)
    np.testing.assert_allclose(_nhwc(got_f), f, rtol=0, atol=1e-9)
    np.testing.assert_allclose(_nhwc(got), out, rtol=0, atol=1e-9)
    assert_stats_match(g, stats, "AE G")


def test_convert_ae_generator_tree_round_trip():
    """Every leaf of the JAX AE generator's tree lands on one ``state_dict``
    entry of the port's net (a strict load), and reading each entry back
    through the inverse layout gives the JAX leaf unchanged."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    gan = jax_ae_gan()
    G, _ = ae_variables(gan, 5)
    g = port_ae_generator(G)
    sd = g.state_dict()
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    seen = set()
    for tree in (G["params"], G["batch_stats"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path]
            key = ".".join(keys[:-1] + [names[keys[-1]]])
            t = sd[key].numpy()
            if isinstance(g.get_submodule(".".join(keys[:-1])), torch.nn.ConvTranspose2d) \
                    and keys[-1] == "kernel":         # (in, out, H, W) flipped → HWIO
                t = np.flip(t.transpose(2, 3, 0, 1), (0, 1))
            elif keys[-1] == "kernel":
                t = t.transpose(2, 3, 1, 0)           # OIHW → HWIO
            np.testing.assert_array_equal(t, np.asarray(leaf), err_msg=key)
            seen.add(key)
    assert seen == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert {"block0.conv1.conv.weight", "encoders_1.norm2.running_var",
            "mblocks_2.bypass.conv.weight", "decoder.decoder0.conv2.conv.weight",
            "decoder.outconv.conv1.conv.bias"} <= seen
    assert set(state_dict_from_jax(g, G["params"], G["batch_stats"])) == set(sd)


@pytest.mark.parametrize("tie", [False, True])
def test_hard_mix_matches_jax(tie):
    """The mixed features within 1e-12 (fp64). ``tie``: two members of a
    group share the farthest similarity and two outsiders the nearest, so
    both argmin and argmax take the first index."""
    from reid_gan_tpu.models.dual_gan.ae_model import hard_mix as jax_hard_mix
    from reid_gan_torch.models.dual_gan.ae_model import hard_mix

    rng = np.random.RandomState(6)
    reid = rng.randn(B, 16)
    f_s = rng.randn(B, 4, 2, 3)
    if tie:
        reid[1] = reid[0]            # group 0: both members equally far
        reid[5] = reid[4] = reid[3]  # group 1's nearest outsiders tie
    with jax.enable_x64(True):
        ref = np.asarray(jax_hard_mix(jnp.asarray(f_s).reshape(B, -1), jnp.asarray(reid),
                                      GROUP, 0.8))
    got = hard_mix(torch.from_numpy(f_s).reshape(B, -1), torch.from_numpy(reid), GROUP)
    assert got.shape == (B // GROUP, 24)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    if tie:   # the ties are there: group 0's two members, group 1's two outsiders
        unit = lambda v: v / np.sqrt((v * v).sum(-1, keepdims=True) + 1e-12)  # noqa: E731
        sim = unit(reid.reshape(B // GROUP, GROUP, -1).mean(1)) @ unit(reid).T
        out = np.where(np.arange(B)[None] // GROUP == np.arange(B // GROUP)[:, None],
                       -np.inf, sim)
        assert sim[0, 0] == sim[0, 1] and (out[1] == out[1].max()).sum() == 2


def _generated(n, h, w, seed):
    """Images in [-1, 1] with the extremes alternating along the first and
    last rows and columns, so the renormalised edge taps see full swings."""
    g = np.tanh(np.random.RandomState(seed).randn(n, h, w, 3) * 2)
    alt = np.where((np.arange(h)[:, None] + np.arange(w)[None]) % 2, 1.0, -1.0)
    for sl in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        g[sl] = alt[None, :, :, None][sl]
    return g


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("h,w", [(16, 8), (128, 64)])
def test_diff_transform_plain_matches_jax(dtype, tol, h, w):
    """(x + 1)/2 → JAX's bicubic 2x upsample (Keys a = −0.5, edge taps
    renormalised) → ImageNet normalise: the plain K12 against
    ``diff_transform``, every output pixel (edge rows and columns included),
    fp32 within 1e-6 (the two contractions' rounding) and fp64 within
    1e-12; NCHW out in channels_last memory."""
    from reid_gan_tpu.ops.transforms import diff_transform as jax_diff
    from reid_gan_torch.ops.transforms import diff_transform

    g = _generated(3, h, w, h).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax_diff(jnp.asarray(g), 2 * h, 2 * w))
    got = diff_transform(_nchw(g), 2 * h, 2 * w)
    assert got.dtype == torch.from_numpy(g).dtype and got.shape == (3, 3, 2 * h, 2 * w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=tol)


def test_cubic_weights_are_jax_taps():
    """The weight matrix of a 2x upsample: interior outputs take (−3, 29,
    111, −9)/128 on inputs i−2..i+1 (mirrored for odd outputs), and the
    first and last three outputs renormalise over the taps inside the
    image, as ``jax.image.resize`` on unit impulses gives them (fp64)."""
    from reid_gan_torch.ops.transforms import cubic_resize_weights

    n = 8
    w = cubic_resize_weights(n, 2 * n, torch.float64).numpy()
    with jax.enable_x64(True):
        ref = np.stack([np.asarray(jax.image.resize(jnp.eye(n)[i], (2 * n,), "bicubic"))
                        for i in range(n)])
    np.testing.assert_allclose(w, ref, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(w[1:5, 6], np.array([-3, 29, 111, -9]) / 128)
    np.testing.assert_array_equal(w[2:6, 7], np.array([-9, 111, 29, -3]) / 128)
    np.testing.assert_allclose(w[:2, 0], (1.088235, -0.088235), atol=1e-6)
    np.testing.assert_allclose(w[:3, 1], (0.810219, 0.211679, -0.021898), atol=1e-6)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-15)
