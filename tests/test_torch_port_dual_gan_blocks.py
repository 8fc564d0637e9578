"""Port parity for the dual_gan building blocks that the DEC, FD, PoseAE and
DPTN generators add: instance norm, ``use_coord``, ``FeatureAdaptBlock``,
``ResUP12Block``, ``AutoAttn`` (short and long form), ``PTM`` and
``_SeqNorm('instance')``. Each JAX module runs in train mode in fp64 on
weights drawn with numpy in its tree (``jax.eval_shape``), carried to the
port's module by ``models/dual_gan/convert.py``: the outputs, then the
BatchNorm running stats (1e-6 relative: fp32 on the JAX side, ROADMAP C)
and spectral ``u``/``sigma``. The JAX instance norms reduce in fp32 even
under x64 (ROADMAP C), so blocks with one hold 1e-6; the port's own
instance norm is held against an fp64 formula at 1e-12."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import draw_tree
from test_torch_port_gan_nets import assert_stats_match
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

B = 4


def module_variables(jmod, *inputs, seed=0, **kw):
    """``draw_tree`` for ``jmod`` on ``inputs``; ``kw`` goes to its
    call (with ``train=True`` unless it is given; ``train=None``: none)."""
    kw = {k: v for k, v in {"train": True, **kw}.items() if v is not None}
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *inputs, **kw))
    v = draw_tree(shapes, seed)
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4
                                                 else a))


def nhwc(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def check_module(jmod, mod, inputs, seed=0, atol=1e-9, jax_kw=None, **kw):
    """Train-mode forward of the JAX module and the port's, fp64, from the
    same carried weights. ``inputs``: NHWC (or flat) numpy arrays;
    ``jax_kw``: the JAX call's keywords (default ``train=True``; ``train=None``
    for a module without it), ``kw``
    the port's. Returns (the port's output, the JAX output) after holding
    them within ``atol`` and the stats after the forward."""
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    v = module_variables(jmod, *inputs, seed=seed, **(jax_kw or {}))
    jax_kw = {k: a for k, a in {"train": True, **(jax_kw or {})}.items() if a is not None}
    with jax.enable_x64(True):
        ref, mut = jmod.apply(v, *[jnp.asarray(x) for x in inputs],
                              mutable=["batch_stats"], **jax_kw)
    mod = mod.double()
    mod.load_state_dict(state_dict_from_jax(mod, v["params"], v["batch_stats"]),
                        strict=True)
    mod.train()
    with torch.no_grad():
        got = mod(*[nchw(x) for x in inputs], **kw)
    outs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(*outs):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=0, atol=atol)
    if mut.get("batch_stats"):
        assert_stats_match(mod, mut["batch_stats"], type(mod).__name__)
    return got, ref


def test_instance_norm_matches_jax_and_the_fp64_formula():
    """``make_norm("instance")`` against flax's ``_InstanceNorm`` (per sample
    and channel over H and W, biased variance, eps 1e-5, affine): within
    1e-6 of JAX (which reduces in fp32), within 1e-12 of the fp64
    formula; and an ``EncoderBlock`` with instance norm."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf

    x = np.random.RandomState(1).randn(B, 6, 4, 5) * 3 + 1
    got, _ = check_module(jbf._InstanceNorm(), bf.make_norm("instance", 5), [x], atol=1e-6,
                          jax_kw={"train": None})
    mean = x.mean(axis=(1, 2), keepdims=True)
    var = x.var(axis=(1, 2), keepdims=True)
    v = module_variables(jbf._InstanceNorm(), x, train=None)["params"]
    ref = (x - mean) / np.sqrt(var + 1e-5) * v["scale"] + v["bias"]
    np.testing.assert_allclose(nhwc(got), ref, rtol=0, atol=1e-12)
    check_module(jbf.EncoderBlock(6, norm="instance"),
                 bf.EncoderBlock(5, 6, norm="instance"), [x], seed=2, atol=1e-6)


@pytest.mark.parametrize("block", ["conv", "resblock", "output"])
def test_use_coord_matches_jax(block):
    """``use_coord`` (the coordinate channels after the input's) in a
    spectral ``SpectralConv``, a ``ResBlock`` (both convs and the bypass)
    and an ``Output`` (coordinates on the padded map): fp64 within 1e-9,
    the spectral and BatchNorm stats after."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf

    x = np.random.RandomState(3).randn(B, 6, 4, 5)
    if block == "conv":
        jmod = jbf.SpectralConv(7, (3, 3), padding=1, use_spect=True, use_coord=True)
        mod = bf.SpectralConv(5, 7, 3, 1, 1, use_spect=True, use_coord=True)
    elif block == "resblock":
        jmod = jbf.ResBlock(7, use_spect=True, use_coord=True)
        mod = bf.ResBlock(5, 7, use_spect=True, use_coord=True)
    else:
        jmod = jbf.Output(3, 3, norm="batch", use_coord=True)
        mod = bf.Output(5, 3, 3, norm="batch", use_coord=True)
    assert mod.state_dict()[next(k for k in mod.state_dict() if k.endswith(
        "conv.weight"))].shape[1] == 5 + 2
    check_module(jmod, mod, [x], seed=4)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_feature_adapt_block_matches_jax(norm):
    """``FeatureAdaptBlock``: a (B, C) vector through the VALID (8, 4)
    transposed conv on its 1×1 map (the flipped kernel, no crop), the norm
    and the act."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf

    x = np.random.RandomState(5).randn(B, 12)
    got, _ = check_module(jbf.FeatureAdaptBlock(6, (8, 4), norm=norm),
                          bf.FeatureAdaptBlock(12, 6, (8, 4), norm=norm), [x], seed=6,
                          atol=1e-9 if norm == "batch" else 1e-6)
    assert got.shape == (B, 6, 8, 4)


@pytest.mark.parametrize("use_spect", [False, True])
def test_res_up12_block_matches_jax(use_spect):
    """``ResUP12Block``: the anisotropic (5, 3) kernel of stride (4, 2) with
    flax's SAME, both branches, with and without spectral norm."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf

    x = np.random.RandomState(7).randn(B, 3, 2, 6)
    got, _ = check_module(jbf.ResUP12Block(5, use_spect=use_spect),
                          bf.ResUP12Block(6, 5, use_spect=use_spect), [x], seed=8)
    assert got.shape == (B, 5, 12, 4)


@pytest.mark.parametrize("kernel,stride", [((3, 3), (2, 2)), ((5, 3), (4, 2)),
                                           ((4, 2), (4, 2)), ((2, 3), (1, 3))])
def test_spectral_conv_transpose_same_crop_matches_flax(kernel, stride):
    """``SpectralConvTranspose`` at the kernel and stride pairs whose flax
    SAME padding ahead is ``k − 1`` on each axis (``k − 1 ≤ s ≤ k``): the
    cropped transposed conv against flax's."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf

    x = np.random.RandomState(9).randn(B, 3, 2, 5)
    got, _ = check_module(jbf.SpectralConvTranspose(4, kernel, stride),
                          bf.SpectralConvTranspose(5, 4, kernel, stride), [x], seed=10)
    assert got.shape == (B, 4, 3 * stride[0], 2 * stride[1])


@pytest.mark.parametrize("kernel,stride", [(3, 4), (3, 1), ((5, 3), (2, 2))])
def test_spectral_conv_transpose_refuses_other_crops(kernel, stride):
    """A stride above the kernel or below ``k − 1`` pads other than ``k − 1``
    ahead under flax SAME, so the first rows are not flax's crop: raise."""
    from reid_gan_torch.models.dual_gan import base_function as bf

    with pytest.raises(ValueError, match="flax SAME crop"):
        bf.SpectralConvTranspose(5, 4, kernel, stride)


@pytest.mark.parametrize("form", ["short", "long"])
def test_auto_attn_matches_jax(form):
    """``AutoAttn``: the short form (query conv, q·qᵀ softmax, ``gamma``) and
    the long form (``pre`` moved by the attention, ``alpha``, the mask, the
    spectral ResBlock), with ``gamma``/``alpha`` non-zero through the carried
    weights; the output and the attention."""
    from reid_gan_tpu.models.dual_gan import base_function as jbf
    from reid_gan_torch.models.dual_gan import base_function as bf

    rng = np.random.RandomState(9)
    x = rng.randn(B, 4, 3, 8)
    if form == "short":
        got, ref = check_module(jbf.AutoAttn(), bf.AutoAttn(8), [x], seed=10)
    else:
        pre, mask = rng.randn(B, 4, 3, 5), (rng.rand(B, 4, 3, 1) < 0.5) * 1.0
        kw = {"pre": pre, "mask": mask}
        v = module_variables(jbf.AutoAttn(), x, seed=10, **kw)
        assert float(abs(v["params"]["gamma"][0])) > 0 and float(abs(v["params"]["alpha"][0])) > 0
        got, ref = check_module(jbf.AutoAttn(), bf.AutoAttn(8, 5), [x], seed=10,
                                jax_kw=kw, pre=nchw(pre), mask=nchw(mask))
    assert got[1].shape == (B, 12, 12)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_ptm_matches_jax(norm):
    """DPTN's ``PTM`` (CABs over ``src``, TTBs on ``tgt`` with key the CABs'
    output and value ``val``, ``decoder_norm``) with batch or instance
    sequence norm."""
    from reid_gan_tpu.models.dual_gan.ptm import PTM as JaxPTM
    from reid_gan_torch.models.dual_gan.ptm import PTM

    rng = np.random.RandomState(11)
    src, tgt, val = (rng.randn(B, 3, 2, 8) for _ in range(3))
    check_module(JaxPTM(8, 2, 2, 2, dim_feedforward=8, norm=norm),
                 PTM(8, 2, 2, 2, dim_feedforward=8, norm=norm), [src, tgt, val], seed=12,
                 atol=1e-9 if norm == "batch" else 1e-6)


def test_seq_instance_norm_matches_jax():
    """``_SeqNorm("instance")``: each sample's channel over its L tokens,
    with its own ``weight``/``bias`` (flax's ``scale``/``bias``)."""
    from reid_gan_tpu.models.dual_gan.ptm import _SeqNorm as JaxSeqNorm
    from reid_gan_torch.models.dual_gan.ptm import _SeqNorm

    x = np.random.RandomState(13).randn(B, 10, 6) * 2 + 0.5
    mod = _SeqNorm(6, "instance")
    assert set(mod.state_dict()) == {"weight", "bias"}
    got, _ = check_module(JaxSeqNorm("instance"), mod, [x], seed=14, atol=1e-6)
    assert got.shape == (B, 10, 6)
