"""Port parity for the VGG19 perceptual loss (``--use-vgg``): ``VGG19``'s 16
taps and ``VGGLoss``'s content and style terms and input gradient in fp64
against the JAX modules on carried weights; ``load_vgg_params`` on a
torchvision-layout state dict the test saves, against JAX's loader, and
``create_model``'s ``--vgg-weights`` hand-off; and ``cli/train_gan_usl
--use-vgg`` and ``cli/train_gan_warmup --use-vgg`` end to end on the CPU,
with random taps and with ``--vgg-weights``. The steps with ``use_vgg``
against JAX's are in ``test_torch_port_vgg_steps.py``.

VGG runs at 32x16, the smallest size whose ``relu5`` taps are not empty
(four 2x2 pools)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import draw_tree
from test_torch_port_dual_gan_blocks import nchw
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_usl import _FLAGS

B, GH, GW = 2, 32, 16


def jax_vgg_params(seed):
    """A JAX VGG19 ``params`` tree drawn with numpy (fp64)."""
    from reid_gan_tpu.models.dual_gan.external_function import VGG19 as JaxVGG19

    shapes = jax.eval_shape(lambda: JaxVGG19().init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, GH, GW, 3))))
    return draw_tree(shapes, seed)["params"]


def port_vgg_params(params):
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax
    from reid_gan_torch.models.dual_gan.external_function import VGG19

    return state_dict_from_jax(VGG19(), params)


def test_vgg19_taps_and_loss_match_jax():
    """Every one of the 16 taps within 1e-9 of its largest value; content
    and style within 1e-9 relative; the gradient of content + style for
    the first input within 1e-9 of its norm; the VGG weights get none."""
    from reid_gan_tpu.models.dual_gan.external_function import VGG19 as JaxVGG19
    from reid_gan_tpu.models.dual_gan.external_function import VGGLoss as JaxVGGLoss
    from reid_gan_torch.models.dual_gan.external_function import TAPS, VGG19, VGGLoss

    params = jax_vgg_params(1)
    rng = np.random.RandomState(2)
    x, y = np.tanh(rng.randn(B, GH, GW, 3)), np.tanh(rng.randn(B, GH, GW, 3))
    with jax.enable_x64(True):
        ref_taps = JaxVGG19().apply({"params": params}, jnp.asarray(x))
        jloss = JaxVGGLoss(params)

        def total(a):
            c, s = jloss(a, jnp.asarray(y))
            return c + s

        (ref_c, ref_s), ref_g = jloss(jnp.asarray(x), jnp.asarray(y)), jax.grad(total)(
            jnp.asarray(x))
    vgg = VGG19().double()
    vgg.load_state_dict(port_vgg_params(params))
    with torch.no_grad():
        taps = vgg(nchw(x))
    assert list(taps) == TAPS
    for name in TAPS:
        r = np.asarray(ref_taps[name])
        np.testing.assert_allclose(taps[name].numpy().transpose(0, 2, 3, 1), r, rtol=0,
                                   atol=1e-9 * np.abs(r).max(), err_msg=name)
    loss = VGGLoss(port_vgg_params(params))
    xt = nchw(x).requires_grad_(True)
    content, style = loss(xt, nchw(y))
    assert content.dtype == torch.float64
    for got, ref in ((content, ref_c), (style, ref_s)):
        assert abs(got.item() - float(ref)) <= 1e-9 * abs(float(ref))
    (content + style).backward()
    g = xt.grad.numpy().transpose(0, 2, 3, 1)
    assert np.linalg.norm(g - np.asarray(ref_g)) <= 1e-9 * np.linalg.norm(np.asarray(ref_g))
    assert all(p.grad is None and not p.requires_grad for p in loss.parameters())


def test_load_vgg_params_matches_jax(tmp_path, capsys):
    """A torchvision ``vgg19.features`` state dict (OIHW, saved here) read by
    the port's ``load_vgg_params`` gives the convs JAX's loader gives
    (``import_torch_vgg19``'s index map); ``create_model`` with ``use_vgg``
    and ``vgg_weights`` loads it, without the random-taps warning, and
    without the file prints it."""
    from reid_gan_tpu.models.dual_gan.models import load_vgg_params as jax_load
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.external_function import VGG19_CFG
    from reid_gan_torch.models.dual_gan.models import create_model, load_vgg_params

    rng = np.random.RandomState(3)
    sd, idx, cin = {}, 0, 3
    for v in VGG19_CFG:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.from_numpy(rng.randn(v, cin, 3, 3) * 0.1).float()
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.randn(v) * 0.1).float()
        idx, cin = idx + 2, v
    path = str(tmp_path / "vgg19.pth")
    torch.save(sd, path)
    got = load_vgg_params(path)
    ref = port_vgg_params(jax.tree.map(np.asarray, jax_load(path)))
    assert set(got) == set(ref) and len(got) == 32
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert torch.equal(got["conv15.weight"], sd["features.34.weight"])

    kw = dict(gan_height=GH, gan_width=GW, num_feats=32, ngf=8, device="cpu")
    gan = create_model(GANConfig(model="AE", model_gen="Pose", use_vgg=True,
                                 vgg_weights=path), **kw)
    assert gan.vgg.pretrained and "[VGGLoss] WARNING" not in capsys.readouterr().out
    assert torch.equal(gan.vgg.model.conv0.weight, sd["features.0.weight"])
    gan = create_model(GANConfig(model="AE", model_gen="Pose", use_vgg=True), **kw)
    assert not gan.vgg.pretrained and "[VGGLoss] WARNING" in capsys.readouterr().out


@pytest.mark.parametrize("model_gen", ["Pose", "AE"])
def test_use_vgg_leaves_the_global_generator(model_gen):
    """``use_vgg`` draws the random taps from the engine's own ``seed``
    (equal taps for equal seeds, other taps for another) and leaves torch's
    global generator where the engine without VGG leaves it, so the
    encoder a CLI builds after the engine is the same with and without
    ``--use-vgg``."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.models import create_model

    kw = dict(gan_height=GH, gan_width=GW, num_feats=32, ngf=8, device="cpu")
    after, taps = {}, {}
    for use_vgg, seed in ((False, 3), (True, 3), (True, 3), (True, 4)):
        torch.manual_seed(11)
        gan = create_model(GANConfig(model="AE", model_gen=model_gen, use_vgg=use_vgg),
                           seed=seed, **kw)
        after[use_vgg] = torch.rand(8)
        if use_vgg:
            taps.setdefault(seed, []).append(gan.vgg.model.conv3.weight)
    assert torch.equal(after[False], after[True])
    assert torch.equal(*taps[3]) and not torch.equal(taps[3][0], taps[4][0])


def _vgg_file(path):
    """A torchvision-layout ``vgg19.features`` file of a seeded ``VGG19``."""
    from reid_gan_torch.models.dual_gan.external_function import VGG19, _torch_layers

    torch.manual_seed(4)
    vgg = VGG19()
    convs = [i for i, v in enumerate(_torch_layers()) if v == "conv"]
    sd = {}
    for ci, li in enumerate(convs):
        conv = getattr(vgg, f"conv{ci}")
        sd[f"features.{li}.weight"] = conv.weight.detach()
        sd[f"features.{li}.bias"] = conv.bias.detach()
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("weights", [False, True])
def test_vgg_clis_end_to_end(tmp_path, capsys, weights):
    """``cli/train_gan_warmup --use-vgg --debug --device cpu`` (4 D→G
    iterations) and ``cli/train_gan_usl --use-vgg --debug --device cpu``
    (one joint epoch to ``Mean AP``), with random taps (the warning) or
    ``--vgg-weights`` (a torchvision-layout file saved here); the joint
    run's ``train_opt.txt`` is JAX's for the same flags."""
    from reid_gan_torch.cli import train_gan_usl, train_gan_warmup
    from torch_port_opts import assert_options_match_jax

    vgg = ["--use-vgg"] + (["--vgg-weights", _vgg_file(str(tmp_path / "vgg19.pth"))]
                           if weights else [])
    common = ["--dataset", "synthetic", "--data-dir", str(tmp_path), "--batch-size", "16",
              "--gan-height", str(GH), "--gan-width", str(GW), "--device", "cpu",
              "--debug"] + vgg
    state = train_gan_warmup.main(common + [
        "--model", "AE", "--model-gen", "AE", "--logs-dir", str(tmp_path / "w"),
        "--save-dir", str(tmp_path / "ae")])
    out = capsys.readouterr().out
    assert state.step == 4 and "(epoch: 0, iters: 4" in out
    assert ("[VGGLoss] WARNING" in out) != weights
    best = train_gan_usl.main(_FLAGS + common + [
        "--model", "AE", "--model-gen", "Pose", "--eval-step", "1",
        "--logs-dir", str(tmp_path / "j"), "--save-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert 0.0 <= best <= 1.0 and "Mean AP" in out and "(epoch: 0, iters: 8" in out
    assert ("[VGGLoss] WARNING" in out) != weights
    with open(tmp_path / "j" / "train_opt.txt") as fh:
        opts = fh.read()
    assert "gan.use_vgg: True" in opts
    assert_options_match_jax("train_gan_usl", tmp_path / "j" / "train_opt.txt",
                             _FLAGS + common + [
                                 "--model", "AE", "--model-gen", "Pose", "--eval-step", "1",
                                 "--logs-dir", str(tmp_path / "j"),
                                 "--save-dir", str(tmp_path / "ck")])
