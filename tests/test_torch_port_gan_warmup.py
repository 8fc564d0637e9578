"""Port parity for the GAN warm-up: one fp64 standalone D→G step of the
AE engine against the JAX ``AEModel._step`` (the AE generator at 16x8 with
ngf 8, img_f 32, 3 blocks; the discriminator with ndf 32, img_f 128), the
``only_gan`` loader against JAX's, and the two CLIs of the AE recipe end to
end on the CPU: ``cli/train_gan_warmup --debug`` writes the nets, and
``cli/train_gan_usl --model-gen AE --no-gan-train --continue-train --debug``
trains the hard-mix mode from them."""

import os.path as osp

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_ae_gan import GH, GW, ae_variables, jax_ae_gan
from test_torch_port_gan_ops import _fields
from test_torch_port_joint import _assert_grads, _assert_state, _capture
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_usl import _FLAGS

_AE = ["--model", "AE", "--model-gen", "AE", "--gan-height", "32", "--gan-width", "16"]


def test_standalone_step_matches_jax_step():
    """Two standalone steps from the same weights and batches: the D and G
    losses within 1e-9 relative, D's and G's gradients (``_assert_grads``),
    the parameters after Adam within 1e-10, G's running stats within 1e-6
    relative (fp32 on the JAX side, ROADMAP C; folded once a step) and D's
    spectral u/sigma (three power iterations a step) within 1e-9."""
    from reid_gan_tpu.models.dual_gan.ae_model import AEState
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.dual_gan.convert import state_dict_from_jax

    jgan = jax_ae_gan()
    G, Dv = ae_variables(jgan, 31)
    gan = AEModel(GANConfig(model="AE", model_gen="AE"), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, device="cpu")
    for net, var in ((gan.net_G.double(), G), (gan.net_D.double(), Dv)):
        net.load_state_dict(state_dict_from_jax(net, var["params"], var["batch_stats"]))
    state = gan.init_state()
    with jax.enable_x64(True):
        jgan.tx_G = optax.chain(_capture(), jgan.tx_G)
        jgan.tx_D = optax.chain(_capture(), jgan.tx_D)
        jstate = AEState(G=G, D=Dv, opt_G=jgan.tx_G.init(G["params"]),
                         opt_D=jgan.tx_D.init(Dv["params"]), step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(32)

    def grads(module):
        return {n: p.grad.numpy() for n, p in module.named_parameters()
                if p.grad is not None}

    for i in range(2):
        src = np.tanh(rng.randn(8, GH, GW, 3))
        state, errs, fake = gan.step(state, torch.from_numpy(
            np.ascontiguousarray(src.transpose(0, 3, 1, 2))))
        with jax.enable_x64(True):
            jstate, jerrs, jfake = jgan._step(jstate, {"Xs": jnp.asarray(src)},
                                              jax.random.PRNGKey(i))
        for k in ("G", "D"):
            assert abs(float(errs[k]) - float(jerrs[k])) <= 1e-9 * abs(float(jerrs[k])), k
        np.testing.assert_allclose(fake.numpy().transpose(0, 2, 3, 1), np.asarray(jfake),
                                   rtol=0, atol=1e-9)
        for net, opt, var in ((gan.net_G, jstate.opt_G, jstate.G),
                              (gan.net_D, jstate.opt_D, jstate.D)):
            ref = jax.tree.map(np.asarray, opt[0]["g"])
            _assert_grads(f"step {i} {type(net).__name__}", grads(net),
                          {k: v.numpy() for k, v in
                           state_dict_from_jax(net, ref).items()})
            _assert_state(f"step {i} {type(net).__name__}", net, state_dict_from_jax(
                net, jax.tree.map(np.asarray, var["params"]),
                jax.tree.map(np.asarray, var["batch_stats"])))
    assert state.step == 2
    assert int(gan.net_G.block0.norm1.num_batches_tracked) == 2


def test_only_gan_loader_matches_jax(tmp_path):
    """The ``only_gan`` Preprocessor (packed batches and the per-item path)
    gives JAX's fields (the GAN image, ``old_size``, keypoints, labels,
    ``gan_flip`` False) and the shuffled ``DataLoader`` JAX's batches."""
    from reid_gan_tpu.data.datasets import create as jax_dataset
    from reid_gan_tpu.data.loader import DataLoader as JaxDataLoader
    from reid_gan_tpu.data.loader import Preprocessor as JaxPreprocessor
    from reid_gan_torch.data.loader import DataLoader, Preprocessor

    ds = jax_dataset("synthetic", str(tmp_path), num_ids=8, imgs_per_id=4)
    train = list(ds.train)
    kw = dict(mode="only_gan", gan_height=32, gan_width=16, pose_file=ds.train_pose_dir)
    ref, got = JaxPreprocessor(train, **kw), Preprocessor(train, **kw)
    idx = [5, 0, 9, 9]
    for a, b in ((ref.get_batch(idx), got.get_batch(idx)), (ref[7], got[7])):
        a, b = _fields(a), _fields(b)
        assert set(a) == set(b) and "img" not in b
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.asarray(got.get_batch(idx)["gan_flip"]).any()
    loaders = [cls(pre, batch_size=8, shuffle=True, num_workers=2, drop_last=True, seed=5)
               for cls, pre in ((JaxDataLoader, ref), (DataLoader, got))]
    assert len(loaders[1]) == len(train) // 8
    for a, b in zip(*(list(lo) + list(lo) for lo in loaders)):
        np.testing.assert_array_equal(a["index"], b["index"])
        np.testing.assert_array_equal(a["Xs"], b["Xs"])


def test_warmup_then_hard_mix_cli_end_to_end(tmp_path, capsys):
    """``cli/train_gan_warmup --debug --device cpu``: 1 epoch of 4 D→G
    iterations, its loss line, ``loss_log.txt``, ``train_opt.txt`` and the
    nets' ``latest_net_{G,D}.pth``; then ``cli/train_gan_usl --model-gen AE
    --no-gan-train --continue-train --debug --device cpu`` loads those nets
    and runs a hard-mix epoch to ``Mean AP`` (G frozen: the nets' files stay
    as the warm-up wrote them)."""
    from reid_gan_torch.cli import train_gan_usl, train_gan_warmup

    ckpt = tmp_path / "ckpt"
    common = ["--dataset", "synthetic", "--data-dir", str(tmp_path), "--batch-size", "16",
              "--save-dir", str(ckpt), "--device", "cpu"] + _AE
    state = train_gan_warmup.main(common + ["--debug", "--logs-dir", str(tmp_path / "w")])
    out = capsys.readouterr().out
    assert state.step == 4
    assert "model [AEModel] was created" in out and "(epoch: 0, iters: 4" in out
    nets = ckpt / "experiment"
    for f in ("latest_net_G.pth", "latest_net_D.pth"):
        assert osp.exists(nets / f), f
    for f in ("log.txt", "loss_log.txt", "train_opt.txt"):
        assert osp.exists(tmp_path / "w" / f), f
    with open(tmp_path / "w" / "loss_log.txt") as fh:
        line = fh.read().splitlines()[-1]
    assert "G: " in line and "D: " in line
    saved = torch.load(nets / "latest_net_G.pth", weights_only=True)

    best = train_gan_usl.main(_FLAGS + common[4:] + [
        "--data-dir", str(tmp_path), "--no-gan-train", "--continue-train", "--debug",
        "--eval-step", "1", "--print-freq", "4", "--logs-dir", str(tmp_path / "j")])
    out = capsys.readouterr().out
    assert 0.0 <= best <= 1.0
    assert "latest_net_G.pth" in out and "Clustered into" in out and "Mean AP" in out
    assert "Epoch: [0][8/8]" in out and "Test with the best model" in out
    after = torch.load(nets / "latest_net_G.pth", weights_only=True)
    assert all(torch.equal(v, after[k]) for k, v in saved.items())
    assert not osp.exists(nets / "iter.txt")


@pytest.mark.parametrize("cli,flags,err,match", [
    ("train_gan_usl", ["--model-gen", "AE"], ValueError, "needs --model-gen Pose"),
    ("train_gan_usl", ["--model-gen", "Pose", "--no-gan-train"], ValueError,
     "needs --model-gen AE"),
    ("train_gan_warmup", ["--model-gen", "Pose"], ValueError, "AE generator"),
    ("train_gan_warmup", ["--model-gen", "DEC"], NotImplementedError,
     "ROADMAP A: other generators and DPTN"),
    ("train_gan_warmup", ["--fp16"], NotImplementedError, "ROADMAP A: `--fp16`")])
def test_generator_pairings_and_unported_options_raise(tmp_path, cli, flags, err, match):
    """The joint CLI's modes need their generators; the warm-up trains the
    AE generator; the unported generators and ``--fp16`` raise."""
    import importlib

    main = importlib.import_module(f"reid_gan_torch.cli.{cli}").main
    with pytest.raises(err, match=match):
        main(["--device", "cpu", "--dataset", "synthetic", "--data-dir", str(tmp_path),
              "--logs-dir", str(tmp_path / "logs"), "--gan-height", "32", "--gan-width",
              "16"] + flags)


def test_warmup_refuses_the_cpu_unless_asked(monkeypatch):
    from reid_gan_torch.cli.train_gan_warmup import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--data-dir", "/nonexistent", "--model-gen", "AE"])
