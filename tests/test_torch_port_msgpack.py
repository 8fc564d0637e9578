"""Port parity for flax msgpack checkpoints: the port's pure-Python reader
against ``flax.serialization.msgpack_restore`` on files the JAX package's
``save_checkpoint`` writes (bf16, int and numpy-scalar leaves, chunked
leaves), flax reading the port writer's bytes, the inverse converters
(state dict → flax tree) against the JAX init's key set and shapes, the
strict whole-checkpoint resume, the per-net loader, ``copy_state_dict``, and
the port's imports in a fresh interpreter."""

import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))}


def _bits(a):
    """(dtype name, shape, raw bytes) of a leaf: a torch bfloat16 tensor
    (the port's bf16 leaves) is named as numpy names ml_dtypes' bfloat16."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return "bfloat16", tuple(a.shape), a.contiguous().view(torch.int16).numpy().tobytes()
    if isinstance(a, (int, float, bool, str, complex)) or a is None:
        return type(a).__name__, (), repr(a)
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _mixed_tree(rng):
    return {"params": {"conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
                       "half": jnp.asarray(rng.randn(5, 3), jnp.bfloat16),
                       "ids": np.arange(7, dtype=np.int32)},
            "batch_stats": {"bn": {"mean": rng.rand(8).astype(np.float32)}},
            "epoch": 3, "best_mAP": 0.625, "scale": np.float32(1.5),
            "count": np.int64(-12), "flag": True, "none": None, "empty": {}}


def _assert_same(got, ref):
    gl, rl = _leaves(got), _leaves(ref)
    assert sorted(gl) == sorted(rl)
    for k in rl:
        assert _bits(gl[k]) == _bits(rl[k]), k


def test_reader_matches_flax_on_a_jax_checkpoint(tmp_path):
    """The JAX ``save_checkpoint`` (ints, floats and an np.float32 scalar
    become 0-d arrays, a bf16 array an extension-1 leaf named b'bfloat16'),
    and flax's own ``msgpack_serialize`` of numpy scalars (extension 3) and
    a complex (extension 2): every leaf's dtype, shape and bits as flax's
    ``msgpack_restore`` gives them; the arrays are views of the file."""
    from flax import serialization as flax_ser
    from reid_gan_tpu.utils.serialization import save_checkpoint as jax_save
    from reid_gan_torch.utils.serialization import load_msgpack_checkpoint, msgpack_restore

    path = str(tmp_path / "checkpoint.msgpack")
    jax_save(_mixed_tree(np.random.RandomState(0)), True, path)
    data = open(path, "rb").read()
    ref = flax_ser.msgpack_restore(data)
    got = load_msgpack_checkpoint(path)
    _assert_same(got, ref)
    assert got["scale"].shape == () and got["scale"].dtype == np.float32
    assert got["params"]["half"].dtype == torch.bfloat16
    assert int(got["epoch"]) == 3 and float(got["best_mAP"]) == 0.625
    _assert_same(load_msgpack_checkpoint(str(tmp_path / "model_best.msgpack")), ref)
    view = msgpack_restore(data)["params"]["conv"]["kernel"]
    assert not view.flags.owndata

    raw = flax_ser.msgpack_serialize({"s": np.float32(1.5), "i": np.int64(-7), "c": 1 + 2j,
                                      "h": jnp.asarray([1.5, -2.0], jnp.bfloat16)})
    got = msgpack_restore(raw)
    _assert_same(got, flax_ser.msgpack_restore(raw))
    assert isinstance(got["s"], np.float32) and got["s"] == np.float32(1.5)
    assert isinstance(got["i"], np.int64) and got["c"] == 1 + 2j


def test_reader_joins_chunked_leaves(tmp_path, monkeypatch):
    """A leaf over flax's ``MAX_CHUNK_SIZE`` (made 64 bytes here) is written
    as ``__msgpack_chunked_array__`` chunks; the port joins them, f32 and
    bf16, to the leaves flax restores."""
    import flax.serialization
    from reid_gan_tpu.utils.serialization import save_checkpoint as jax_save
    from reid_gan_torch.utils.serialization import load_msgpack_checkpoint

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"w": rng.randn(10, 7).astype(np.float32),
            "h": jnp.asarray(rng.randn(50), jnp.bfloat16), "small": np.ones(3, np.float32)}
    path = str(tmp_path / "chunked.msgpack")
    jax_save(tree, False, path)
    raw = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    _assert_same(load_msgpack_checkpoint(path), flax.serialization.msgpack_restore(raw))


def test_flax_reads_the_port_writer(tmp_path, monkeypatch):
    """The port's ``save_msgpack_checkpoint``: flax restores the same tree
    (chunked leaves too, the port's ``MAX_CHUNK_SIZE`` made 64 bytes), the
    bytes equal flax's own serialisation of the restored tree, and
    ``model_best.msgpack`` is the same file."""
    from flax import serialization as flax_ser
    from reid_gan_torch.utils import serialization as ser

    tree = ser.msgpack_restore(flax_ser.msgpack_serialize(_mixed_tree(np.random.RandomState(2))))
    tree.update(name="resnet", ids=[1, -300, 70000, 2 ** 40], z=3 + 4j)
    path = str(tmp_path / "port.msgpack")
    ser.save_msgpack_checkpoint(tree, True, path)
    raw = open(path, "rb").read()
    back = flax_ser.msgpack_restore(raw)
    _assert_same(ser.msgpack_restore(raw), back)
    assert raw == flax_ser.msgpack_serialize(back)
    assert raw == open(str(tmp_path / "model_best.msgpack"), "rb").read()

    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    big = {"w": np.arange(70, dtype=np.float32), "h": torch.arange(40).to(torch.bfloat16)}
    ser.save_msgpack_checkpoint(big, False, path)
    raw = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    _assert_same(ser.load_msgpack_checkpoint(path), flax_ser.msgpack_restore(raw))


def _jax_shapes(jmodel, h=64, w=32):
    v = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3)),
                                           train=True))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _jax_siamese_shapes():
    from reid_gan_tpu.models.multi_branch import siamese_baseline

    m = siamese_baseline(depth=18)
    x = jnp.zeros((2, 64, 32, 3))
    v = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x, x, train=True))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _jax_gan_shapes(gen):
    from test_torch_port_gan_nets import GH, GW, REID
    from reid_gan_tpu.config import GANConfig
    from reid_gan_tpu.models.dual_gan.ae_model import AEModel

    gan = AEModel(GANConfig(model="AE", model_gen=gen), gan_height=GH, gan_width=GW,
                  num_feats=32, ngf=8, num_blocks=1, reid_feat_dim=REID)
    s = jax.eval_shape(gan.init_state, jax.random.PRNGKey(0))
    return s.G, s.D


def _port_gan(gen):
    from test_torch_port_gan_nets import REID
    from reid_gan_torch.models.dual_gan.networks import define_D, define_G

    return define_G(gen, pose_nc=18, ngf=8, img_f=32, reid_nc=REID, num_blocks=1), define_D()


def _cases():
    from reid_gan_tpu.models import create as jcreate
    from reid_gan_torch.models import create

    def enc(arch):
        return lambda: (create(arch), _jax_shapes(jcreate(arch)))

    def siamese():
        from reid_gan_torch.models.multi_branch import siamese_baseline

        return siamese_baseline(depth=18), _jax_siamese_shapes()

    def gan(gen, which):
        def make():
            g, d = _port_gan(gen)
            G, D = _jax_gan_shapes(gen)
            return (g, G) if which == "G" else (d, D)
        return make

    def dptn():
        from reid_gan_tpu.config import GANConfig as JaxGANConfig
        from reid_gan_tpu.models.dual_gan.dptn_model import DPTNModel as JaxDPTNModel
        from reid_gan_torch.config import GANConfig
        from reid_gan_torch.models.dual_gan.dptn_model import DPTNModel

        kw = dict(gan_height=16, gan_width=8, num_feats=32, ngf=8, num_blocks=2)
        s = jax.eval_shape(JaxDPTNModel(JaxGANConfig(model="DPTN"), **kw).init_state,
                           jax.random.PRNGKey(0))
        return DPTNModel(GANConfig(model="DPTN"), device="cpu", **kw).net_G, s.G

    return {"resnet18": enc("resnet18"), "resnet_ibn50a": enc("resnet_ibn50a"),
            "resnet_bip50": enc("resnet_bip50"), "resnet_bipd50": enc("resnet_bipd50"),
            "resnet_mp50": enc("resnet_mp50"), "siamese18": siamese,
            "pose_G": gan("Pose", "G"), "ae_G": gan("AE", "G"), "res_D": gan("AE", "D"),
            "dptn_G": dptn}


@pytest.mark.parametrize("name", ["resnet18", "resnet_ibn50a", "resnet_bip50",
                                  "resnet_bipd50", "resnet_mp50", "siamese18",
                                  "pose_G", "ae_G", "res_D", "dptn_G"])
def test_inverse_converters_round_trip_with_the_jax_layout(name):
    """``flax_variables_from_model`` gives the JAX init's key set and leaf
    shapes, and ``state_dict_from_flax`` of it is the model's state dict,
    bit for bit (inverse ∘ forward = identity), with random BatchNorm stats
    and spectral ``u``/``sigma``; the DPTN generator's attention kernels
    take flax's (d_model, heads, head_dim) and (heads, head_dim, d_model)
    shapes."""
    from reid_gan_torch.models.convert import flax_variables_from_model, state_dict_from_flax

    torch.manual_seed(3)
    model, ref = _cases()[name]()
    with torch.no_grad():
        for k, b in model.named_buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5)
    tree = flax_variables_from_model(model)
    ref_shapes = {k: tuple(v.shape) for k, v in _leaves(ref).items()}
    assert {k: tuple(np.shape(v)) for k, v in _leaves(tree).items()} == ref_shapes
    sd = state_dict_from_flax(model, tree)
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k


def test_whole_checkpoint_resume_is_strict(tmp_path):
    """``resume_checkpoint`` of a msgpack file loads the weights and returns
    the epoch and best mAP; a missing key or a mis-shaped leaf raises
    ``ValueError`` naming it, as flax's ``from_state_dict`` refuses a
    target it cannot fill."""
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.utils.serialization import resume_checkpoint, save_msgpack_checkpoint

    torch.manual_seed(0)
    src = create("resnet18")
    tree = dict(flax_variables_from_model(src), epoch=np.asarray(4), best_mAP=np.asarray(0.5))
    path = str(tmp_path / "ok.msgpack")
    save_msgpack_checkpoint(tree, False, path)
    dst = create("resnet18")
    assert resume_checkpoint(path, dst) == (4, 0.5)
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k

    del tree["params"]["base"]["layer1_0"]["conv2"]
    save_msgpack_checkpoint(tree, False, path)
    with pytest.raises(ValueError, match="conv2"):
        resume_checkpoint(path, create("resnet18"))
    tree = flax_variables_from_model(src)
    tree["batch_stats"]["base"]["bn1"]["mean"] = np.zeros(65, np.float32)
    save_msgpack_checkpoint(tree, False, path)
    with pytest.raises(ValueError, match="mis-shaped.*bn1.running_mean"):
        resume_checkpoint(path, create("resnet18"))


def test_load_networks_reads_msgpack_and_refuses_two_files(tmp_path, capsys):
    """Per-net files: a JAX ``save_networks`` ``.msgpack`` loads into the
    port's net (the converted tree, bit for bit); a missing file keeps the
    init; a ``.pth`` beside a ``.msgpack`` of the same net raises, naming
    both."""
    from reid_gan_tpu.utils.serialization import save_networks as jax_save_networks
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.utils.serialization import load_networks, save_networks

    torch.manual_seed(1)
    g, d = _port_gan("Pose")
    jax_save_networks({"G": flax_variables_from_model(g), "D": flax_variables_from_model(d)},
                      str(tmp_path), "latest")
    torch.manual_seed(2)
    g2, d2 = _port_gan("Pose")
    other = torch.nn.Linear(2, 2)
    load_networks({"G": g2, "D": d2, "X": other}, str(tmp_path), "latest")
    assert "no checkpoint for net 'X'" in capsys.readouterr().out
    for a, b in ((g, g2), (d, d2)):
        for k, v in a.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, b.state_dict()[k]), k
    save_networks({"G": g}, str(tmp_path), "latest")
    with pytest.raises(ValueError, match=r"latest_net_G\.pth.*latest_net_G\.msgpack"):
        load_networks({"G": g2}, str(tmp_path), "latest")


def test_copy_state_dict_skips_missing_and_misshaped_keys(capsys):
    """``copy_state_dict`` copies the keys the model has at the same shape
    (after stripping ``module.``) and skips the rest, printing both counts
    (serialization.py:63-91)."""
    from reid_gan_torch.utils.serialization import copy_state_dict

    net = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    before = net[1].weight.detach().clone()
    sd = {"module.0.weight": torch.ones(2, 3), "module.0.bias": torch.full((2,), 2.0),
          "module.1.weight": torch.ones(5, 5), "module.9.bias": torch.zeros(1)}
    copy_state_dict(sd, net, strip="module.")
    out = capsys.readouterr().out
    assert "skipped 2 keys" in out and "copied 2 tensors" in out
    assert torch.equal(net[0].weight, torch.ones(2, 3))
    assert torch.equal(net[0].bias, torch.full((2,), 2.0))
    assert torch.equal(net[1].weight, before)


def test_port_and_smoke_import_no_jax_flax_or_msgpack():
    """A fresh interpreter imports every module of ``reid_gan_torch`` and
    ``chip_smoke``: none of ``jax``, ``flax``, ``msgpack`` or
    ``reid_gan_tpu`` is loaded (the card has no flax and may have no
    msgpack)."""
    code = """
import importlib, os, pkgutil, sys
sys.path.insert(0, {repo!r})
import reid_gan_torch
names = [m.name for m in pkgutil.walk_packages(reid_gan_torch.__path__, "reid_gan_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "reid_gan_tpu"))
print(len(names), bad)
assert not bad, bad
""".format(repo=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={"PATH": "/usr/bin:/bin", "HOME": REPO,
                                        "PYTHONNOUSERSITE": "1"}, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 50
