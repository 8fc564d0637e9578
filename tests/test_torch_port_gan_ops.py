"""Port parity for the joint step's inputs: the plain versions of kernels K9
(``gan_input_transform``), K10 (``batch_cords_to_map``) and K11 (the
``gan_feat`` map) against the JAX functions, and the loader's ``with_gan``
mode against JAX's loader on the synthetic dataset."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)


def test_gan_input_transform_matches_jax():
    """(N, 16, 8, 3) uint8 → NCHW float32 in [-1, 1] within 1e-6: the port
    divides in IEEE order; XLA's fused program may round a division
    otherwise (1.2e-7 seen)."""
    from reid_gan_tpu.ops.transforms import gan_input_transform as jax_gan_input
    from reid_gan_torch.ops.transforms import gan_input_transform

    img = np.random.RandomState(0).randint(0, 256, (5, 16, 8, 3)).astype(np.uint8)
    img[0, 0, 0] = (0, 255, 128)
    ref = np.asarray(jax_gan_input(jnp.asarray(img), 16, 8))
    out = gan_input_transform(torch.from_numpy(img), 16, 8)
    assert out.shape == (5, 3, 16, 8) and out.dtype == torch.float32
    assert out.is_contiguous()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)
    assert float(out.min()) == -1.0 and float(out.max()) == 1.0


def test_pose_maps_match_jax():
    """18 maps per image at 32x16 from keypoints in an original frame other
    than the GAN frame (128x64 and 256x128): joints missing in y, in x and
    in both, joints on the frame's first and last rows and columns, and one
    image with every joint missing; within 1e-6 (exp rounds by an ulp in
    either library)."""
    from reid_gan_tpu.ops.pose import cords_to_map as jax_cords_to_map
    from reid_gan_torch.ops.pose import batch_cords_to_map, cords_to_map

    rng = np.random.RandomState(1)
    n, k, gh, gw = 4, 18, 32, 16
    old = np.asarray([[128, 64], [256, 128], [128, 64], [256, 128]], np.float32)
    kp = np.stack([rng.uniform(0, old[i, 0], k) for i in range(n)]).astype(np.float32)
    kp = np.stack([kp, np.stack([rng.uniform(0, old[i, 1], k) for i in range(n)])],
                  axis=-1).astype(np.float32)
    kp[0, 0] = (-1, 10)
    kp[0, 1] = (10, -1)
    kp[0, 2] = (-1, -1)
    kp[1, 3] = (0, 0)
    kp[1, 4] = (old[1, 0] - 1, old[1, 1] - 1)
    kp[2, 5] = (old[2, 0] - 0.01, 0)
    kp[3] = -1
    ref = np.asarray(jax.vmap(lambda c, o: jax_cords_to_map(c, o, gh, gw))(
        jnp.asarray(kp), jnp.asarray(old)))
    out = batch_cords_to_map(torch.from_numpy(kp), torch.from_numpy(old), gh, gw)
    assert out.shape == (n, k, gh, gw) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert not out[3].any() and not out[0, :3].any() and out[0, 3].max() == 1.0
    assert float(out[1, 3, 0, 0]) == 1.0 and float(out[1, 4, gh - 1, gw - 1]) == 1.0
    np.testing.assert_array_equal(
        cords_to_map(torch.from_numpy(kp[1]), torch.from_numpy(old[1]), gh, gw).numpy(),
        out[1].numpy())


def test_gan_feat_matches_jax_encoder():
    """The train-mode encoder's ``gan_feat`` (resnet18 at 32x16, the same
    weights, fp64) within 1e-6, NCHW, detached; the plain version on a
    channels_last float32 map gives the NCHW formula's values."""
    from test_torch_port_train import _port_model, _random_variables, _to64

    from reid_gan_tpu.models.resnet import ReIDResNet as JaxReIDResNet
    from reid_gan_torch.models.resnet import gan_feat, gan_feat_plain

    jmodel = JaxReIDResNet(depth=18, norm=True)
    params, stats = _random_variables(jmodel, np.random.RandomState(2))
    x = np.random.RandomState(3).randn(4, 32, 16, 3)
    with jax.enable_x64(True):
        out, _ = jmodel.apply({"params": _to64(params), "batch_stats": _to64(stats)},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        ref = np.asarray(out["gan_feat"])
    model = _port_model(params, stats, torch.float64)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())["gan_feat"]
    assert not got.requires_grad and got.shape == (4, 512, 2, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)

    fmap = torch.randn(3, 20, 4, 2).abs().contiguous(memory_format=torch.channels_last)
    want = fmap / (fmap.pow(2).sum(1, keepdim=True).sqrt() + 1e-12)
    np.testing.assert_allclose(gan_feat(fmap).numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(gan_feat(fmap), gan_feat_plain(fmap))


def _fields(batch):
    return {k: (list(v) if isinstance(v, list) else np.asarray(v)) for k, v in batch.items()}


def test_with_gan_loader_matches_jax(tmp_path):
    """The ``with_gan`` Preprocessor (packed batches and per-item path) and
    ``make_train_loader(mode="with_gan")`` on the synthetic dataset with its
    keypoint CSV: the same fields as JAX's, field for field (images at both
    sizes, ``old_size``, keypoints, labels, the carried flip draws)."""
    from reid_gan_tpu.data.datasets import create as jax_dataset
    from reid_gan_tpu.data.loader import Preprocessor as JaxPreprocessor
    from reid_gan_tpu.engine.usl import make_train_loader as jax_loader
    from reid_gan_torch.data.loader import Preprocessor
    from reid_gan_torch.engine.usl import make_train_loader

    ds = jax_dataset("synthetic", str(tmp_path), num_ids=8, imgs_per_id=4)
    train = list(ds.train)
    kw = dict(mode="with_gan", height=64, width=32, gan_height=32, gan_width=16,
              pose_file=ds.train_pose_dir, flip_all=True, seed=3)
    ref, got = JaxPreprocessor(train, **kw), Preprocessor(train, **kw)
    idx = [5, 0, 9, 9]
    for a, b in ((ref.get_batch(idx), got.get_batch(idx)), (ref[7], got[7])):
        a, b = _fields(a), _fields(b)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (np.asarray(got[7]["keypoints"]) >= 0).any()
    np.testing.assert_array_equal(got[7]["old_size"], (64, 32))

    loaders = [f(train, 64, 32, 8, 4, workers=2, iters=2, seed=4, mode="with_gan",
                 gan_height=32, gan_width=16, pose_file=ds.train_pose_dir)
               for f in (jax_loader, make_train_loader)]
    for _ in range(2):
        a, b = (_fields(lo.next()) for lo in loaders)
        for k in ("img", "Xs", "old_size", "keypoints", "pid", "fname"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for lo in loaders:
        lo.close()
