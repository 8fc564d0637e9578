"""Port parity for FD-GAN's kernels and host pieces: the plain versions of
K13 (``render_pose_peaks``: σ 4, 5 and 6, erased channels, missing joints,
joints on the frame's edge, flips) and K14 (``fd_augment``, on the draws of
JAX's keys) against the JAX functions at 1e-6; K3's variants
(``rank_metrics``/``cmc`` in all four flag combinations against JAX's numpy
and JAX backends, ties included, and the sort-free counting form of
``csrc/rank_stats.cu`` for them); the ``single_gallery_shot`` sampler,
``mean_ap`` and ``accuracy``; ``RandomPairSampler`` and the ``pair`` and
``fdgan_pose`` loader items, identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)
from test_torch_port_metrics import _ids_cams

H, W = 64, 32


# --------------------------------------------------------------------------
# JAX draws in the port's parameter layout (shared with the step tests)
# --------------------------------------------------------------------------

def erase_params(ke, kf, fill, n, h, w):
    """The (n, 9) K14 draws of ``random_erasing(ke, ..., p 0.5, sl 0.02, sh
    0.2, r1 0.3, fill)`` then ``random_hflip(kf)``: the rectangle is read off
    the mask that JAX's own function draws on a probe batch, so it holds in
    fp32 and under x64 alike."""
    from reid_gan_tpu.ops.transforms import random_erasing

    probe = random_erasing(ke, jnp.zeros((n, h, w, 3)), p=0.5, sl=0.02, sh=0.2, r1=0.3,
                           fill=jnp.ones((n, 1, 1, 3)))
    mask = np.asarray(probe)[..., 0] > 0.5
    rows, cols = mask.any(axis=2), mask.any(axis=1)
    erase = rows.any(axis=1)
    top = np.where(erase, rows.argmax(axis=1), 0)
    left = np.where(erase, cols.argmax(axis=1), 0)
    flip = np.asarray(jax.random.bernoulli(kf, 0.5, (n,)))
    fill = np.asarray(fill).reshape(n, 3)
    return np.concatenate([np.stack([erase, top, left, rows.sum(1), cols.sum(1), flip], 1),
                           fill], axis=1).astype(fill.dtype)


def siamese_draws(key, n, h, w):
    """The draws of SiameseTrainer's step (engine/fdgan.py:64-66, 37-45):
    split(key) → each half's ``fd_train_augment``: (ke, kf, kc), the fill
    from kc."""
    out = []
    for k in jax.random.split(key):
        ke, kf, kc = jax.random.split(k, 3)
        out.append(erase_params(ke, kf, jax.random.uniform(kc, (n, 1, 1, 3)), n, h, w))
    return out


def fdgan_draws(key, b, h, w, pose_aug, noise_size):
    """An ``FDDraws`` of FDGANModel's step recomputed from its key in JAX's
    split order (model.py:293-306, 210-265): keys = split(key, 8); keys[0] →
    (k_e1, k_e2, k_p1, k_p2, k_n); ``origin_aug`` draws its fill from the
    same key as its erase; the pose draws; the noise; the label-flip
    uniforms from keys[2] and fold_in(keys[2], 1); the smoothing uniforms
    from keys[3..6]."""
    from reid_gan_torch.models.fdgan.model import FDDraws

    keys = jax.random.split(key, 8)
    k_e1, k_e2, k_p1, k_p2, k_n = jax.random.split(keys[0], 5)
    origin = []
    for k in (k_e1, k_e2):
        ke, kf = jax.random.split(k)
        origin.append(erase_params(ke, kf, jax.random.uniform(ke, (b, 1, 1, 3)), b, h, w))
    sigma, erase = np.full(2 * b, 5.0, np.float32), np.full(2 * b, -1, np.int32)
    if pose_aug == "erase":
        erase = np.concatenate([np.asarray(jax.random.randint(k, (b,), 0, 18))
                                for k in (k_p1, k_p2)]).astype(np.int32)
    elif pose_aug == "gauss":
        sigma = np.concatenate([np.asarray(jax.random.randint(k, (b,), 4, 7))
                                for k in (k_p1, k_p2)]).astype(np.float32)
    u = lambda k: float(jax.random.uniform(k, ()))  # noqa: E731
    return FDDraws(
        origin=torch.from_numpy(np.concatenate(origin)),
        sigma=torch.from_numpy(sigma), erase=torch.from_numpy(erase),
        noise=torch.from_numpy(np.array(jax.random.normal(k_n, (b, noise_size)))),
        u_flip=torch.tensor([u(keys[2]), u(jax.random.fold_in(keys[2], 1))],
                            dtype=torch.float64),
        u_smooth=torch.tensor([u(keys[i]) for i in (3, 4, 5, 6)], dtype=torch.float64))


# --------------------------------------------------------------------------
# K13 and K14
# --------------------------------------------------------------------------

def _landmarks(rng, n, h, w):
    lm = np.stack([rng.randint(0, h, (n, 18)), rng.randint(0, w, (n, 18))], -1)
    lm[rng.rand(n, 18) < 0.2] = -1
    lm[0, 0], lm[0, 1], lm[0, 2] = (0, 0), (h - 1, w - 1), (0, w - 1)   # corners
    lm[1, 0], lm[1, 3] = (0, 0), (-1, 5)                  # a corner; y missing only
    return lm.astype(np.float32)


@pytest.mark.parametrize("case", ["sigma_4_5_6", "erase", "plain"])
def test_render_pose_peaks_matches_jax(case):
    """K13's plain version against JAX's ``render_pose_peaks`` vmapped, then
    flipped: the same fp32 arithmetic, within 1e-6 (exp against XLA's exp:
    an ulp or two of values <= 1)."""
    from reid_gan_tpu.ops.pose import render_pose_peaks as jax_render
    from reid_gan_torch.ops.pose import render_pose_peaks

    rng = np.random.RandomState(5)
    n = 6
    lm = _landmarks(rng, n, H, W)
    sigma = np.asarray([4, 5, 6, 4, 5, 6], np.float32) if case == "sigma_4_5_6" \
        else np.full(n, 5.0, np.float32)
    erase = rng.randint(0, 18, n).astype(np.int32) if case == "erase" \
        else np.full(n, -1, np.int32)
    flip = (np.arange(n) % 2).astype(np.int32)
    ref = np.stack([np.asarray(jax_render(lm[i], height=H, width=W, sigma=sigma[i],
                                          erase_index=int(erase[i]))) for i in range(n)])
    ref = np.where(flip[:, None, None, None] != 0, ref[..., ::-1], ref)
    out = render_pose_peaks(*(torch.from_numpy(a) for a in (lm, sigma, erase, flip)), H, W)
    assert out.shape == (n, 18, H, W) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert (out[1, 3] == 0).all() and out[0, 0, 0, 0] == 1.0
    assert out[1, 0, 0, W - 1] == 1.0 or case == "erase"             # flipped corner
    if case == "erase":
        assert all((out[i, erase[i]] == 0).all() for i in range(n))


@pytest.mark.parametrize("fd_fill_key", ["own_key", "erase_key"])
def test_fd_augment_matches_jax(fd_fill_key):
    """K14's plain version on the draws of JAX's keys against JAX's
    ``fd_train_augment`` (the fill from its own key) and against
    ``origin_aug``'s form (the fill from the erase key), in fp32: within
    1e-6."""
    from reid_gan_tpu.engine.fdgan import fd_train_augment
    from reid_gan_tpu.ops.transforms import normalize, random_erasing, random_hflip, to_float
    from reid_gan_torch.ops.transforms import fd_augment

    n = 16
    img = np.random.RandomState(6).randint(0, 256, (n, H, W, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(7)
    if fd_fill_key == "own_key":
        ref = np.asarray(fd_train_augment(key, jnp.asarray(img)))
        ke, kf, kc = jax.random.split(key, 3)
        params = erase_params(ke, kf, jax.random.uniform(kc, (n, 1, 1, 3)), n, H, W)
    else:
        ke, kf = jax.random.split(key)
        fill = jax.random.uniform(ke, (n, 1, 1, 3))
        x = random_erasing(ke, to_float(jnp.asarray(img)), p=0.5, sl=0.02, sh=0.2,
                           r1=0.3, fill=fill)
        ref = np.asarray(normalize(random_hflip(kf, x)[0]))
        params = erase_params(ke, kf, fill, n, H, W)
    assert 0 < params[:, 0].sum() < n and 0 < params[:, 5].sum() < n
    out = fd_augment(torch.from_numpy(img), torch.from_numpy(params))
    assert out.shape == (n, 3, H, W) and out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


def test_fd_augment_draws_cover_the_ranges():
    """The port's own draws: erase and flip near one half each, the
    rectangles inside the frame with area in [0.02, 0.2]·HW up to the
    rounding of the sides, fills in [0, 1)."""
    from reid_gan_torch.ops.transforms import sample_fd_augment_params

    p = sample_fd_augment_params(4000, H, W, torch.Generator().manual_seed(0)).numpy()
    assert abs(p[:, 0].mean() - 0.5) < 0.05 and abs(p[:, 5].mean() - 0.5) < 0.05
    assert (p[:, 1] + p[:, 3] <= H).all() and (p[:, 2] + p[:, 4] <= W).all()
    area = p[:, 3] * p[:, 4] / (H * W)
    assert area.min() > 0.005 and area.max() < 0.3
    assert (p[:, 6:] >= 0).all() and (p[:, 6:] < 1).all()


# --------------------------------------------------------------------------
# K3's variants
# --------------------------------------------------------------------------

def _distmat(rng, m, n, ties):
    if ties:
        return rng.randint(0, 9, (m, n)).astype(np.float32)
    return rng.rand(m, n).astype(np.float32)


@pytest.mark.parametrize("sep", [False, True], ids=["same_cams", "separate_cams"])
@pytest.mark.parametrize("fmb", [False, True], ids=["allshots", "first_match"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "exact_ties"])
def test_rank_metrics_variants_match_jax(sep, fmb, ties):
    """``rank_metrics`` (K3's plain version) against JAX's jitted backend
    (stable sort, as K3's order) with a chunk that leaves a short last one, and,
    without ties, against the numpy backend: CMC and mAP within 1e-6."""
    from reid_gan_tpu.engine.metrics import rank_metrics as jax_rank
    from reid_gan_torch.engine.metrics import rank_metrics

    rng = np.random.RandomState(10 + 2 * sep + fmb + 4 * ties)
    m, n = 37, 83
    d = _distmat(rng, m, n, ties)
    ids = _ids_cams(rng, m, n)
    args = (d, ids[0], ids[1], ids[2], ids[3])
    kw = dict(topk=20, separate_camera_set=sep, first_match_break=fmb)
    cmc, mAP = rank_metrics(*args, chunk=16, device="cpu", **kw)
    for backend in ("jax",) if ties else ("jax", "numpy"):
        ref_cmc, ref_map = jax_rank(*args, backend=backend, **kw)
        np.testing.assert_allclose(cmc, ref_cmc, rtol=0, atol=1e-6, err_msg=backend)
        assert abs(mAP - ref_map) <= 1e-6, backend


def _sort_free_variants(d, qid, qcam, gid, gcam, sep, topk):
    """The counting form of csrc/rank_stats.cu's variants, in numpy: the
    valid set drops the query's camera with ``sep``; each valid match m adds
    1 / |M| to bin #{valid non-matches ranked before it in (d, index)}."""
    q, n = d.shape
    hist = np.zeros((q, topk))
    nm = np.zeros(q, np.int64)
    for i in range(q):
        valid = ((gid != qid[i]) | (gcam != qcam[i])) & ((gcam != qcam[i]) | (not sep))
        vmatch = (gid == qid[i]) & (gcam != qcam[i])
        js = np.nonzero(vmatch)[0]
        nm[i] = len(js)
        for j in js:
            before = (d[i] < d[i, j]) | ((d[i] == d[i, j]) & (np.arange(n) < j))
            b = np.sum(valid & ~vmatch & before)
            if b < topk:
                hist[i, b] += 1.0 / len(js)
    return hist, nm


@pytest.mark.parametrize("sep", [False, True], ids=["same_cams", "separate_cams"])
def test_sort_free_allshots_form_matches_plain_rank_stats(sep):
    """The kernel's all-shots bins and camera mask, counted without a sort,
    equal the plain version's per-query rows on data full of exact ties."""
    from reid_gan_torch.engine.metrics import rank_stats

    rng = np.random.RandomState(11 + sep)
    q, n, topk = 24, 60, 16
    d = rng.randint(0, 6, (q, n)).astype(np.float32)
    qid, gid, qcam, gcam = _ids_cams(rng, q, n, num_ids=4)
    ap, first, nm, hist = rank_stats(torch.from_numpy(d), *(
        torch.from_numpy(a.astype(np.int32)) for a in (qid, qcam, gid, gcam)),
        separate_camera_set=sep, allshots_topk=topk)
    ref_hist, ref_nm = _sort_free_variants(d, qid, qcam, gid, gcam, sep, topk)
    np.testing.assert_array_equal(nm.numpy(), ref_nm)
    np.testing.assert_allclose(hist.numpy(), ref_hist, rtol=0, atol=1e-6)
    assert hist.shape == (q, topk) and (ref_nm > 0).sum() > q // 2


def test_single_gallery_shot_cmc_mean_ap_and_accuracy_match_jax():
    """The cuhk03 sampler (a copy) gives JAX's curve for the same seed,
    exactly; ``mean_ap`` within 1e-6; ``accuracy`` exactly; single gallery
    shot with first-match break raises as in JAX."""
    from reid_gan_tpu.engine import metrics as jm
    from reid_gan_torch.engine import metrics as pm

    rng = np.random.RandomState(12)
    m, n = 29, 71
    d = _distmat(rng, m, n, False)
    ids = _ids_cams(rng, m, n)
    kw = dict(topk=30, separate_camera_set=True, single_gallery_shot=True,
              first_match_break=False, seed=0)
    np.testing.assert_array_equal(pm.cmc(d, *ids, **kw), jm.cmc(d, *ids, **kw))
    assert abs(pm.mean_ap(d, *ids, device="cpu") - jm.mean_ap(d, *ids)) <= 1e-6
    logits = rng.randn(40, 2)
    target = rng.randint(0, 2, 40)
    assert pm.accuracy(logits, target) == jm.accuracy(logits, target)
    assert pm.accuracy(torch.from_numpy(logits), torch.from_numpy(target)) == \
        jm.accuracy(logits, target)
    with pytest.raises(ValueError, match="not a valid CMC protocol"):
        pm.cmc(d, *ids, single_gallery_shot=True, first_match_break=True)


# --------------------------------------------------------------------------
# Sampler and loader
# --------------------------------------------------------------------------

def test_random_pair_sampler_matches_jax():
    from reid_gan_tpu.data.sampler import RandomPairSampler as JaxSampler
    from reid_gan_torch.data.sampler import RandomPairSampler

    rng = np.random.RandomState(13)
    items = [(f"{i}.jpg", int(p), int(c)) for i, (p, c) in
             enumerate(zip(rng.randint(0, 9, 60), rng.randint(0, 3, 60)))]
    items.append(("single.jpg", 99, 0))                # a singleton pid
    for ratio in (1, 2):
        a = list(RandomPairSampler(items, neg_pos_ratio=ratio, seed=4))
        assert a == list(JaxSampler(items, neg_pos_ratio=ratio, seed=4))
        assert len(a) == len(RandomPairSampler(items, neg_pos_ratio=ratio))


def test_pair_and_fdgan_pose_items_match_jax(tmp_path):
    """On the synthetic set: the ``pair`` items and the ``fdgan_pose``
    items (target image, scaled landmarks, flip, in the JAX loader's draw
    order) identical, item by item and through the loader's collate."""
    from reid_gan_tpu.data.datasets import create as jax_create
    from reid_gan_tpu.data.loader import Preprocessor as JaxPre
    from reid_gan_tpu.data.loader import load_landmark_txt as jax_landmarks
    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.loader import DataLoader, Preprocessor, load_landmark_txt
    from reid_gan_torch.data.sampler import RandomPairSampler

    ds = create("synthetic", str(tmp_path), num_ids=4, imgs_per_id=3)
    jds = jax_create("synthetic", str(tmp_path), num_ids=4, imgs_per_id=3)
    train = list(ds.train)
    pairs = list(RandomPairSampler(train, seed=3))[:12]
    for mode in ("pair", "fdgan_pose"):
        kw = dict(mode=mode, height=96, width=48, seed=5, cache=None)
        if mode == "fdgan_pose":
            kw.update(pid_imgs=ds.pid_imgs, pose_root=ds.poses_dir)
            jkw = dict(kw, pid_imgs=jds.pid_imgs, pose_root=jds.poses_dir)
        else:
            jkw = kw
        pre, jpre = Preprocessor(train, **kw), JaxPre(list(jds.train), **jkw)
        for pair in pairs:
            for a, b in zip(pre[pair], jpre[pair]):
                for k, v in a.items():
                    np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]), err_msg=k)
    lm_file = ds.poses_dir + "/" + train[0][0].rsplit("/", 1)[-1][:-4] + ".txt"
    np.testing.assert_array_equal(load_landmark_txt(lm_file, 1.5, 0.75),
                                  jax_landmarks(lm_file, 1.5, 0.75))
    loader = DataLoader(Preprocessor(train, mode="fdgan_pose", height=96, width=48, seed=5,
                                     pid_imgs=ds.pid_imgs, pose_root=ds.poses_dir),
                        sampler=RandomPairSampler(train, seed=3), batch_size=4,
                        num_workers=1)
    b1, b2 = next(iter(loader))
    assert b1["target"].shape == (4, 96, 48, 3) and b2["landmark"].shape == (4, 18, 2)
    assert b1["flip"].dtype == bool
