"""Port parity for the modules no entry point reaches: the samplers, the
batch-hard triplet loss, the gradient-matching and contrastive losses, the
feature database and ``extract_cnn_feature``, the pose drawing, the
profiling hooks and the metrics writer, each against its JAX counterpart on
inputs made from a seed with numpy; and the port's module list against the
JAX package's."""

import glob
import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_knn import few_threads  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_module_list_matches_the_jax_package():
    """Every JAX module has its port of the same path, but ``ops/fastconv.py``
    (ROADMAP B: no port needed). ``ops/norm.py``'s counterpart is the
    BatchNorm over the whole mesh batch, ``parallel/`` the data mesh."""
    def modules(pkg):
        root = osp.join(REPO, pkg)
        return {osp.relpath(f, root) for f in glob.glob(osp.join(root, "**", "*.py"),
                                                        recursive=True)}

    left = modules("reid_gan_tpu") - modules("reid_gan_torch")
    assert left == {"ops/fastconv.py"}, sorted(left)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _source(seed, n=120, ids=17, cams=4):
    """(fname, pid, cam) triples with singleton ids, a one-camera id and a
    few outliers (pid −1)."""
    rng = np.random.RandomState(seed)
    pids = rng.randint(0, ids, n)
    pids[:3] = [ids, ids + 1, -1]            # two singletons and an outlier
    cams_ = rng.randint(0, cams, n)
    cams_[pids == 5] = 0                     # an id seen by one camera only
    return [(f"{i}.jpg", int(p), int(c)) for i, (p, c) in enumerate(zip(pids, cams_))]


SAMPLERS = [("RandomIdentitySampler", {"num_instances": 4}),
            ("RandomIdentitySampler", {"num_instances": 9}),
            ("RandomMultipleGallerySampler", {"num_instances": 4}),
            ("RandomMultipleGallerySamplerNoCam", {"num_instances": 4}),
            ("RandomMultipleGallerySamplerNoCam", {"num_instances": 16})]


@pytest.mark.parametrize("name,kw", SAMPLERS,
                         ids=[f"{n}-{kw['num_instances']}" for n, kw in SAMPLERS])
def test_sampler_index_sequences_match_jax(name, kw):
    """Three epochs of the same seed give the same indices and lengths, and
    each of four shards of ``ShardedSampler`` the same share."""
    from reid_gan_tpu.data import sampler as js
    from reid_gan_torch.data import sampler as ts

    src = _source(3)
    ref, got = getattr(js, name)(src, seed=11, **kw), getattr(ts, name)(src, seed=11, **kw)
    assert len(got) == len(ref)
    for _ in range(3):
        assert [int(i) for i in got] == [int(i) for i in ref]
    for shard in range(4):
        a = js.ShardedSampler(getattr(js, name)(src, seed=5, **kw), shard, 4)
        b = ts.ShardedSampler(getattr(ts, name)(src, seed=5, **kw), shard, 4)
        assert len(b) == len(a)
        assert [int(i) for i in b] == [int(i) for i in a]


# ---------------------------------------------------------------------------
# triplet and matching losses
# ---------------------------------------------------------------------------

def _triplet_batch(seed, n=24, d=16, k=6):
    rng = np.random.RandomState(seed)
    f = rng.randn(n, d)
    labels = rng.randint(0, k, n).astype(np.int32)
    labels[: 2 * k] = np.repeat(np.arange(k), 2)
    labels[-1] = k                                   # a singleton anchor
    f[3] = f[2]                                      # a zero distance
    return f, labels


def _grad_pair(jax_fn, torch_fn, *arrays):
    """(value, gradients) of a scalar function of fp64 arrays on both
    sides."""
    with jax.enable_x64(True):
        jv, jg = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(
            *[jnp.asarray(a) for a in arrays])
        jv, jg = float(jv), [np.asarray(g) for g in jg]
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = torch_fn(*ts)
    tg = torch.autograd.grad(tv, ts, allow_unused=True)    # a leaf it skips: 0
    return (float(tv.detach()), [np.zeros_like(a) if g is None else g.numpy()
                                 for a, g in zip(arrays, tg)]), (jv, jg)


def _assert_close(got, ref, tol=1e-10):
    (gv, gg), (rv, rg) = got, ref
    assert abs(gv - rv) <= tol * max(1.0, abs(rv)), (gv, rv)
    for a, b in zip(gg, rg):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.fixture
def jax_triplet_fp64(monkeypatch):
    """The JAX triplet module with its distance product in fp64: JAX's
    ``squared_euclidean`` pins the product's output to float32
    (``preferred_element_type``, distance.py:25-27), so in this process the
    module's name is bound to the same formula without the pin, and jit is
    off so that no trace of the pinned form is reused. The package's files
    do not change."""
    from reid_gan_tpu.ops import triplet as jt

    def squared_euclidean(x, y):
        x2 = jnp.sum(x * x, axis=1, keepdims=True)
        y2 = jnp.sum(y * y, axis=1, keepdims=True)
        return jnp.maximum(x2 + y2.T - 2.0 * jnp.dot(
            x, y.T, precision=jax.lax.Precision.HIGHEST), 0.0)

    monkeypatch.setattr(jt, "squared_euclidean", squared_euclidean)
    with jax.disable_jit():
        yield jt


def test_pairwise_l2_and_mining_match_jax(jax_triplet_fp64):
    """``pairwise_l2`` (zero on the diagonal and on the duplicate row) and
    ``batch_hard_mine``'s distances and flags, fp64, within 1e-10."""
    from reid_gan_torch.ops import triplet as tt

    jt = jax_triplet_fp64
    f, labels = _triplet_batch(0)
    g = np.random.RandomState(1).randn(10, 16)
    with jax.enable_x64(True):
        ref_d = np.asarray(jt.pairwise_l2(jnp.asarray(f), jnp.asarray(g)))
        ref_self = np.asarray(jt.pairwise_l2(jnp.asarray(f), jnp.asarray(f)))
        ref_mine = [np.asarray(t) for t in jt.batch_hard_mine(jnp.asarray(f),
                                                               jnp.asarray(labels))]
    ft, lt = torch.from_numpy(f), torch.from_numpy(labels)
    np.testing.assert_allclose(tt.pairwise_l2(ft, torch.from_numpy(g)).numpy(), ref_d,
                               rtol=0, atol=1e-10)
    got_self = tt.pairwise_l2(ft, ft).numpy()
    np.testing.assert_allclose(got_self, ref_self, rtol=0, atol=1e-10)
    assert got_self[2, 3] == got_self[3, 2] == 0.0 and not np.diag(got_self).any()
    got = [t.numpy() for t in tt.batch_hard_mine(ft, lt)]
    np.testing.assert_allclose(got[0], ref_mine[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[1], ref_mine[1], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got[2], ref_mine[2])
    assert not got[2][-1] and got[2][:-1].all()


@pytest.mark.parametrize("soft,margin", [(False, 1.0), (False, 0.3), (True, 1.0)],
                         ids=["hinge", "hinge_margin_0.3", "soft"])
def test_batch_hard_triplet_loss_and_gradient_match_jax(jax_triplet_fp64, soft, margin):
    """The loss over the valid anchors and its gradient, fp64, within 1e-10;
    a single-identity batch gives 0."""
    from reid_gan_torch.ops import triplet as tt

    jt = jax_triplet_fp64
    f, labels = _triplet_batch(2)
    _assert_close(*_grad_pair(
        lambda x: jt.batch_hard_triplet_loss(x, jnp.asarray(labels), margin, soft),
        lambda x: tt.batch_hard_triplet_loss(x, torch.from_numpy(labels), margin, soft),
        f))
    one_id = torch.zeros(len(labels), dtype=torch.int32)
    assert float(tt.batch_hard_triplet_loss(torch.from_numpy(f), one_id, margin,
                                            soft)) == 0.0


@pytest.mark.parametrize("shape", [(6, 3, 3, 3), (5, 4, 7), (8, 9), (11,)],
                         ids=["4d", "3d", "2d", "1d"])
def test_distance_wb_matches_jax(shape):
    from reid_gan_tpu.ops import losses as jl
    from reid_gan_torch.ops import losses as tl

    rng = np.random.RandomState(len(shape))
    a, b = rng.randn(*shape), rng.randn(*shape)
    if len(shape) == 1:
        assert float(tl.distance_wb(torch.from_numpy(a), torch.from_numpy(b))) == 0.0
        return
    _assert_close(*_grad_pair(jl.distance_wb, tl.distance_wb, a, b))


@pytest.mark.parametrize("metric", ["ours", "mse", "cos"])
def test_match_loss_matches_jax(metric):
    """Two gradient trees (dicts of a conv kernel, a dense matrix and a
    bias), the loss and its gradient with respect to every leaf of both."""
    from reid_gan_tpu.ops import losses as jl
    from reid_gan_torch.ops import losses as tl

    rng = np.random.RandomState(7)
    shapes = {"conv": (4, 3, 3, 2), "dense": (6, 5), "bias": (6,)}
    names = sorted(shapes)
    leaves = [rng.randn(*shapes[k]) for k in names] + [rng.randn(*shapes[k])
                                                       for k in names]

    def tree(vals):
        return dict(zip(names, vals[:3])), dict(zip(names, vals[3:]))

    _assert_close(*_grad_pair(lambda *v: jl.match_loss(*tree(v), dis_metric=metric),
                              lambda *v: tl.match_loss(*tree(v), dis_metric=metric),
                              *leaves))
    with pytest.raises(ValueError, match="unknown distance metric"):
        tl.match_loss(*tree([torch.from_numpy(v) for v in leaves]), dis_metric="l1")


@pytest.mark.parametrize("name,kw", [("contrastive_loss", {}),
                                     ("intra_cl", {"group_size": 4}),
                                     ("cl_loss", {"group_size": 4})])
def test_contrastive_losses_match_jax(name, kw):
    from reid_gan_tpu.ops import losses as jl
    from reid_gan_torch.ops import losses as tl

    rng = np.random.RandomState(8)
    # cl_loss's rows are the first half of its columns' groups
    q, k = rng.randn(8 if name == "cl_loss" else 16, 12), rng.randn(16, 12)
    _assert_close(*_grad_pair(lambda a, b: getattr(jl, name)(a, b, temp=0.07, **kw),
                              lambda a, b: getattr(tl, name)(a, b, temp=0.07, **kw),
                              q, k))


# ---------------------------------------------------------------------------
# feature extraction and the feature database
# ---------------------------------------------------------------------------

def test_feature_database_reads_what_the_jax_class_wrote(tmp_path):
    """A file the JAX ``FeatureDatabase`` wrote (a key overwritten in place,
    one replaced by another shape, one deleted) reads the same through the
    port's, and what the port writes reads back through JAX's."""
    from reid_gan_tpu.engine.feature_extraction import FeatureDatabase as JaxDB
    from reid_gan_torch.engine.feature_extraction import FeatureDatabase

    rng = np.random.RandomState(9)
    feats = {f"img_{i}.jpg": rng.randn(64).astype(np.float32) for i in range(5)}
    path = str(tmp_path / "feats.h5")
    with JaxDB(path, "w") as db:
        for k, v in feats.items():
            db[k] = v
        feats["img_0.jpg"] = rng.randn(64).astype(np.float32)
        db["img_0.jpg"] = feats["img_0.jpg"]
        feats["img_1.jpg"] = rng.randn(8).astype(np.float64)
        db["img_1.jpg"] = feats["img_1.jpg"]
        del db["img_4.jpg"]
        del feats["img_4.jpg"]
    with FeatureDatabase(path, "r") as db:
        assert len(db) == len(feats) and sorted(db) == sorted(feats)
        got = db[sorted(feats)]
        for k, g in zip(sorted(feats), got):
            np.testing.assert_array_equal(g, feats[k])
            assert g.dtype == feats[k].dtype
    with FeatureDatabase(path, "a") as db:
        db["img_2.jpg"] = np.arange(64, dtype=np.float32)
        db["new.jpg"] = np.ones(3)
        db.flush()
    with JaxDB(path, "r") as db:
        np.testing.assert_array_equal(db["img_2.jpg"], np.arange(64, dtype=np.float32))
        np.testing.assert_array_equal(db["new.jpg"], np.ones(3))


@pytest.mark.parametrize("extra", [False, True], ids=["feat", "feat_and_gan"])
def test_extract_cnn_feature_matches_jax(extra):
    """Through the port's ``FeatureExtractor`` (resnet18 at 64x32 on the
    CPU; with ``extra_features`` a pair, of which the first), the same host
    features from both functions, equal to the extractor's own."""
    from reid_gan_tpu.engine.feature_extraction import extract_cnn_feature as jax_extract
    from reid_gan_torch.engine.evaluators import FeatureExtractor
    from reid_gan_torch.engine.feature_extraction import extract_cnn_feature
    from reid_gan_torch.models import create

    torch.manual_seed(0)
    ext = FeatureExtractor(create("resnet18", norm=True), height=64, width=32,
                           device="cpu", extra_features=extra)
    imgs = np.random.RandomState(10).randint(0, 256, (3, 64, 32, 3)).astype(np.uint8)
    got, ref = extract_cnn_feature(ext, imgs), jax_extract(ext, imgs)
    own = ext(imgs)
    assert isinstance(got, np.ndarray) and got.shape == (3, 512)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, own[0] if extra else own)


# ---------------------------------------------------------------------------
# pose drawing
# ---------------------------------------------------------------------------

def test_pose_tables_match_jax():
    from reid_gan_tpu.ops import pose as jp
    from reid_gan_torch.ops import pose as tp

    assert tp.LIMB_SEQ == jp.LIMB_SEQ and tp.COLORS == jp.COLORS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_drawing_matches_jax(seed):
    """Seeded 18-channel maps (a third of the channels empty, one below the
    threshold, peaks on the frame's edges): the coordinates and the drawn
    images and masks equal, with and without the limbs and at two radii."""
    from reid_gan_tpu.data import pose_viz as jv
    from reid_gan_torch.data import pose_viz as tv

    rng = np.random.RandomState(seed)
    m = rng.rand(64, 32, 18).astype(np.float32) * 0.05
    for c in range(18):
        if rng.rand() < 0.66:
            y, x = rng.randint(0, 64), rng.randint(0, 32)
            m[y, x, c] = rng.uniform(0.2, 1.0)
    m[0, 31, 4], m[63, 0, 5], m[10, 10, 6] = 1.0, 1.0, 0.1
    np.testing.assert_array_equal(tv.map_to_cord(m), jv.map_to_cord(m))
    np.testing.assert_array_equal(tv.map_to_cord(m, 0.5), jv.map_to_cord(m, 0.5))
    for kw in ({}, {"radius": 4}, {"draw_joints": False}):
        for a, b in zip(tv.draw_pose_from_map(m, **kw), jv.draw_pose_from_map(m, **kw)):
            np.testing.assert_array_equal(a, b)
    cords = jv.map_to_cord(m)
    for a, b in zip(tv.draw_pose_from_cords(cords, (64, 32)),
                    jv.draw_pose_from_cords(cords, (64, 32))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# profiling and the metrics writer
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """``trace`` writes a Chrome trace holding the ``annotate`` range and
    the operators run in the block; ``enabled=False`` writes nothing."""
    from reid_gan_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with trace(str(tmp_path / "tr")) as prof:
        with annotate("the_matmul_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").iterdir())
    assert [str(f) for f in files] == [prof.trace_path]
    with open(files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "the_matmul_phase" in names and any("mm" in str(n) for n in names)


def test_step_timer_matches_jax(monkeypatch):
    """The same ticks give the same mean step time and throughput."""
    from reid_gan_tpu.utils import profiling as jp
    from reid_gan_torch.utils import profiling as tp

    ticks = [10.0, 10.5, 11.25, 11.5, 12.75]
    results = []
    for mod in (jp, tp):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        timer, idle = mod.StepTimer(items_per_step=256), mod.StepTimer()
        timer.start()
        for _ in ticks[1:]:
            timer.tick()
        results.append((timer.avg, timer.throughput(), idle.throughput()))
    assert results[0] == results[1] and results[1][0] == pytest.approx(0.6875)


@pytest.mark.parametrize("tensorboard", [False, True], ids=["jsonl", "with_tensorboard"])
def test_metrics_writer_lines_match_jax(tmp_path, monkeypatch, tensorboard):
    """The same calls write the same JSONL lines (wall time aside); with
    TensorBoard, each writer keeps its sink if ``torch.utils.tensorboard``
    imports, both alike."""
    from reid_gan_tpu.utils import metrics_writer as jm
    from reid_gan_torch.utils import metrics_writer as tm

    lines = []
    for mod, d in ((jm, tmp_path / "jax"), (tm, tmp_path / "port")):
        monkeypatch.setattr(mod.time, "time", lambda: 123.5)
        w = mod.MetricsWriter(str(d), name="run", use_tensorboard=tensorboard)
        w.log({"loss": np.float32(0.25), "mAP": 0.5}, step=3)
        w.log({"lr": 1e-4})
        w.add_scalar("G", torch.tensor(1.5), 4)
        lines.append(((d / "metrics.jsonl").read_text().splitlines(),
                      w.tb is not None, (d / "tb").exists()))
        w.close()
    assert lines[0] == lines[1]
    assert json.loads(lines[1][0][0]) == {"t": 123.5, "step": 3, "loss": 0.25, "mAP": 0.5}
    if not tensorboard:
        assert lines[1][1:] == (False, False)
