"""The port's speed scripts (``scripts/torch_{profile_usl_step,
profile_joint_step,profile_augment,project_market_walltime,
bench_loader_scaling}.py``), the JAX scripts' copies on ``reid_gan_torch``:

- each ``main`` at a toy size on the CPU (ResNet-50 at 64x32, batch 8, two
  timed calls; the walltime phases at a few hundred rows), printing its
  table; without ``--device cpu`` each raises here, where there is no card;
- the walltime JSON's keys against the JAX script's ``json.dumps``
  (read with ``ast``, not run) and its projection against the JAX formula;
- ``flops_of`` against XLA's ``cost_analysis`` of the same forward;
- the augmentation's four plain stages against JAX's, the draws carried
  across as ``test_torch_port_augment.py`` carries them, at its tolerances;
- ``bench_loader``'s sources: JPEG needs Pillow and never falls back;
- the scripts import no JAX, nothing of ``reid_gan_tpu`` and not
  ``bench.py``.

One JAX program of a model is compiled here (the FLOP check's forward); the
stage checks run JAX's small jitted stages."""

import ast
import importlib.util
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCRIPTS = ("profile_usl_step", "profile_joint_step", "profile_augment",
           "project_market_walltime", "bench_loader_scaling")
# bench_loader at a toy size: 8 ids x 3 cams x 4 at 32x16, batches of 8
LOADER_TOY = dict(batch=8, iters=2, num_ids=8, imgs_per_id=4, height=64, width=32)


def _script(name):
    """``scripts/torch_<name>.py`` as a module (the walltime script imports
    the loader script by name from its own directory)."""
    if osp.join(ROOT, "scripts") not in sys.path:
        sys.path.insert(0, osp.join(ROOT, "scripts"))
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", osp.join(ROOT, "scripts", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite_positive(*vals):
    return all(np.isfinite(v) and v > 0 for v in vals)


@pytest.fixture
def fresh_cache(monkeypatch):
    """The loader's process-wide decode cache, restored after the test."""
    from reid_gan_torch.data import loader as loader_mod

    monkeypatch.setattr(loader_mod, "_default_cache", None)


# ---------------------------------------------------------------------------
# each main at a toy size
# ---------------------------------------------------------------------------

def test_profile_usl_step_at_toy_size(capsys):
    r = _script("profile_usl_step").main("cpu", batch=8, height=64, width=32, k=64,
                                         instances=4, iters=2, warmup=1, steps=2)
    out = capsys.readouterr().out
    assert "FULL fused step" in out and "imgs/s:" in out
    names = [name for name, _, _ in r["rows"]]
    assert names[0].startswith("aug") and names[3] == "fwd+bwd incl. InfoNCE"
    assert _finite_positive(r["full_ms"], r["full_gflop"], r["img_s"], r["loss"],
                            *[ms for _, ms, _ in r["rows"]])
    gf = {name: g for name, _, g in r["rows"]}
    # forward and backward count about three forwards, the step as much
    assert 2.5 < gf["fwd+bwd incl. InfoNCE"] / gf["encoder fwd eval-mode"] < 3.5
    assert r["full_gflop"] == pytest.approx(gf["fwd+bwd incl. InfoNCE"], rel=0.01)


def test_profile_joint_step_at_toy_size(capsys):
    r = _script("profile_joint_step").main("cpu", batch=8, height=64, width=32,
                                           gan_height=32, gan_width=16, k=64, iters=2,
                                           warmup=1)
    out = capsys.readouterr().out
    assert "full train_all step:" in out and "reid_augment:" in out
    assert list(r["ms"]) == ["encoder fwd (train)", "encoder fwd+bwd", "generator fwd",
                             "generator fwd+bwd", "D fwd+bwd", "loss_G fwd+bwd(D)",
                             "memory loss f+b", "reid_augment"]
    assert set(r["losses"]) == {"loss", "loss_cl", "G", "D"}
    assert _finite_positive(r["full_ms"], r["gflop"], *r["ms"].values(),
                            *r["losses"].values())


def test_profile_augment_at_toy_size(capsys):
    r = _script("profile_augment").main("cpu", n=8, height=64, width=32, iters=2, warmup=1)
    out = capsys.readouterr().out
    assert "random_sized_rect_crop:" in out and "max |mm - s&t|:" in out
    assert len(r["ms"]) == 9 and _finite_positive(*r["ms"].values())
    # the matmul crop resamples the same rectangles with the same linear
    # weights, summed in another order
    assert r["max_abs_mm_vs_crop"] < 1e-4


def test_bench_loader_scaling_at_toy_size(capsys, fresh_cache):
    r = _script("bench_loader_scaling").main("memory", "cpu", workers=(1, 2), **LOADER_TOY)
    out = capsys.readouterr().out
    assert "loader source: memory" in out and "workers=2: streaming" in out
    assert json.loads(out.strip().splitlines()[-1])["source"] == "memory"
    assert _finite_positive(*(v for k in ("cold", "cached", "streaming")
                              for v in r[k].values()))


@pytest.fixture(scope="module")
def walltime():
    """The walltime script's main at a toy size, and what it printed."""
    import contextlib
    import io

    from reid_gan_torch.data import loader as loader_mod

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = _script("project_market_walltime").main(
            "cpu", "memory", n_train=200, n_query=64, n_gallery=136, num_ids=20, batch=16,
            iters=4, epochs=4, eval_every=2, height=64, width=32, k1=8, k2=3, instances=4,
            timed=2, loader_sizes=LOADER_TOY)
    loader_mod._default_cache = None
    return line, buf.getvalue()


def test_project_market_walltime_at_toy_size(walltime):
    line, out = walltime
    assert "4-epoch Market-1501 projection" in out and "streaming: epoch" in out
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert line["loader_ips_used"]["source"] == "memory"
    assert _finite_positive(line["extract_s"], line["train_iter_ms"], line["eval_s"],
                            line["epoch_s_cached"], line["speedup_streaming"])


def test_walltime_json_keys_are_the_jax_scripts(walltime):
    """The JSON line's keys are those of the JAX script's ``json.dumps``
    (project_market_walltime.py:216-229)."""
    tree = ast.parse(open(osp.join(ROOT, "scripts", "project_market_walltime.py")).read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    assert len(dumps) == 1 and isinstance(dumps[0].args[0], ast.Dict)
    jax_keys = {k.value for k in dumps[0].args[0].keys}
    assert len(jax_keys) == 14
    assert set(walltime[0]) == jax_keys
    assert {"cached", "streaming"} <= set(walltime[0]["loader_ips_used"])


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_raise_without_a_card(name):
    """Each ``main`` runs on the card unless it is given ``cpu``."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script(name).main()


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_import_no_jax(name):
    tree = ast.parse(open(osp.join(ROOT, "scripts", f"torch_{name}.py")).read())
    mods = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            mods |= {a.name for a in n.names}
        elif isinstance(n, ast.ImportFrom):
            mods.add(n.module or "")
    assert "reid_gan_torch.device" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                       "reid_gan_tpu", "bench")], mods


# ---------------------------------------------------------------------------
# the projection, the FLOP count
# ---------------------------------------------------------------------------

# (phase seconds, loader rates) → the JAX formula's values
# (project_market_walltime.py:187-208) at Market's sizes (12,936 train
# images, 19,281 eval images, 400 steps of 256, 50 epochs, an eval every 10),
# worked out by hand: t_train = 0.09 x 400 = 36 s, 6 evals
PROJECTIONS = {
    # 20,000 and 5,000 img/s feed faster than the steps take: device-bound
    "device_bound": ((2.0, 1.5, 0.5, 0.09, 3.0, 0.4, 20000.0, 5000.0), {
        "epoch_s_cached": 40.0, "host_bound_cached": False,
        "epoch_s_streaming": 40.5872, "host_bound_streaming": False,
        "epoch1_decode_s": 0.5872, "eval_s": 3.4,
        "total_s_cached": 2020.9872, "total_s_streaming": 2049.76}),
    # 2,000 and 500 img/s do not: the loop waits on the host
    "host_bound": ((2.0, 1.5, 0.5, 0.09, 3.0, 0.4, 2000.0, 500.0), {
        "epoch_s_cached": 59.668, "host_bound_cached": True,
        "epoch_s_streaming": 232.672, "host_bound_streaming": True,
        "epoch1_decode_s": 173.004, "eval_s": 10.0405,
        "total_s_cached": 3216.647, "total_s_streaming": 11693.843}),
}


@pytest.mark.parametrize("case", sorted(PROJECTIONS))
def test_projection_matches_the_jax_formula(case):
    args, want = PROJECTIONS[case]
    got = _script("project_market_walltime").project(*args)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-9, abs=1e-9), key


def test_flops_of_matches_xla_on_the_eval_forward():
    """``flops_of`` of the port's ResNet-50 eval forward at batch 2, 64x32,
    within 1% of XLA's ``cost_analysis`` of JAX's same forward on the same
    weights (about 1.013 against 1.011 GFLOP)."""
    from reid_gan_tpu.models import create as create_jax

    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.utils.profiling import flops_of

    torch.manual_seed(0)
    model = create("resnet50", norm=True).eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 64, 32).astype(np.float32))
    with torch.no_grad():
        got = flops_of(model, x)
    jm = create_jax("resnet50", norm=True)
    fwd = jax.jit(lambda v, xx: jm.apply(v, xx, train=False)["feat"])
    cost = fwd.lower(flax_variables_from_model(model),
                     jnp.asarray(x.permute(0, 2, 3, 1).numpy())).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = cost["flops"] / 1e9
    print(f"eval forward: torch {got:.4f} GFLOP, XLA {xla:.4f} GFLOP")
    assert 0.9 < got < 1.1 and abs(got / xla - 1) < 0.01


# ---------------------------------------------------------------------------
# the augmentation's stages
# ---------------------------------------------------------------------------

def _params(n, **cols):
    """The port's (n, 10) draws with the named columns set."""
    from reid_gan_torch.ops import transforms as T

    p = np.zeros((n, 10), np.float32)
    for name, v in cols.items():
        p[:, getattr(T, name)] = np.asarray(v, np.float32)
    return torch.from_numpy(p)


def _hflip(key, x, n, h, w):
    from reid_gan_tpu.ops.transforms import random_hflip

    out, flip = random_hflip(key, x)
    return out, _params(n, FLIP=flip)


def _crop(key, x, n, h, w):
    """JAX's draws of ``random_sized_rect_crop`` (:96-102)."""
    from reid_gan_tpu.ops.transforms import random_sized_rect_crop

    ka, kb, kc, kd = jax.random.split(key, 4)
    area = h * w * jax.random.uniform(ka, (n,), minval=0.64, maxval=1.0)
    aspect = jax.random.uniform(kb, (n,), minval=2.0, maxval=3.0)
    ch = jnp.clip(jnp.sqrt(area * aspect), 1.0, float(h))
    cw = jnp.clip(jnp.sqrt(area / aspect), 1.0, float(w))
    top = jax.random.uniform(kc, (n,)) * (h - ch)
    left = jax.random.uniform(kd, (n,)) * (w - cw)
    return random_sized_rect_crop(key, x, h, w), _params(
        n, CROP_TOP=top, CROP_LEFT=left, CROP_H=ch, CROP_W=cw)


def _erase(key, x, n, h, w):
    """JAX's draws of ``random_erasing`` (:116-124)."""
    from reid_gan_tpu.ops.transforms import random_erasing

    keys = jax.random.split(key, 5)
    erase = jax.random.bernoulli(keys[0], 0.5, (n,))
    area = h * w * jax.random.uniform(keys[1], (n,), minval=0.02, maxval=0.4)
    aspect = jnp.exp(jax.random.uniform(keys[2], (n,), minval=jnp.log(0.3),
                                        maxval=jnp.log(1.0 / 0.3)))
    eh = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, h)
    ew = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, w)
    top = jnp.floor(jax.random.uniform(keys[3], (n,)) * (h - eh + 1))
    left = jnp.floor(jax.random.uniform(keys[4], (n,)) * (w - ew + 1))
    return random_erasing(key, x), _params(n, ERASE=erase, ERASE_TOP=top, ERASE_LEFT=left,
                                           ERASE_H=eh, ERASE_W=ew)


def _normalize(key, x, n, h, w):
    from reid_gan_tpu.ops.transforms import normalize

    return normalize(x), _params(n)


# stage → (JAX's output and the draws, the port's stage, whether its input
# is normalised, the tolerance: max and mean |Δ|). The crop is JAX's jitted
# stage with its draws inside the program, which may round a rectangle
# otherwise than the same draws made alone: the whole reid_augment's
# tolerance of test_torch_port_augment.py; the others its pieces' 1e-5.
STAGES = {
    "random_hflip": (_hflip, lambda T, x, p, h, w: T.random_hflip(x, p), False, (0.0, 0.0)),
    "random_sized_rect_crop": (_crop, lambda T, x, p, h, w: T.random_sized_rect_crop(
        x, p, h, w), False, (1e-4, 2e-6)),
    "random_erasing": (_erase, lambda T, x, p, h, w: T.random_erasing(x, p), True,
                       (1e-5, 1e-6)),
    "normalize": (_normalize, lambda T, x, p, h, w: T.normalize(x, dim=-1), False,
                  (1e-5, 1e-6)),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_augment_stage_matches_jax(stage):
    """Batch 16 at 64x32 through JAX's stage and the port's with JAX's
    draws, for two keys (images with and without a flip or an erase)."""
    from reid_gan_tpu.ops import transforms as JT

    from reid_gan_torch.ops import transforms as T

    jax_stage, port_stage, normalised, (max_err, mean_err) = STAGES[stage]
    n, h, w = 16, 64, 32
    for seed in (0, 1):
        img = np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)
        x = JT.to_float(jnp.asarray(img))
        if normalised:
            x = JT.normalize(x)
        ref, params = jax_stage(jax.random.PRNGKey(seed), x, n, h, w)
        got = port_stage(T, torch.from_numpy(np.array(x)), params, h, w).numpy()
        err = np.abs(got - np.asarray(ref))
        assert err.max() <= max_err and err.mean() <= mean_err, (err.max(), err.mean())
        if stage in ("random_hflip", "random_erasing"):
            col = T.FLIP if stage == "random_hflip" else T.ERASE
            assert 0 < params[:, col].sum() < n


def test_train_augment_plain_composes_the_stages():
    """The plain K4 is the four stages in reid_augment's order, bit for bit."""
    from reid_gan_torch.ops import transforms as T

    n, h, w = 8, 64, 32
    img = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (n, h, w, 3))
                           .astype(np.uint8))
    p = T.sample_augment_params(n, h, w, torch.Generator().manual_seed(3))
    x = T.random_sized_rect_crop(T.random_hflip(T.to_float(img), p), p, h, w)
    want = T.random_erasing(T.normalize(x, dim=-1), p).permute(0, 3, 1, 2)
    assert torch.equal(T.train_augment_plain(img, p), want)


# ---------------------------------------------------------------------------
# the loader's sources
# ---------------------------------------------------------------------------

def test_bench_loader_needs_pillow_for_jpeg(monkeypatch, fresh_cache):
    """Without Pillow the JPEG source raises; the memory source runs."""
    bench_loader = _script("bench_loader_scaling").bench_loader
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        bench_loader(source="jpeg", **LOADER_TOY)
    assert bench_loader(source="memory", **LOADER_TOY) > 0
    with pytest.raises(ValueError, match="source"):
        bench_loader(source="png", **LOADER_TOY)
