"""Port parity: the InfoNCE memory loss (kernel K6's plain version, forward
and its autograd backward) and the bank fold (kernel K7's plain version) against the JAX package's ``ops/cluster_memory.py``.

fp64 comparisons hold to 1e-12 (the same sums in other orders); fp32 to 1e-6
on unit-norm rows."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _bank(rng, k_pad, d, num_valid, dtype):
    bank = rng.randn(k_pad, d)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank[num_valid:] = 0.0
    return bank.astype(dtype)


def _port_state(bank, num_valid, gan=None):
    from reid_gan_torch.ops.cluster_memory import init_memory

    state = init_memory(bank[:num_valid], k_pad=bank.shape[0],
                        gan_centroids=None if gan is None else gan[:num_valid],
                        device="cpu")
    assert state.features.dtype == torch.from_numpy(bank).dtype
    return state


def _jax_state(bank, num_valid, gan=None):
    from reid_gan_tpu.ops.cluster_memory import init_memory

    return init_memory(bank[:num_valid], k_pad=bank.shape[0],
                       gan_centroids=None if gan is None else gan[:num_valid])


@pytest.mark.parametrize("nv", [8, 256], ids=["partly_live", "all_live"])
def test_memory_loss_and_gradient_match_jax_fp64(nv):
    """B 16, D 512, a bank of 256 rows of which ``nv`` are live, temp 0.05:
    the per-sample loss, the logits (−inf past num_valid) and dL/dx of the
    mean loss against ``jax.value_and_grad``, within 1e-12."""
    from reid_gan_tpu.ops.cluster_memory import memory_loss as jax_loss
    from reid_gan_torch.ops.cluster_memory import memory_loss

    rng = np.random.RandomState(0)
    b, d, k_pad = 16, 512, 256
    x = rng.randn(b, d)
    y = rng.randint(0, nv, b).astype(np.int32)
    bank = _bank(rng, k_pad, d, nv, np.float64)
    with jax.enable_x64(True):
        jstate = _jax_state(bank, nv)

        def f(xx):
            loss, logits = jax_loss(xx, jnp.asarray(y), jstate, temp=0.05)
            return loss.mean(), (loss, logits)

        (_, (ref_loss, ref_logits)), ref_dx = jax.value_and_grad(
            f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss, logits = memory_loss(xt, torch.from_numpy(y), _port_state(bank, nv), temp=0.05)
    loss.mean().backward()
    assert torch.isinf(logits[:, nv:]).all() and (logits[:, nv:] < 0).all()
    np.testing.assert_allclose(logits[:, :nv].detach().numpy(),
                               np.asarray(ref_logits)[:, :nv], rtol=0, atol=1e-12)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_loss),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=0,
                               atol=1e-12)


def test_memory_loss_fp32_matches_jax():
    """fp32, D 2048: loss within 1e-4 (temp 0.05 multiplies each logit's
    rounding by 20) and the gradient within 1e-6."""
    from reid_gan_tpu.ops.cluster_memory import memory_loss as jax_loss
    from reid_gan_torch.ops.cluster_memory import memory_loss

    rng = np.random.RandomState(1)
    b, d, k_pad, nv = 16, 2048, 256, 8
    x = rng.randn(b, d).astype(np.float32)
    y = rng.randint(0, nv, b).astype(np.int32)
    bank = _bank(rng, k_pad, d, nv, np.float32)
    jstate = _jax_state(bank, nv)
    with jax.default_matmul_precision("highest"):
        ref, ref_dx = jax.value_and_grad(
            lambda xx: jax_loss(xx, jnp.asarray(y), jstate)[0].mean())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss, _ = memory_loss(xt, torch.from_numpy(y), _port_state(bank, nv))
    loss.mean().backward()
    assert abs(float(loss.detach().mean()) - float(ref)) <= 1e-4
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=0, atol=1e-6)


def test_memory_loss_extra_negatives_match_jax():
    """The ``ex_f`` negatives with the −10000 group self-mask (plain version,
    fp64): loss and logits within 1e-12."""
    from reid_gan_tpu.ops.cluster_memory import memory_loss as jax_loss
    from reid_gan_torch.ops.cluster_memory import memory_loss

    rng = np.random.RandomState(2)
    b, d, nv = 8, 64, 5
    x, ex = rng.randn(b, d), rng.randn(4, d)
    y = rng.randint(0, nv, b).astype(np.int32)
    bank = _bank(rng, 16, d, nv, np.float64)
    with jax.enable_x64(True):
        ref_loss, ref_logits = jax_loss(jnp.asarray(x), jnp.asarray(y),
                                        _jax_state(bank, nv), ex_f=jnp.asarray(ex),
                                        group_size=2)
    loss, logits = memory_loss(torch.from_numpy(x), torch.from_numpy(y),
                               _port_state(bank, nv), ex_f=torch.from_numpy(ex),
                               group_size=2)
    assert logits.shape == (b, 16 + 4)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=0, atol=1e-12)
    fin = np.isfinite(np.asarray(ref_logits))
    np.testing.assert_array_equal(np.isfinite(logits.numpy()), fin)
    np.testing.assert_allclose(logits.numpy()[fin], np.asarray(ref_logits)[fin],
                               rtol=0, atol=1e-12)


def _fold_case(seed, dtype, b=16, d=64, k_pad=12, nv=9):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d).astype(dtype)
    # 4 labels x 4 slots, out of batch order, one label whose slots are apart
    y = np.array([3, 1, 3, 7, 1, 0, 3, 7, 1, 0, 7, 3, 0, 1, 7, 0], np.int32)[:b]
    return x, y, _bank(rng, k_pad, d, nv, dtype), nv


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
@pytest.mark.parametrize("group_size", [None, 4], ids=["batch_order", "by_depth"])
def test_update_memory_plain_fold_matches_jax(dtype, tol, group_size):
    """Duplicate labels out of order: the port's fold (in place) equals the
    JAX sequential / occurrence fold, and rows of untouched labels stay."""
    from reid_gan_tpu.ops.cluster_memory import update_memory as jax_update
    from reid_gan_torch.ops.cluster_memory import update_memory

    x, y, bank, nv = _fold_case(0, dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = jax_update(_jax_state(bank, nv), jnp.asarray(x), jnp.asarray(y),
                         momentum=0.2, group_size=group_size)
        ref = np.asarray(ref.features)
    state = _port_state(bank, nv)
    before = state.features.clone()
    out = update_memory(state, torch.from_numpy(x), torch.from_numpy(y),
                        momentum=0.2, group_size=group_size)
    assert out.features is state.features          # in place
    np.testing.assert_allclose(state.features.numpy(), ref, rtol=0, atol=tol)
    untouched = np.setdiff1d(np.arange(bank.shape[0]), y)
    assert torch.equal(state.features[untouched], before[untouched])


def test_update_memory_hard_takes_the_first_of_an_exact_tie():
    """CM_Hard: per label, the least-similar slot against the pre-update row
    updates it once; two different rows of x with exactly the same
    similarity tie and the earlier slot wins, as in JAX (fp64, 1e-12)."""
    from reid_gan_tpu.ops.cluster_memory import update_memory as jax_update
    from reid_gan_torch.ops.cluster_memory import update_memory

    x, y, bank, nv = _fold_case(1, np.float64)
    bank[3] = 0.0
    bank[3, 0] = 1.0               # label 3's row is e0, so a similarity is
    x[6] = x[11] = 0.0             # x̂[0]: slots 6 and 11 both give -2/sqrt(5)
    x[6, :2] = (-2.0, 1.0)
    x[11, [0, 2]] = (-2.0, 1.0)
    with jax.enable_x64(True):
        ref = np.asarray(jax_update(_jax_state(bank, nv), jnp.asarray(x),
                                    jnp.asarray(y), use_hard=True).features)
    state = update_memory(_port_state(bank, nv), torch.from_numpy(x),
                          torch.from_numpy(y), use_hard=True)
    np.testing.assert_allclose(state.features.numpy(), ref, rtol=0, atol=1e-12)
    xn = x[6] / np.linalg.norm(x[6])
    row = 0.2 * bank[3] + 0.8 * xn
    np.testing.assert_allclose(state.features.numpy()[3], row / np.linalg.norm(row),
                               rtol=0, atol=1e-12)


def test_update_memory_folds_the_gan_bank():
    """CM_gan: the GAN bank folds the raw ``gan_x`` (no normalisation) with
    the same labels, beside the feature bank (fp64, 1e-12)."""
    from reid_gan_tpu.ops.cluster_memory import update_memory as jax_update
    from reid_gan_torch.ops.cluster_memory import update_memory

    x, y, bank, nv = _fold_case(2, np.float64)
    rng = np.random.RandomState(3)
    gan = _bank(rng, bank.shape[0], bank.shape[1], nv, np.float64)
    gx = rng.randn(*x.shape) * 3.0
    with jax.enable_x64(True):
        ref = jax_update(_jax_state(bank, nv, gan), jnp.asarray(x), jnp.asarray(y),
                         gan_x=jnp.asarray(gx), group_size=4)
    state = update_memory(_port_state(bank, nv, gan), torch.from_numpy(x),
                          torch.from_numpy(y), gan_x=torch.from_numpy(gx),
                          group_size=4)
    np.testing.assert_allclose(state.features.numpy(), np.asarray(ref.features),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(state.gan_features.numpy(),
                               np.asarray(ref.gan_features), rtol=0, atol=1e-12)


def test_memory_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from reid_gan_torch.ops.cluster_memory import init_memory

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_memory(np.eye(2, 4, dtype=np.float32))
