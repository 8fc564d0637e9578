"""The port's CUDA kernels against their plain versions on the card, at the
edges that ``chip_smoke.py`` does not reach: element counts off the vector
width, narrow and odd maps, galleries smaller than a block, queries with no
match, and rows with more matches than K3 stages in one round.

Needs a CUDA card; skips without one. This file imports no JAX, so it runs
on a machine without it, with the JAX test harness left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 3, 3, 3), (2, 5, 7, 3), (4, 16, 8, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_transform_matches_plain(card, shape, dtype):
    """Element counts with a tail past the 4-wide vector loop. fp32: one ulp
    (torch divides by a scalar through its reciprocal); bf16: one bf16 step
    at |x| < 4 for a value on a rounding boundary."""
    from reid_gan_torch.ops.transforms import eval_transform, eval_transform_plain

    g = torch.Generator(device=card).manual_seed(sum(shape))
    u8 = torch.randint(0, 256, shape, dtype=torch.uint8, device=card, generator=g)
    out = eval_transform(u8, shape[1], shape[2], dtype)
    ref = eval_transform_plain(u8, dtype)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.stride() == ref.stride()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_eval_transform_rejects_a_misaligned_batch(card):
    from reid_gan_torch.ops.transforms import eval_transform

    flat = torch.zeros(1 + 2 * 4 * 2 * 3, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="aligned"):
        eval_transform(flat[1:].view(2, 4, 2, 3), 4, 2)


@pytest.mark.parametrize("n,c,h,w,p", [(3, 12, 5, 1, 3.2), (2, 2048, 16, 8, 1.0),
                                       (5, 516, 3, 3, 4.5)])
def test_gem_bn_l2n_matches_plain(card, n, c, h, w, p):
    """Channel counts that leave threads idle or loop twice, a single
    position column, and p = 1 (average pooling): unit vectors within 1e-5
    (powf against torch.pow, and the sum order)."""
    from reid_gan_torch.models.pooling import gem_bn_l2n, gem_bn_l2n_plain

    g = torch.Generator(device=card).manual_seed(c)
    fmap = torch.relu(torch.rand((n, c, h, w), device=card, generator=g) * 2 - 0.3)
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    pp = torch.tensor([p], device=card)
    gamma = torch.rand(c, device=card, generator=g) + 0.5
    mean = torch.rand(c, device=card, generator=g) * 0.2
    var = torch.rand(c, device=card, generator=g) + 0.5
    out = gem_bn_l2n(fmap, pp, gamma, mean, var)
    ref = gem_bn_l2n_plain(fmap, pp, gamma, mean, var)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5


def test_gem_bn_l2n_rejects_an_nchw_map(card):
    from reid_gan_torch.models.pooling import gem_bn_l2n

    fmap = torch.rand((2, 8, 4, 2), device=card)
    one = torch.ones(8, device=card)
    with pytest.raises(ValueError, match="channels_last"):
        gem_bn_l2n(fmap, torch.tensor([3.0], device=card), one, one * 0, one)


def _rank_case(card, q, n, num_ids, ties, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    d = torch.randint(0, 6 if ties else 1 << 20, (q, n), device=card,
                      generator=g).float()
    qid = torch.randint(0, num_ids, (q,), device=card, generator=g, dtype=torch.int32)
    gid = torch.randint(0, num_ids, (n,), device=card, generator=g, dtype=torch.int32)
    qcam = torch.randint(0, 3, (q,), device=card, generator=g, dtype=torch.int32)
    gcam = torch.randint(0, 3, (n,), device=card, generator=g, dtype=torch.int32)
    qid[0] = torch.iinfo(torch.int32).min        # a padded query: no match
    return d, qid, qcam, gid, gcam


@pytest.mark.parametrize("q,n,num_ids,ties,rounds", [
    (5, 7, 2, True, False),        # gallery narrower than a warp
    (9, 1000, 10, True, False),    # many exact ties in every row
    (6, 4000, 2, False, True),     # ~1,300 matches a row: two staging rounds
    (4, 6000, 2, True, True),      # ~2,000, with ties across the rounds
])
def test_rank_stats_matches_plain(card, q, n, num_ids, ties, rounds):
    """Match counts and first-match bins exactly; AP within 1e-6 (the plain
    pass sums its precision terms in fp32, the kernel in double)."""
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain

    args = _rank_case(card, q, n, num_ids, ties, seed=q * n)
    ap, first, nm = rank_stats(*args)
    ap_r, first_r, nm_r = rank_stats_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nm, nm_r) and torch.equal(first, first_r)
    assert nm[0] == 0 and ap[0] == 0
    if rounds:
        assert int(nm[1:].min()) > 1024    # more than one staging round
    assert float((ap - ap_r).abs().max()) <= 1e-6
