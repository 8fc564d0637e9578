"""The port's CUDA kernels against their plain versions on the card, at the
edges that ``chip_smoke.py`` does not reach: element counts off the vector
width, narrow and odd maps, galleries smaller than a block, queries with no
match, rows with more matches than K3 stages in one round; crops and erase
rectangles at the borders (K4); p other than 3, maps of zeros and odd
sizes (K5); one live bank row, a full bank and banks off the column tile,
and extra negatives (``ex_f``) of 1, 16 and 33 rows in groups of 1 and of
the whole batch, against banks of 768 and 30,720 rows (K6); one label for the whole batch, all labels distinct and exact ties in
the hard fold (K7); sets smaller than a tile, D off the stage and off the
vector width, k of 1, 64, 65, 128, 256 and 300 (the register lists and the
lists in scratch), exact ties and the inner product (K8); odd
batches and frames (K9, K10), missing joints and joints on the frame's
corners (K10), channel counts off the warp stride and the vector width
(K11), odd batches, frames and the rows next to the edge, whose taps are
renormalised (K12); the all-shots rows and the separate camera set (K3);
every σ, erased channels, missing and corner joints and flips on odd
frames (K13); erase rectangles at the borders with flips, one image and
odd frames (K14); and the raise on inputs a kernel does not take.

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


@pytest.mark.parametrize("sep", [False, True], ids=["same_cams", "separate_cams"])
@pytest.mark.parametrize("q,n,num_ids,ties,topk", [
    (5, 7, 2, True, 4),            # gallery narrower than a warp, bins past topk
    (9, 1000, 10, True, 100),      # many exact ties in every row
    (4, 6000, 2, True, 100),       # two staging rounds, ties across them
])
def test_rank_stats_variants_match_plain(card, sep, q, n, num_ids, ties, topk):
    """K3's all-shots rows and separate camera set: match counts and first
    bins exactly, AP within 1e-6, each query's (topk,) all-shots row within
    1e-6 (sums of 1 / |M|)."""
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain

    args = _rank_case(card, q, n, num_ids, ties, seed=q * n + sep)
    ap, first, nm, hist = rank_stats(*args, separate_camera_set=sep, allshots_topk=topk)
    ap_r, first_r, nm_r, hist_r = rank_stats_plain(*args, separate_camera_set=sep,
                                                   allshots_topk=topk)
    torch.cuda.synchronize()
    assert torch.equal(nm, nm_r) and torch.equal(first, first_r)
    assert nm[0] == 0 and not hist[0].any()
    assert float((ap - ap_r).abs().max()) <= 1e-6
    assert hist.shape == (q, topk) and float((hist - hist_r).abs().max()) <= 1e-6
    assert float(hist[nm > 0].sum(dim=1).max()) <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# K4 train_augment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(8, 32, 16), (3, 7, 5), (5, 256, 128)])
def test_train_augment_matches_plain(card, n, h, w):
    """Random draws plus crops flush with the borders, the whole image, a
    one-pixel erase and a whole-image erase: within 1e-5 (the same fp32
    arithmetic; the fill mean sums in another order)."""
    from reid_gan_torch.ops.transforms import (
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    g = torch.Generator(device=card).manual_seed(n * h)
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=card, generator=g)
    p = sample_augment_params(n, h, w, g)
    p[0, 1:5] = torch.tensor([0.0, 0.0, h * 0.7, w * 0.6])            # top-left
    p[1, 1:5] = torch.tensor([h * 0.3, w * 0.4, h * 0.7, w * 0.6])    # bottom-right
    p[2, 1:5] = torch.tensor([0.0, 0.0, float(h), float(w)])          # whole
    p[0, 5:] = torch.tensor([1.0, h - 1.0, w - 1.0, 1.0, 1.0])        # one pixel
    p[2, 5:] = torch.tensor([1.0, 0.0, 0.0, float(h), float(w)])      # whole image
    out = train_augment(u8, p, h, w)
    ref = train_augment_plain(u8, p)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.stride() == ref.stride()
    assert float((out - ref).abs().max()) <= 1e-5


def test_train_augment_rejects_bad_inputs(card):
    from reid_gan_torch.ops.transforms import train_augment

    u8 = torch.zeros((2, 8, 4, 3), dtype=torch.uint8, device=card)
    p = torch.zeros((2, 10), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        train_augment(u8.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), p, 8, 4)
    with pytest.raises(ValueError, match="float32"):
        train_augment(u8, p.double(), 8, 4)


# ---------------------------------------------------------------------------
# K5 gem_pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,h,w,p,zeros", [
    (4, 2048, 16, 8, 3.0, False),
    (3, 12, 3, 5, 2.5, False),       # odd map, C off the 512-channel block
    (2, 516, 7, 1, 4.0, False),      # one column, a second channel block
    (2, 64, 4, 4, 3.0, True),        # all zeros: every value clamps to eps
])
def test_gem_pool_forward_backward_match_plain(card, n, c, h, w, p, zeros):
    """Forward, d map and dp against the plain version's autograd in fp64 on
    the same fp32 inputs: pooled and d map within 1e-5 relative (powf and
    the sum order), dp within 1e-4 relative (a sum of N*C differences of
    terms of the size of ln eps, in double in the kernel)."""
    from reid_gan_torch.models.pooling import gem_pool, gem_pool_plain

    gen = torch.Generator(device=card).manual_seed(c + h)
    fmap = torch.relu(torch.rand((n, c, h, w), device=card, generator=gen) * 2 - 0.6)
    if zeros:
        fmap.zero_()
    fmap = fmap.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    pp = torch.tensor([p], device=card, requires_grad=True)
    gout = torch.randn((n, c), device=card, generator=gen)
    out = gem_pool(fmap, pp)
    out.backward(gout)
    f64 = fmap.detach().double().requires_grad_(True)
    p64 = pp.detach().double().requires_grad_(True)
    ref = gem_pool_plain(f64, p64)
    ref.backward(gout.double())
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.detach().double() - b.detach()).abs().max()
                     / b.detach().abs().max().clamp_min(1e-30))

    assert rel(out, ref) <= 1e-5
    if zeros:
        assert float(fmap.grad.abs().max()) == 0.0
        assert abs(float(pp.grad) - float(p64.grad)) <= 1e-9
    else:
        assert rel(fmap.grad, f64.grad) <= 1e-5
        assert abs(float(pp.grad) - float(p64.grad)) <= 1e-4 * abs(float(p64.grad))
    assert fmap.grad.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# K6 infonce (memory_loss)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d,k_pad,nv", [
    (256, 2048, 768, 1),       # one live row
    (256, 2048, 768, 768),     # a full bank
    (20, 64, 100, 37),         # batch and bank off the tiles
    (33, 512, 64, 64),         # one column tile, a batch one past a row tile
])
def test_memory_loss_matches_plain(card, b, d, k_pad, nv):
    """Loss, logits (−inf past num_valid) and dL/dx of the mean loss against
    the plain version's autograd in fp64 on the same fp32 inputs: logits
    within 1e-4 (temp 0.05 multiplies the product's fp32 rounding by 20),
    loss within 1e-4, gradient within 1e-6."""
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        memory_loss,
        memory_loss_plain,
    )

    g = torch.Generator(device=card).manual_seed(b + k_pad + nv)
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device=card, generator=g), dim=1)
    state = init_memory(centers, k_pad=k_pad, device=card)
    y = torch.randint(0, nv, (b,), device=card, generator=g, dtype=torch.int32)
    x = (centers[y.long()] + 0.5 * torch.randn((b, d), device=card, generator=g))
    x = x.contiguous().requires_grad_(True)
    loss, logits = memory_loss(x, y, state)
    loss.mean().backward()
    x64 = x.detach().double().requires_grad_(True)
    s64 = state._replace(features=state.features.double())
    ref, ref_logits = memory_loss_plain(x64, y, s64)
    ref.mean().backward()
    torch.cuda.synchronize()
    assert torch.isneginf(logits[:, nv:]).all()
    assert float((logits[:, :nv].double() - ref_logits[:, :nv]).abs().max()) <= 1e-4
    assert float((loss.double() - ref).abs().max()) <= 1e-4
    assert float((x.grad.double() - x64.grad).abs().max()) <= 1e-6


def test_memory_loss_rejects_bad_inputs(card):
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss

    state = init_memory(torch.eye(4, 8, device=card), k_pad=8, device=card)
    y = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32"):
        memory_loss(torch.ones((2, 8), device=card, dtype=torch.float64), y, state)
    with pytest.raises(ValueError, match="D % 4"):
        memory_loss(torch.ones((2, 10), device=card)[:, :6], y, state)
    with pytest.raises(ValueError, match="ex_f"):
        memory_loss(torch.ones((2, 8), device=card), y, state,
                    ex_f=torch.ones((2, 4), device=card))


@pytest.mark.parametrize("b,d,k_pad,nv,t,group", [
    (256, 2048, 768, 700, 16, 16),        # the hard-mix step's shapes
    (16, 64, 100, 37, 1, 16),             # one extra column, one group of the batch
    (16, 64, 100, 37, 16, 1),             # a group per row
    (33, 512, 64, 64, 33, 1),             # T off the column tile
    (20, 64, 128, 5, 33, 20),             # T off the tile, one group
    (256, 2048, 30720, 30000, 16, 16),    # a large bank
])
def test_memory_loss_extra_negatives_match_plain(card, b, d, k_pad, nv, t, group):
    """K6 with ``ex_f``: the loss within 1e-4 and dL/dx within 1e-6 of the
    plain version's autograd in fp64 on the same fp32 inputs; the bank's
    logits within 1e-4 and bit-equal to K6's without ``ex_f``; the extra
    columns within 1e-4, or 1e-6 relative where the −10000 self-mask puts
    them near −2e5 (an fp32 ulp there is 0.016); no gradient to ``ex_f``."""
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        memory_loss,
        memory_loss_plain,
    )

    g = torch.Generator(device=card).manual_seed(b + k_pad + t + group)
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device=card, generator=g), dim=1)
    state = init_memory(centers, k_pad=k_pad, device=card)
    y = torch.randint(0, nv, (b,), device=card, generator=g, dtype=torch.int32)
    x = (centers[y.long()] + 0.5 * torch.randn((b, d), device=card, generator=g))
    x = x.contiguous().requires_grad_(True)
    ex = (centers[torch.randint(0, nv, (t,), device=card, generator=g)] +
          0.3 * torch.randn((t, d), device=card, generator=g)).requires_grad_(True)
    loss, logits = memory_loss(x, y, state, ex_f=ex, group_size=group)
    loss.mean().backward()
    _, bank_logits = memory_loss(x.detach(), y, state)
    x64 = x.detach().double().requires_grad_(True)
    s64 = state._replace(features=state.features.double())
    ref, ref_logits = memory_loss_plain(x64, y, s64, ex_f=ex.detach().double(),
                                        group_size=group)
    ref.mean().backward()
    torch.cuda.synchronize()
    assert logits.shape == (b, k_pad + t) and ex.grad is None
    assert torch.equal(logits[:, :k_pad], bank_logits)
    assert torch.isneginf(logits[:, nv:k_pad]).all()
    assert float((logits[:, :nv].double() - ref_logits[:, :nv]).abs().max()) <= 1e-4
    lex, rex = logits[:, k_pad:].double(), ref_logits[:, k_pad:]
    masked = (torch.arange(b, device=card)[:, None] // group ==
              torch.arange(t, device=card)[None])
    err = (lex - rex).abs()
    assert masked.any()
    assert float(torch.where(masked, 0.0, err).max()) <= 1e-4
    assert float(torch.where(masked, err / rex.abs(), 0.0).max()) <= 1e-6
    assert float((loss.double() - ref).abs().max()) <= 1e-4
    assert float((x.grad.double() - x64.grad).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# K12 diff_transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(16, 128, 64), (1, 128, 64), (3, 5, 7), (17, 16, 8)])
def test_diff_transform_matches_plain(card, n, h, w):
    """K12 (2x bicubic upsample) at odd batches and frames, on images whose
    first and last two rows and columns alternate −1 and +1, so the
    renormalised taps of the first and last three output rows and columns
    see full swings: every pixel within 5e-6 of the plain version in fp32
    and of its fp64 arithmetic on the same inputs (about 20 fp32 ulps of
    the outputs' magnitude: 16 taps summed in another order, then ÷ std);
    NCHW in channels_last memory."""
    from reid_gan_torch.ops.transforms import diff_transform, diff_transform_plain

    g = torch.Generator(device=card).manual_seed(n * h + w)
    img = torch.tanh(2 * torch.randn((n, 3, h, w), device=card, generator=g))
    alt = (torch.arange(h, device=card)[:, None] + torch.arange(w, device=card)[None]) % 2
    alt = alt.float() * 2 - 1
    for rows in (slice(0, 2), slice(h - 2, h)):
        img[:, :, rows] = alt[rows]
    for cols in (slice(0, 2), slice(w - 2, w)):
        img[:, :, :, cols] = alt[:, cols]
    img = img.contiguous()
    out = diff_transform(img, 2 * h, 2 * w)
    ref = diff_transform_plain(img, 2 * h, 2 * w)
    ref64 = diff_transform_plain(img.double(), 2 * h, 2 * w)
    torch.cuda.synchronize()
    assert out.shape == (n, 3, 2 * h, 2 * w) and out.stride() == ref.stride()
    assert float((out - ref).abs().max()) <= 5e-6
    assert float((out.double() - ref64).abs().max()) <= 5e-6
    edge = (out.double() - ref64)[:, :, [0, 1, 2, -3, -2, -1]]
    assert float(edge.abs().max()) <= 5e-6


def test_diff_transform_rejects_bad_inputs(card):
    from reid_gan_torch.ops.transforms import diff_transform

    x = torch.zeros((2, 3, 8, 4), device=card)
    with pytest.raises(ValueError, match="forward only"):
        diff_transform(x.clone().requires_grad_(True), 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        diff_transform(x.transpose(2, 3), 16, 8)
    with pytest.raises(ValueError, match="upsamples"):
        diff_transform(x, 4, 2)


# ---------------------------------------------------------------------------
# K7 bank_fold (update_memory)
# ---------------------------------------------------------------------------

def _fold_inputs(card, b, d, k_pad, labels, seed):
    from reid_gan_torch.ops.cluster_memory import init_memory

    g = torch.Generator(device=card).manual_seed(seed)
    centers = torch.nn.functional.normalize(
        torch.randn((k_pad, d), device=card, generator=g), dim=1)
    gan = torch.randn((k_pad, d), device=card, generator=g)
    x = torch.randn((b, d), device=card, generator=g)
    y = torch.as_tensor(labels, dtype=torch.int32, device=card)
    return (init_memory(centers, k_pad=k_pad, gan_centroids=gan, device=card),
            x, y)


@pytest.mark.parametrize("case", ["one_label", "all_distinct", "pxk", "hard_tie"])
def test_update_memory_matches_plain(card, case):
    """Plain fold (feature and GAN banks) and hard fold against the plain
    version on copies of the same bank: within 1e-6 on unit rows."""
    from reid_gan_torch.ops.cluster_memory import update_memory, update_memory_plain

    b, d, k_pad = 256, 2048, 300
    hard = case == "hard_tie"
    if case == "one_label":
        labels = [7] * b
    elif case == "all_distinct":
        labels = list(range(b))
    else:
        labels = [(i * 37) % 16 * 17 for i in range(b)]     # 16 labels x 16
    state, x, y = _fold_inputs(card, b, d, k_pad, labels, seed=len(case))
    if hard:   # two slots of one label with the same, least similarity
        row = state.features[y[3].long()]
        x[3] = -row * 2
        x[3 + 16 * 2] = x[3]                   # the same label 32 slots later
        assert int(y[3]) == int(y[3 + 32])
    ref = state._replace(features=state.features.clone(),
                         gan_features=state.gan_features.clone())
    update_memory(state, x, y, use_hard=hard, gan_x=None if hard else x * 3)
    update_memory_plain(ref, x, y, use_hard=hard, gan_x=None if hard else x * 3)
    torch.cuda.synchronize()
    assert float((state.features - ref.features).abs().max()) <= 1e-6
    assert float((state.gan_features - ref.gan_features).abs().max()) <= 1e-5
    touched = torch.unique(y.long())
    norms = state.features[touched].norm(dim=1)
    assert float((norms - 1).abs().max()) <= 1e-5


def test_update_memory_rejects_bad_inputs(card):
    from reid_gan_torch.ops.cluster_memory import init_memory, update_memory

    state = init_memory(torch.eye(4, 8, device=card), device=card)
    y = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="D == 8"):
        update_memory(state, torch.ones((2, 12), device=card), y)
    wide = init_memory(torch.ones((2, 4100), device=card), device=card)
    with pytest.raises(ValueError, match="4096"):
        update_memory(wide, torch.ones((2, 4100), device=card), y)


# ---------------------------------------------------------------------------
# K8 knn_topk (knn_search)
# ---------------------------------------------------------------------------

def _knn_features(card, n, d, seed, ties=False):
    g = torch.Generator(device=card).manual_seed(seed)
    f = torch.nn.functional.normalize(torch.randn((n, d), device=card, generator=g), dim=1)
    if ties:   # exact keys on both sides (see chip_smoke._train_features)
        f = torch.round(f * 256) / 256
        f[1::2] = f[0::2][:n // 2]
    return f.contiguous()


@pytest.mark.parametrize("n,d,k,metric,ties", [
    (40, 8, 1, "l2", False),        # N below one 64-row tile, k = 1
    (40, 2048, 30, "ip", False),
    (1000, 100, 30, "l2", False),   # N and D off the tiles (D off the 32 stage)
    (1000, 2048, 64, "l2", False),  # the largest k
    (700, 8, 64, "ip", False),
    (4100, 36, 30, "l2", True),     # exact ties, several gallery splits
    (4100, 36, 15, "ip", True),
    (129, 10, 7, "l2", False),      # D not a multiple of 4: zero columns added
    (2048, 64, 65, "l2", False),    # k above the register lists: lists in scratch
    (2048, 64, 128, "ip", False),
    (2048, 64, 256, "l2", False),
    (2048, 64, 300, "ip", False),
    (2048, 36, 128, "l2", True),    # exact ties with the lists in scratch
    (4100, 36, 300, "ip", True),
    (300, 16, 300, "l2", False),    # k = N
])
def test_knn_search_matches_plain(card, n, d, k, metric, ties):
    """Values within 2e-5 of the plain version; where an index differs, the
    plain version's key of the kernel's index is within 2e-5 of the key at
    that slot (a near-tie summed in another order). With exact ties the
    indices and values are identical (the lower index first). Self first in
    the tie-free case."""
    from reid_gan_torch.ops.distance import (
        knn_search,
        knn_search_plain,
        matmul_fp32,
        squared_euclidean,
    )

    f = _knn_features(card, n, d, seed=n + d + k, ties=ties)
    vals, idx = knn_search(f, k, metric)
    pv, pi = knn_search_plain(f, k, metric)
    assert vals.shape == (n, k) and idx.dtype == pi.dtype
    if ties:
        assert (pv[:, 1:] == pv[:, :-1]).any()
        assert (idx == pi).all() and (vals == pv).all()
        return
    assert float(abs(vals - pv).max()) <= 2e-5
    rows, cols = (idx != pi).nonzero()
    if rows.size:
        full = squared_euclidean(f, f) if metric == "l2" else matmul_fp32(f, f.T)
        got = full.cpu().numpy()[rows, idx[rows, cols]]
        assert float(abs(got - pv[rows, cols]).max()) <= 2e-5
    assert (idx[:, 0] == range(n)).all()


def test_knn_search_rejects_k_above_64(card):
    """K8 serves every k up to N (65, above the register lists, launches);
    k above N and k below 1 raise."""
    from reid_gan_torch import kernels
    from reid_gan_torch.ops.distance import knn_search

    f = _knn_features(card, 100, 8, seed=0)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="k <= N"):
        knn_search(f[:10], 11)
    with pytest.raises(ValueError, match="k <= N"):
        knn_search(f, 0)
    knn_search(f, 64, "ip")
    knn_search(f, 65, "l2")
    assert kernels.launch_counts()["knn_topk"] == 2


@pytest.mark.parametrize("shape", [(1, 128, 64, 3), (3, 5, 7, 3), (257, 16, 8, 3)])
def test_gan_input_matches_plain(card, shape):
    """K9 at an odd batch, an odd frame and one image: NCHW float32 within
    one ulp of values in [-1, 1] (torch's CUDA scalar division may multiply
    by the reciprocal)."""
    from reid_gan_torch.ops.transforms import gan_input_transform, gan_input_transform_plain

    g = torch.Generator(device=card).manual_seed(sum(shape))
    u8 = torch.randint(0, 256, shape, dtype=torch.uint8, device=card, generator=g)
    out = gan_input_transform(u8, shape[1], shape[2])
    ref = gan_input_transform_plain(u8)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.stride() == ref.stride()
    assert float((out - ref).abs().max()) <= 1e-6


def test_gan_input_rejects_a_batch_off_the_gan_size(card):
    from reid_gan_torch.ops.transforms import gan_input_transform

    with pytest.raises(ValueError, match="GAN size"):
        gan_input_transform(torch.zeros((2, 64, 32, 3), dtype=torch.uint8,
                                        device=card), 128, 64)


@pytest.mark.parametrize("n,k,h,w", [(3, 18, 128, 64), (1, 5, 7, 3), (33, 18, 16, 8)])
def test_pose_maps_match_plain(card, n, k, h, w):
    """K10 at an odd batch and frames: joints missing in y, in x and in both,
    one image with every joint missing (all-zero maps), joints at the
    frame's corners (a peak of 1 there); within 1e-6."""
    from reid_gan_torch.ops.pose import batch_cords_to_map, batch_cords_to_map_plain

    g = torch.Generator(device=card).manual_seed(n * k + h)
    old = torch.tensor([[256.0, 128.0], [300.0, 97.0]], device=card)[
        torch.arange(n, device=card) % 2]
    cords = torch.rand((n, k, 2), device=card, generator=g) * old[:, None, :]
    cords[0, 0, 0] = -1
    cords[0, 1 % k, 1] = -1
    cords[0, 2 % k] = -1
    if n > 1:
        cords[1] = -1
    cords[-1, -1] = torch.tensor([0.0, 0.0], device=card)
    cords[-1, 0] = old[-1] - 1e-3
    out = batch_cords_to_map(cords.contiguous(), old.contiguous(), h, w)
    ref = batch_cords_to_map_plain(cords, old, h, w)
    torch.cuda.synchronize()
    assert out.shape == (n, k, h, w)
    assert float((out - ref).abs().max()) <= 1e-6
    if n > 1:
        assert not out[1].any()
    assert float(out[-1, -1, 0, 0]) == 1.0 and float(out[-1, 0, h - 1, w - 1]) == 1.0


@pytest.mark.parametrize("n,c,h,w", [(3, 516, 5, 3), (1, 12, 1, 1), (5, 7, 4, 2),
                                     (2, 2048, 16, 8)])
def test_gan_feat_l2n_matches_plain(card, n, c, h, w):
    """K11 with channel counts off the 128-float warp stride (516, 12), off
    the vector width (7: the scalar loop), one position, and the main path's
    2048: unit columns within 1e-6; detached, channels_last."""
    from reid_gan_torch.models.resnet import gan_feat, gan_feat_plain

    g = torch.Generator(device=card).manual_seed(n * c)
    fmap = torch.randn((n, c, h, w), device=card, generator=g, requires_grad=True)
    x = fmap.contiguous(memory_format=torch.channels_last)
    out = gan_feat(x)
    ref = gan_feat_plain(x.detach())
    torch.cuda.synchronize()
    assert not out.requires_grad and out.is_contiguous(memory_format=torch.channels_last)
    assert float((out - ref).abs().max()) <= 1e-6


def test_gan_feat_l2n_rejects_an_nchw_map(card):
    from reid_gan_torch.models.resnet import gan_feat

    with pytest.raises(ValueError, match="channels_last"):
        gan_feat(torch.zeros((2, 8, 3, 3), device=card))


# ---------------------------------------------------------------------------
# K13 pose_peaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(7, 256, 128), (1, 64, 32), (5, 9, 7), (3, 33, 20)])
def test_pose_peaks_match_plain(card, n, h, w):
    """K13 with σ 4, 5 and 6, erased channels, joints missing in y, in x and
    in both, joints on the frame's corners and edges, and flips, at odd
    frames (the scalar path) and frames of a multiple of 4 (float4 stores):
    within 1e-6 (expf against torch.exp)."""
    from reid_gan_torch.ops.pose import render_pose_peaks, render_pose_peaks_plain

    g = torch.Generator(device=card).manual_seed(n * h + w)
    lm = torch.stack([torch.randint(0, h, (n, 18), device=card, generator=g),
                      torch.randint(0, w, (n, 18), device=card, generator=g)], -1).float()
    lm[0, 0, 0], lm[0, 1, 1], lm[0, 2] = -1, -1, -1
    lm[-1, 3] = torch.tensor([0.0, 0.0], device=card)
    lm[-1, 4] = torch.tensor([h - 1.0, w - 1.0], device=card)
    lm[-1, 5] = torch.tensor([h / 2.0, 0.0], device=card)
    sigma = torch.tensor([4.0, 5.0, 6.0], device=card)[torch.arange(n, device=card) % 3]
    erase = torch.where(torch.arange(n, device=card) % 2 == 0,
                        torch.randint(0, 18, (n,), device=card, generator=g), -1)
    erase[-1] = -1
    flip = (torch.arange(n, device=card) % 2).to(torch.int32)
    args = (lm.contiguous(), sigma.contiguous(), erase.to(torch.int32).contiguous(),
            flip.contiguous())
    out = render_pose_peaks(*args, h, w)
    ref = render_pose_peaks_plain(*args, h, w)
    torch.cuda.synchronize()
    assert out.shape == (n, 18, h, w)
    assert float((out - ref).abs().max()) <= 1e-6
    assert not out[0, :3].any()
    c = w - 1 if flip[-1] else 0
    assert float(out[-1, 3, 0, c]) == 1.0


def test_pose_peaks_reject_bad_inputs(card):
    from reid_gan_torch.ops.pose import render_pose_peaks

    lm = torch.zeros((2, 18, 2), device=card)
    s = torch.full((2,), 5.0, device=card)
    e = torch.full((2,), -1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="sigma"):
        render_pose_peaks(lm, s.double(), e, e, 16, 8)
    with pytest.raises(ValueError, match="float32"):
        render_pose_peaks(lm.double(), s, e, e, 16, 8)


# ---------------------------------------------------------------------------
# K14 fd_augment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(9, 256, 128), (1, 64, 32), (4, 7, 5)])
def test_fd_augment_matches_plain(card, n, h, w):
    """K14 with the port's draws plus rectangles on the four borders and the
    whole frame, each flipped and not: within 1e-6 (IEEE divisions in the
    same order on both sides); channels_last float32."""
    from reid_gan_torch.ops.transforms import (
        fd_augment,
        fd_augment_plain,
        sample_fd_augment_params,
    )

    g = torch.Generator(device=card).manual_seed(n * h + w)
    img = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=card, generator=g)
    p = sample_fd_augment_params(n, h, w, g)
    edges = [(0, 0, h, 2), (0, w - 2, h, 2), (0, 0, 1, w), (h - 1, 0, 1, w), (0, 0, h, w)]
    for i, (t, l, eh, ew) in enumerate(edges[:n]):
        p[i, :6] = torch.tensor([1.0, t, l, eh, ew, i % 2], device=card)
    out = fd_augment(img, p)
    ref = fd_augment_plain(img, p)
    torch.cuda.synchronize()
    assert out.shape == (n, 3, h, w) and out.is_contiguous(memory_format=torch.channels_last)
    assert float((out - ref).abs().max()) <= 1e-6


def test_fd_augment_rejects_bad_inputs(card):
    from reid_gan_torch.ops.transforms import fd_augment

    img = torch.zeros((2, 8, 4, 3), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="params"):
        fd_augment(img, torch.zeros((2, 10), device=card))
    with pytest.raises(ValueError, match="uint8"):
        fd_augment(img.float(), torch.zeros((2, 9), device=card))
