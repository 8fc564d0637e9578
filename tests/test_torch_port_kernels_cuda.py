"""The port's CUDA kernels against their plain versions on the card, at the
edges that ``chip_smoke.py`` does not reach: element counts off the vector
width, narrow and odd maps, galleries smaller than a block, queries with no
match, rows with more matches than K3 stages in one round; crops and erase
rectangles at the borders, a 1 x 1 crop, every image flipped or none and
erased or none, widths on and off the float4 and the 16-byte staging copy,
one image and heights off the eight bands (K4); p other than 3, maps of
zeros and odd sizes, one image, one position and positions and channels
off the block's split, the backbone variants' 8x8 and 8x4 maps and the
halves of a channels_last map through ``part_map`` (K5; K2 at the
variants' maps too); one live bank row, a full bank and banks off the
column tile, D under the tensor cores' depth and off the stage and the D
slice, num_valid on and one past a tile, stage and slice edge, a bank of
30,720 rows, and extra negatives (``ex_f``) of 1, 16 and 33 rows in
groups of 1 and of the whole batch, against banks of 768 and 30,720 rows,
on a data-mesh rank's rows from a global ``row0`` (the self-mask at the
row's global group; ``row0`` 0 the call without it) (K6), called twice in one graph against one bank (the bip step) and
against trainable clusters (the learnable-memory step); the same bits on a
second run (K5, K6); one label for the whole
batch, all labels distinct and exact ties in the hard fold (K7); sets smaller than a tile, D off the stage and off the
vector width, k of 1, 64, 65, 128, 256 and 300 (the register lists and the
lists in scratch), exact ties and the inner product (K8); odd
batches and frames (K9, K10), missing joints and joints on the frame's
corners (K10), channel counts off the warp stride and the vector width
(K11), odd batches, frames and the rows next to the edge, whose taps are
renormalised, scales other than 2x, bands of rows that do not divide the
height, one image and tiles of columns past 48 KiB of shared memory (K12);
every byte value in every channel bit-equal to the float32 IEEE formula
(bf16: its rounding to nearest even), element counts with every tail and
batches 4-byte but not 16-byte aligned (K1); the all-shots rows and the
separate camera set, the same bits on a second launch, one match, every
valid entry tied, |M| at and one past a round, rows off 16-byte alignment,
q off a block's rows, MSMT17's 82,161-entry gallery and the raise past
2^21 entries (K3); every σ, erased channels, missing and corner
joints and flips on odd frames (K13); erase rectangles at the borders with
flips, every image flipped, none, or erased, widths on and off the float4
path, one image and odd frames (K14); the same bits on a second launch
(K1, K4, K12, K14 as K5, K6); and the raise on inputs a kernel does not
take, a C entry's size checks as a ValueError (K4, K14). Beside the
kernels: ``ops/norm.py``'s global BatchNorm against torch's
``SyncBatchNorm`` on a mesh of one rank, odd channel counts, one image a
rank.

Needs a CUDA card; skips without one. This file imports no JAX, so it runs
on a machine without it, with the JAX test harness left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels_cuda.py
"""

import numpy as np
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


def _k1_formula(u8, dtype):
    """numpy's float32 IEEE ``(b / 255 - mean[c]) / std[c]`` of an (N, H, W,
    3) batch as int32 bits, or its bf16 rounding (nearest even) as int16."""
    from reid_gan_torch.ops.transforms import IMAGENET_MEAN, IMAGENET_STD

    b = np.arange(256, dtype=np.float32)
    table = np.stack([(b / np.float32(255) - np.float32(m)) / np.float32(s)
                      for m, s in zip(IMAGENET_MEAN, IMAGENET_STD)]).view(np.uint32)
    if dtype == torch.bfloat16:
        table = ((table + 0x7FFF + ((table >> 16) & 1)) >> 16).astype(np.uint16).view(np.int16)
    else:
        table = table.view(np.int32)
    x = u8.cpu().numpy()
    return torch.from_numpy(table[np.arange(3), x]).to(u8.device)


def _k1_bits(out, dtype):
    """K1's output (channels_last) as (N, H, W, 3) integer bits."""
    return out.permute(0, 2, 3, 1).view(torch.int32 if dtype == torch.float32 else torch.int16)


def _k1_batch(card, shape, offset, seed):
    """A uint8 (N, H, W, 3) batch starting ``offset`` bytes past a 16-byte
    boundary."""
    g = torch.Generator(device=card).manual_seed(seed)
    n = shape[0] * shape[1] * shape[2] * 3
    flat = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device=card, generator=g)
    assert flat.data_ptr() % 16 == 0
    return flat[offset:offset + n].view(shape)


@pytest.mark.parametrize("offset", [0, 4, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_transform_is_the_ieee_formula_bit_for_bit(card, dtype, offset):
    """A batch that holds every byte value in every channel, 16-byte aligned
    (48-byte groups) and 4-byte but not 16-byte aligned (12-byte groups):
    every value bit-equal to numpy's float32 IEEE (b / 255 - mean) / std, and
    in bf16 to its rounding to nearest even."""
    from reid_gan_torch.ops.transforms import eval_transform

    u8 = _k1_batch(card, (3, 16, 16, 3), offset, 0)
    ramp = torch.arange(256, device=card, dtype=torch.int32).view(1, 16, 16, 1)
    shift = torch.arange(3, device=card, dtype=torch.int32).view(1, 1, 1, 3) * 85 + \
        torch.arange(3, device=card, dtype=torch.int32).view(3, 1, 1, 1)
    u8.copy_(((ramp + shift) % 256).to(torch.uint8))
    out = eval_transform(u8, 16, 16, dtype)
    torch.cuda.synchronize()
    assert torch.equal(_k1_bits(out, dtype), _k1_formula(u8, dtype))


@pytest.mark.parametrize("offset", [0, 4, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_transform_tails(card, dtype, offset):
    """Widths 40-55 of one row: element counts with every tail modulo 48
    (and modulo 12 on the 4-byte aligned path), bit-equal to the formula
    and within the plain version's tolerance."""
    from reid_gan_torch.ops.transforms import eval_transform, eval_transform_plain

    for w in range(40, 56):
        u8 = _k1_batch(card, (1, 1, w, 3), offset, w)
        out = eval_transform(u8, 1, w, dtype)
        ref = eval_transform_plain(u8, dtype)
        torch.cuda.synchronize()
        assert torch.equal(_k1_bits(out, dtype), _k1_formula(u8, dtype)), w
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6
        assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_transform_gives_the_same_bits_run_to_run(card, dtype):
    from reid_gan_torch.ops.transforms import eval_transform

    u8 = _k1_batch(card, (4, 64, 32, 3), 0, 5)
    first, second = eval_transform(u8, 64, 32, dtype), eval_transform(u8, 64, 32, dtype)
    torch.cuda.synchronize()
    assert torch.equal(_k1_bits(first, dtype), _k1_bits(second, dtype))


def _gem_bn_inputs(card, n, c, h, w, p):
    g = torch.Generator(device=card).manual_seed(c)
    fmap = torch.relu(torch.rand((n, c, h, w), device=card, generator=g) * 2 - 0.3)
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    pp = torch.tensor([p], device=card)
    gamma = torch.rand(c, device=card, generator=g) + 0.5
    mean = torch.rand(c, device=card, generator=g) * 0.2
    var = torch.rand(c, device=card, generator=g) + 0.5
    return fmap, pp, gamma, mean, var


@pytest.mark.parametrize("n,c,h,w,p", [(3, 12, 5, 1, 3.2), (2, 2048, 16, 8, 1.0),
                                       (5, 516, 3, 3, 4.5), (16, 2048, 16, 8, 3.0),
                                       (1, 2048, 16, 8, 4.5), (2, 12288, 2, 2, 3.0),
                                       (256, 2048, 8, 8, 3.0), (256, 2048, 8, 4, 3.0)])
def test_gem_bn_l2n_matches_plain(card, n, c, h, w, p):
    """Channel counts under one chunk of 128 and with a partial last chunk
    (C 12, 516), a single position column, p = 1 (average pooling) and 4.5,
    the hard-mix step's 16 images and one image at full width, the widest
    C (96 chunks over a cluster of 16), and the backbone variants' maps at
    the extraction batch (8x8, a half of ``resnet_mp50``'s part map; 8x4,
    its global branch): unit vectors within 1e-5 (lg2/ex2 against
    torch.pow, and the sum order)."""
    from reid_gan_torch.models.pooling import gem_bn_l2n, gem_bn_l2n_plain

    args = _gem_bn_inputs(card, n, c, h, w, p)
    out = gem_bn_l2n(*args)
    ref = gem_bn_l2n_plain(*args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,c,h,w", [(16, 2048, 16, 8), (5, 516, 3, 3)])
def test_gem_bn_l2n_gives_the_same_bits_run_to_run(card, n, c, h, w):
    """The cluster adds its blocks' partial norms in rank order: the same
    bits on every launch."""
    from reid_gan_torch.models.pooling import gem_bn_l2n

    args = _gem_bn_inputs(card, n, c, h, w, 3.0)
    first, second = gem_bn_l2n(*args), gem_bn_l2n(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


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


def _rank_cap():
    """K3's staged same-id entries a row per round (``kCap`` in the source)."""
    import os.path as osp
    import re

    src = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   "reid_gan_torch", "csrc", "rank_stats.cu")
    with open(src) as fh:
        return int(re.search(r"constexpr int kCap = (\d+);", fh.read()).group(1))


def _rank_check(args, sep=False, topk=0):
    """K3 against its plain version (match counts and first bins exactly, AP
    and the all-shots rows within 1e-6) and a second launch (the same bits)."""
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain

    kw = dict(separate_camera_set=sep, allshots_topk=topk)
    out, again, ref = rank_stats(*args, **kw), rank_stats(*args, **kw), \
        rank_stats_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out[2], ref[2]) and torch.equal(out[1], ref[1])
    assert float((out[0] - ref[0]).abs().max()) <= 1e-6
    if topk:
        assert out[3].shape == ref[3].shape
        assert float((out[3] - ref[3]).abs().max()) <= 1e-6
    for a, b in zip(out, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return out


@pytest.mark.parametrize("sep,topk", [(False, 0), (True, 100)],
                         ids=["first_match", "allshots_separate_cams"])
@pytest.mark.parametrize("q,n,num_ids,ties", [
    (9, 1000, 10, True),
    (6, 4000, 2, False),           # rounds
])
def test_rank_stats_same_bits_on_a_second_launch(card, sep, topk, q, n, num_ids, ties):
    """AP, first bins, match counts and all-shots rows: the same bits on a
    second launch (the AP terms are summed in sorted order, not in the order
    in which matches are found)."""
    _rank_check(_rank_case(card, q, n, num_ids, ties, seed=7 * q + n), sep, topk)


@pytest.mark.parametrize("topk", [0, 16])
def test_rank_stats_one_match_and_all_tied(card, topk):
    """Row 1 has exactly one valid match; in row 2 every valid entry ties
    with a match (AP |M| / |V|, all-shots bins by index)."""
    d, qid, qcam, gid, gcam = _rank_case(card, 4, 300, 50, False, seed=11)
    gid[(gid == 7) | (gid == 9)] = 8
    gid[5], gcam[5], qid[1], qcam[1] = 7, 1, 7, 0          # the one match
    gid[10:20], gcam[10:20], qid[2], qcam[2] = 9, 1, 9, 0  # ten matches,
    gcam[12] = 0                                            # one junk entry
    d[2] = 3.0                                              # all tied
    out = _rank_check((d, qid, qcam, gid, gcam), topk=topk)
    assert int(out[2][1]) == 1 and int(out[2][2]) == 9


@pytest.mark.parametrize("extra", [0, 1], ids=["at_capacity", "one_past"])
@pytest.mark.parametrize("sep,topk", [(False, 0), (True, 20)],
                         ids=["first_match", "allshots_separate_cams"])
def test_rank_stats_matches_at_and_past_a_round(card, extra, sep, topk):
    """Row 1 has exactly as many same-id entries as a round stages, all
    valid matches (one round), or one more (two rounds); row 3 of the same
    block half as many, with junk (same camera) among them; the other rows a
    few matches each, so one block mixes rows of one and of two rounds."""
    cap = _rank_cap()
    d, qid, qcam, gid, gcam = _rank_case(card, 8, 3000, 600, False, seed=cap + extra)
    gid[:cap + extra], gcam[:cap + extra], qid[1], qcam[1] = 1000, 1, 1000, 0
    gid[-cap // 2:], gcam[-cap // 2:], qid[3], qcam[3] = 1001, 2, 1001, 0
    gcam[-3:] = 0                                           # junk
    perm = torch.randperm(3000, device=card, generator=torch.Generator(card).manual_seed(1))
    gid, gcam = gid[perm].contiguous(), gcam[perm].contiguous()
    out = _rank_check((d, qid, qcam, gid, gcam), sep, topk)
    assert int(out[2][1]) == cap + extra and int(out[2][3]) == cap // 2 - 3


@pytest.mark.parametrize("sep,topk", [(False, 0), (True, 100)],
                         ids=["first_match", "allshots_separate_cams"])
@pytest.mark.parametrize("n,offset", [(1001, 0), (1003, 1), (1002, 2), (999, 3)])
def test_rank_stats_rows_off_16_byte_alignment(card, sep, topk, n, offset):
    """n off the 4-wide loads: rows start at every offset from a 16-byte
    boundary, the block's first row too (``offset`` floats into a larger
    buffer), with heads and tails of 1-3 columns."""
    d, qid, qcam, gid, gcam = _rank_case(card, 13, n, 20, True, seed=n + offset)
    buf = torch.empty(13 * n + offset, device=card)
    buf[offset:] = d.flatten()
    d = buf[offset:].view(13, n)
    assert d.data_ptr() % 16 == 4 * offset
    _rank_check((d, qid, qcam, gid, gcam), sep, topk)


@pytest.mark.parametrize("q", [1, 13, 33])
def test_rank_stats_rows_off_the_block(card, q):
    """q not a multiple of a block's rows, each row its own id and camera."""
    d, _, _, gid, gcam = _rank_case(card, q, 2500, 40, False, seed=q)
    qid = torch.arange(q, device=card, dtype=torch.int32) % 40
    qcam = torch.arange(q, device=card, dtype=torch.int32) % 3
    for sep, topk in ((False, 0), (True, 50)):
        _rank_check((d, qid, qcam, gid, gcam), sep, topk)


def test_rank_stats_rejects_a_gallery_past_its_counters(card):
    """A lane's counts are kept in 16 bits: a gallery of 2^21 entries or
    more raises, naming the limit."""
    from reid_gan_torch.engine.metrics import RANK_STATS_MAX_N, rank_stats

    n = RANK_STATS_MAX_N
    d = torch.zeros((1, n), device=card)
    ids = torch.zeros(n, dtype=torch.int32, device=card)
    one = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="gallery"):
        rank_stats(d, one, one, ids, ids)


def test_rank_stats_msmt17_gallery(card):
    """A few rows against 82,161 gallery entries of 3,060 ids and 15
    cameras (MSMT17's gallery), both protocols."""
    g = torch.Generator(device=card).manual_seed(17)
    q, n = 5, 82161
    d = torch.rand((q, n), device=card, generator=g)
    qid = torch.randint(0, 3060, (q,), device=card, generator=g, dtype=torch.int32)
    gid = torch.randint(0, 3060, (n,), device=card, generator=g, dtype=torch.int32)
    qcam = torch.randint(0, 15, (q,), device=card, generator=g, dtype=torch.int32)
    gcam = torch.randint(0, 15, (n,), device=card, generator=g, dtype=torch.int32)
    for sep, topk in ((False, 0), (True, 100)):
        out = _rank_check((d, qid, qcam, gid, gcam), sep, topk)
        assert int(out[2].min()) > 0


# ---------------------------------------------------------------------------
# K4 train_augment
# ---------------------------------------------------------------------------

def _set_draws(p, case, flip, erase):
    """The draws of an augment case: as drawn, every image flipped or none,
    every image erased or none (``flip`` and ``erase`` are the columns)."""
    if case == "flip":
        p[:, flip] = 1.0
    elif case == "no_flip":
        p[:, flip] = 0.0
    elif case == "all_erased":
        p[:, erase] = 1.0
    elif case == "none_erased":
        p[:, erase] = 0.0


@pytest.mark.parametrize("case", ["drawn", "flip", "no_flip", "all_erased", "none_erased"])
@pytest.mark.parametrize("n,h,w", [(8, 32, 16), (3, 7, 5), (5, 256, 128), (1, 40, 20),
                                   (6, 9, 6)])
def test_train_augment_matches_plain(card, n, h, w, case):
    """Random draws plus crops flush with the borders, the whole image, a
    1 x 1 crop, a one-pixel erase and a whole-image erase, with every image
    flipped or none and erased or none: within 1e-5 (the same fp32
    arithmetic; the fill mean sums in another order), and the same bytes on
    a second launch. Widths on and off the float4 (W % 4) and the 16-byte
    staging copy (3W % 16), one image, and heights under, on and past the
    eight bands an image and the chunk of 16 rows."""
    from reid_gan_torch.ops.transforms import (
        ERASE,
        FLIP,
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    g = torch.Generator(device=card).manual_seed(n * h)
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=card, generator=g)
    p = sample_augment_params(n, h, w, g)
    crops = [[0.0, 0.0, h * 0.7, w * 0.6],                   # top-left
             [h * 0.3, w * 0.4, h * 0.7, w * 0.6],           # bottom-right
             [0.0, 0.0, float(h), float(w)],                  # whole
             [h * 0.5, w * 0.5, 1.0, 1.0]]                    # 1 x 1
    for i, crop in enumerate(crops[:n]):
        p[i, 1:5] = torch.tensor(crop)
    p[0, 5:] = torch.tensor([1.0, h - 1.0, w - 1.0, 1.0, 1.0])        # one pixel
    if n > 2:
        p[2, 5:] = torch.tensor([1.0, 0.0, 0.0, float(h), float(w)])  # whole image
    _set_draws(p, case, FLIP, ERASE)
    out = train_augment(u8, p, h, w)
    ref = train_augment_plain(u8, p)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.stride() == ref.stride()
    assert float((out - ref).abs().max()) <= 1e-5
    again = train_augment(u8, p, h, w)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_train_augment_rejects_bad_inputs(card):
    """The wrapper's checks, and the C entry's size checks as a ValueError:
    an empty batch, a width whose three staged rows do not fit in a block's
    shared memory, and more images than the grid's y."""
    from reid_gan_torch.ops.transforms import train_augment

    u8 = torch.zeros((2, 8, 4, 3), dtype=torch.uint8, device=card)
    p = torch.zeros((2, 10), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        train_augment(u8.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), p, 8, 4)
    with pytest.raises(ValueError, match="float32"):
        train_augment(u8, p.double(), 8, 4)
    for n, h, w in [(0, 8, 4), (1, 8, 4096), (65536, 1, 1)]:
        p = torch.zeros((n, 10), device=card)
        p[:, 3:5] = torch.tensor([float(h), float(w)])
        with pytest.raises(ValueError, match="reid_train_augment"):
            train_augment(torch.zeros((n, h, w, 3), dtype=torch.uint8, device=card), p, h, w)


# ---------------------------------------------------------------------------
# K5 gem_pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,h,w,p,zeros", [
    (4, 2048, 16, 8, 3.0, False),
    (3, 12, 3, 5, 2.5, False),       # odd map, C off the 512-channel block
    (2, 516, 7, 1, 4.0, False),      # one column, a second channel block
    (2, 64, 4, 4, 3.0, True),        # all zeros: every value clamps to eps
    (1, 2048, 16, 8, 3.0, False),    # one image
    (3, 132, 1, 1, 3.0, False),      # one position: one warp of the 8 works
    (2, 260, 127, 1, 3.5, False),    # S off the 8-warp position split, C off 128
    (256, 2048, 8, 8, 3.0, False),   # a half of resnet_mp50's 16x8 part map
    (256, 2048, 8, 4, 3.0, False),   # resnet_mp50's global branch at stride 2
])
def test_gem_pool_forward_backward_match_plain(card, n, c, h, w, p, zeros):
    """Forward, d map and dp against the plain version's autograd in fp64 on
    the same fp32 inputs: pooled and d map within 1e-5 relative (lg2/ex2
    and the sum order), dp within 1e-4 relative (a sum of N*C differences of
    terms of the size of ln eps, in double in the kernel). With one
    position GeM is the identity for every p, so dp is 0 and its two terms
    cancel: there dp is held within 1e-6 of the size of the cancelled terms,
    sum |g * out * ln(out) / p|."""
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
    elif h * w == 1:
        assert rel(fmap.grad, f64.grad) <= 1e-5
        cancelled = float((gout.double() * ref * ref.log()).abs().sum()) / p
        assert abs(float(pp.grad) - float(p64.grad)) <= 1e-6 * cancelled
    else:
        assert rel(fmap.grad, f64.grad) <= 1e-5
        assert abs(float(pp.grad) - float(p64.grad)) <= 1e-4 * abs(float(p64.grad))
    assert fmap.grad.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("n,h", [(4, 16), (256, 16), (3, 7)])
def test_gem_pool_on_part_maps_matches_plain(card, n, h):
    """K5 on the upper and lower halves of a channels_last map through
    ``part_map``, the route ``ResNetMP`` takes (a row slice of such a map is
    contiguous in neither format for N > 1, so each half is copied), against
    the plain version on the slices themselves: the pooled halves and the
    gradient of the whole map within 1e-5 relative, dp within 1e-4."""
    from reid_gan_torch.models.pooling import gem_pool, gem_pool_plain
    from reid_gan_torch.models.resnet_variants import part_map

    gen = torch.Generator(device=card).manual_seed(n + h)
    c, w = 2048, 8
    fmap = torch.relu(torch.rand((n, c, h, w), device=card, generator=gen) * 2 - 0.6)
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    gout = torch.randn((n, 2 * c), device=card, generator=gen)
    div = h // 2
    res = []
    for fn, part in ((gem_pool, part_map), (gem_pool_plain, lambda m, a, b: m[:, :, a:b])):
        x = fmap.detach().requires_grad_(True)
        p = torch.tensor([3.0], device=card, requires_grad=True)
        out = torch.cat([fn(part(x, 0, div), p), fn(part(x, div, h), p)], 1)
        out.backward(gout)
        res.append((out.detach(), x.grad, p.grad))
    torch.cuda.synchronize()
    (out, dx, dp), (ref, dx_r, dp_r) = res

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    assert rel(out, ref) <= 1e-5 and rel(dx, dx_r) <= 1e-5
    assert abs(float(dp) - float(dp_r)) <= 1e-4 * abs(float(dp_r))


def test_gem_pool_gives_the_same_bits_run_to_run(card):
    """K5 at the main path's shape twice: the pooled features, d map and dp
    bit-equal (fixed-order sums, no atomics)."""
    from reid_gan_torch.models.pooling import gem_pool

    gen = torch.Generator(device=card).manual_seed(55)
    fmap = torch.relu(torch.rand((256, 2048, 16, 8), device=card, generator=gen) * 2 - 0.6)
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    gout = torch.randn((256, 2048), device=card, generator=gen) / 256

    def run():
        x = fmap.detach().requires_grad_(True)
        p = torch.tensor([3.0], device=card, requires_grad=True)
        out = gem_pool(x, p)
        out.backward(gout)
        return out.detach(), x.grad, p.grad

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K6 infonce (memory_loss)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d,k_pad,nv", [
    (256, 2048, 768, 1),       # one live row
    (256, 2048, 768, 768),     # a full bank
    (20, 64, 100, 37),         # batch and bank off the tiles
    (33, 512, 64, 64),         # one column tile, a batch one past a row tile
    (20, 4, 100, 37),          # D 4: under the tensor cores' depth of 8
    (65, 36, 100, 64),         # D off the stage of 32; num_valid on a tile edge
    (100, 512, 256, 65),       # num_valid one past a tile edge; two D slices
    (33, 512, 64, 33),         # num_valid one past the backward's 32-row stage
    (64, 1028, 128, 100),      # D off the forward's slice of 288
    (256, 2048, 768, 192),     # num_valid on the backward's slice of 6 stages
    (256, 2048, 768, 193),     # one past it
    (256, 2048, 30720, 30000), # a large bank
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
    # no row of x, or no column of logits: the kernel would have an empty grid
    with pytest.raises(ValueError, match="at least one row"):
        memory_loss(torch.ones((0, 8), device=card), y[:0], state)
    with pytest.raises(ValueError, match="at least one row"):
        memory_loss(torch.ones((2, 8), device=card), y,
                    state._replace(features=torch.zeros((0, 8), device=card)))


def test_memory_loss_twice_in_one_graph_matches_plain(card):
    """The bip step's two calls against one bank (batch 256, D 2048, 700 of
    768 rows live) in one graph, on two branches of one input: each call's
    saved state is its own, so the half-sum's gradients at both branches and
    at their common input match the plain version's autograd in fp64 within
    1e-6, and each loss within 1e-4."""
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        memory_loss,
        memory_loss_plain,
    )

    g = torch.Generator(device=card).manual_seed(17)
    centers = torch.nn.functional.normalize(
        torch.randn((700, 2048), device=card, generator=g), dim=1)
    state = init_memory(centers, k_pad=768, device=card)
    y = torch.randint(0, 700, (256,), device=card, generator=g, dtype=torch.int32)
    root0 = centers[y.long()] + 0.5 * torch.randn((256, 2048), device=card, generator=g)
    mix = torch.randn((2048,), device=card, generator=g)
    grads, losses = [], []
    for fn, root, s in ((memory_loss, root0.clone().requires_grad_(True), state),
                        (memory_loss_plain, root0.double().requires_grad_(True),
                         state._replace(features=state.features.double()))):
        f1, f2 = root * mix, root + mix
        f1.retain_grad()
        f2.retain_grad()
        l1, l2 = fn(f1, y, s)[0], fn(f2, y, s)[0]
        (0.5 * (l1.mean() + l2.mean())).backward()
        grads.append((f1.grad, f2.grad, root.grad))
        losses.append((l1.detach(), l2.detach()))
    torch.cuda.synchronize()
    for a, b in zip(*losses):
        assert float((a.double() - b).abs().max()) <= 1e-4
    for a, b in zip(*grads):
        assert float((a.double() - b).abs().max()) <= 1e-6


def test_gradient_memory_loss_on_the_card_matches_plain(card):
    """K6 against trainable clusters (not unit rows, normalised and detached
    inside): the mean loss within 1e-4 and dL/dx within 1e-6 of the plain
    version's in fp64, and no gradient at the clusters."""
    from reid_gan_torch.ops.cluster_memory import (
        MemoryState,
        gradient_memory_loss,
        init_gradient_memory,
        memory_loss_plain,
    )

    g = torch.Generator(device=card).manual_seed(18)
    raw = torch.randn((700, 2048), device=card, generator=g) * 3.0
    gmem = init_gradient_memory(raw, k_pad=768, device=card)
    clusters = gmem.clusters.clone().requires_grad_(True)
    y = torch.randint(0, 700, (256,), device=card, generator=g, dtype=torch.int32)
    x = torch.randn((256, 2048), device=card, generator=g).requires_grad_(True)
    loss, _ = gradient_memory_loss(x, y, gmem._replace(clusters=clusters))
    loss.backward()
    bank = torch.nn.functional.normalize(gmem.clusters.double(), dim=1)
    x64 = x.detach().double().requires_grad_(True)
    ref = memory_loss_plain(x64, y, MemoryState(bank, bank[:0], gmem.num_valid))[0].mean()
    ref.backward()
    torch.cuda.synchronize()
    assert clusters.grad is None
    assert abs(float(loss) - float(ref)) <= 1e-4
    assert float((x.grad.double() - x64.grad).abs().max()) <= 1e-6


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


def _k6_rank_inputs(card, b, d, k_pad, nv, t, seed):
    from reid_gan_torch.ops.cluster_memory import init_memory

    g = torch.Generator(device=card).manual_seed(seed)
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device=card, generator=g), dim=1)
    state = init_memory(centers, k_pad=k_pad, device=card)
    y = torch.randint(0, nv, (b,), device=card, generator=g, dtype=torch.int32)
    x = (centers[y.long()] + 0.5 * torch.randn((b, d), device=card, generator=g))
    ex = centers[torch.randint(0, nv, (t,), device=card, generator=g)] + \
        0.3 * torch.randn((t, d), device=card, generator=g)
    return state, y, x.contiguous(), ex


@pytest.mark.parametrize("b,row0", [
    (64, 64), (64, 192),    # a rank's 64 of the hard-mix batch of 256 on four cards
    (48, 40),               # groups straddling the rank's first and last rows
    (37, 3),                # rows off the tile
])
def test_memory_loss_row0_matches_plain(card, b, row0):
    """K6 on a rank's rows under a data mesh: ``row0`` the global index of
    the first row, T = 16 extra negatives in groups of 16, D 2048, 768 bank
    rows of which 700 live. The loss within 1e-4 and dL/dx within 1e-6 of
    the plain version's autograd with the same ``row0`` in fp64; the extra
    columns within 1e-4, or 1e-6 relative where the self-mask puts them (at
    column (row0 + b) // 16); the bank's logits and the extra columns
    masked for the same rows at ``row0`` 0 bit-equal to K6's at ``row0``
    0, which gives the bits of the call without it."""
    from reid_gan_torch.ops.cluster_memory import memory_loss, memory_loss_plain

    d, k_pad, nv, t, group = 2048, 768, 700, 16, 16
    state, y, x0, ex = _k6_rank_inputs(card, b, d, k_pad, nv, t, b + row0)

    def run(**kw):
        x = x0.detach().requires_grad_(True)
        loss, logits = memory_loss(x, y, state, ex_f=ex, group_size=group, **kw)
        loss.mean().backward()
        return loss.detach(), logits, x.grad

    loss, logits, dx = run(row0=row0)
    zero, default = run(row0=0), run()
    x64 = x0.detach().double().requires_grad_(True)
    s64 = state._replace(features=state.features.double())
    ref, ref_logits = memory_loss_plain(x64, y, s64, ex_f=ex.double(), group_size=group,
                                        row0=row0)
    ref.mean().backward()
    torch.cuda.synchronize()
    for a, z in zip(zero, default):
        assert torch.equal(a, z)
    rows = torch.arange(b, device=card)[:, None]
    cols = torch.arange(t, device=card)[None]
    masked = (row0 + rows) // group == cols
    masked0 = rows // group == cols
    assert masked.any() and not torch.equal(masked, masked0)
    assert torch.equal(logits[:, :k_pad], zero[1][:, :k_pad])
    same = ~(masked | masked0)
    assert torch.equal(logits[:, k_pad:][same], zero[1][:, k_pad:][same])
    lex, rex = logits[:, k_pad:].double(), ref_logits[:, k_pad:]
    err = (lex - rex).abs()
    assert float(torch.where(masked, 0.0, err).max()) <= 1e-4
    assert float(torch.where(masked, err / rex.abs(), 0.0).max()) <= 1e-6
    assert float((logits[:, :nv].double() - ref_logits[:, :nv]).abs().max()) <= 1e-4
    assert float((loss.double() - ref).abs().max()) <= 1e-4
    assert float((dx.double() - x64.grad).abs().max()) <= 1e-6


def test_memory_loss_rejects_a_negative_row0(card):
    from reid_gan_torch.ops.cluster_memory import memory_loss

    state, y, x, ex = _k6_rank_inputs(card, 8, 64, 16, 10, 2, 1)
    with pytest.raises(ValueError, match="row0"):
        memory_loss(x, y, state, ex_f=ex, group_size=4, row0=-1)


@pytest.mark.parametrize("t", [0, 16])
def test_memory_loss_gives_the_same_bits_run_to_run(card, t):
    """K6 at the main path's shape (B 256, D 2048, 768 bank rows, 700 live),
    without and with 16 extra negatives, twice: loss, logits and dL/dx
    bit-equal (the D slices and the reduction slices are added in a fixed
    order, no atomics)."""
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss

    b, d, k_pad, nv = 256, 2048, 768, 700
    g = torch.Generator(device=card).manual_seed(66)
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device=card, generator=g), dim=1)
    state = init_memory(centers, k_pad=k_pad, device=card)
    y = torch.randint(0, nv, (b,), device=card, generator=g, dtype=torch.int32)
    x0 = centers[y.long()] + 0.05 * torch.randn((b, d), device=card, generator=g)
    ex = (centers[:t] + 0.05 * torch.randn((t, d), device=card, generator=g)
          if t else None)

    def run():
        x = x0.detach().requires_grad_(True)
        loss, logits = memory_loss(x, y, state, ex_f=ex, group_size=16)
        loss.mean().backward()
        return loss.detach(), logits, x.grad

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


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


def _k12_fp64(img, oh, ow):
    """The plain K12 in fp64 arithmetic on its fp32 weights: the exact value
    of the function the kernel computes. At 2x the weights are exact in
    fp32 but at the renormalised edges; at other scales the fp32 sample
    points alone move the fp64 function's outputs by up to 1.2e-5."""
    from reid_gan_torch.ops.transforms import IMAGENET_MEAN, IMAGENET_STD, cubic_resize_weights

    n, c, h, w = img.shape
    wh = cubic_resize_weights(h, oh, torch.float32, img.device).double()
    ww = cubic_resize_weights(w, ow, torch.float32, img.device).double()
    x = torch.einsum("nchw,hk->nckw", (img.double() + 1.0) / 2.0, wh)
    x = torch.einsum("nckw,wl->nckl", x, ww)
    stat = lambda v: torch.tensor(v, dtype=torch.float32, device=img.device).double().view(1, 3, 1, 1)  # noqa: E731
    return (x - stat(IMAGENET_MEAN)) / stat(IMAGENET_STD)


def _k12_check(card, n, h, w, oh, ow, seed):
    """K12 against the plain version and its fp64 arithmetic on the same
    weights at 5e-6, edge rows and columns (with -1/+1 swings) included;
    returns the input and the output."""
    from reid_gan_torch.ops.transforms import diff_transform, diff_transform_plain

    g = torch.Generator(device=card).manual_seed(seed)
    img = torch.tanh(2 * torch.randn((n, 3, h, w), device=card, generator=g))
    alt = (torch.arange(h, device=card)[:, None] + torch.arange(w, device=card)[None]) % 2
    alt = alt.float() * 2 - 1
    for rows in (slice(0, 2), slice(h - 2, h)):
        img[:, :, rows] = alt[rows]
    for cols in (slice(0, 2), slice(w - 2, w)):
        img[:, :, :, cols] = alt[:, cols]
    out = diff_transform(img, oh, ow)
    ref = diff_transform_plain(img, oh, ow)
    ref64 = _k12_fp64(img, oh, ow)
    torch.cuda.synchronize()
    assert out.shape == (n, 3, oh, ow) and out.stride() == ref.stride()
    assert float((out - ref).abs().max()) <= 5e-6
    err64 = (out.double() - ref64).abs()
    assert float(err64.max()) <= 5e-6
    edges = [0, 1, 2, -3, -2, -1]
    assert float(err64[:, :, edges].max()) <= 5e-6
    assert float(err64[:, :, :, edges].max()) <= 5e-6
    return img, out


@pytest.mark.parametrize("n,h,w,oh,ow", [
    (3, 50, 30, 256, 128),     # a non-2x upsample to the re-ID size
    (2, 13, 9, 37, 21),        # odd scales, OW off the 4-pixel unit
    (1, 7, 5, 7, 5),           # scale 1: one tap of weight 1
    (1, 128, 64, 256, 128),    # one image
    (32, 20, 12, 37, 24),      # bands of 4 rows, the last one partial
    (16, 51, 30, 102, 60),     # bands of 4, the last one of 2 rows
    (300, 5, 3, 37, 7),        # bands of 16, the last one of 5 rows; W off float4
    (1, 4, 3000, 8, 3100),     # tiles of output columns, past 48 KiB of shared memory
    (30, 40, 80, 160, 160),    # 4x by 2x; the staging rows and the window past 48 KiB
])
def test_diff_transform_off_2x_and_band_edges_match_plain(card, n, h, w, oh, ow):
    """K12 at other scales than 2x, one image, and batches whose band of
    output rows (4 or 16, the most that still gives every SM two blocks)
    does not divide OH, so the last band of each image is partial."""
    _k12_check(card, n, h, w, oh, ow, n + h + w)


@pytest.mark.parametrize("n,h,w,oh,ow", [(16, 128, 64, 256, 128), (2, 13, 9, 37, 21)])
def test_diff_transform_gives_the_same_bits_run_to_run(card, n, h, w, oh, ow):
    from reid_gan_torch.ops.transforms import diff_transform

    img, out = _k12_check(card, n, h, w, oh, ow, 7)
    again = diff_transform(img, oh, ow)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


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


def test_update_memory_joint_fold_with_padded_banks(card):
    """GAN-feature clustering's fold: a bank and a GAN bank of 700 live rows
    padded to 768 (``init_memory``), a P×K batch of 16 labels x 16 and the
    pooled GAN rows as ``gan_x``: one launch, both banks within 1e-6 and
    1e-5 of the plain fold, and the padding rows still zero."""
    from reid_gan_torch import kernels
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        update_memory,
        update_memory_plain,
    )

    b, d, nv, k_pad = 256, 2048, 700, 768
    g = torch.Generator(device=card).manual_seed(77)
    centers, gan = (torch.nn.functional.normalize(
        torch.randn((nv, d), device=card, generator=g), dim=1) for _ in range(2))
    state = init_memory(centers, k_pad=k_pad, gan_centroids=gan, device=card)
    x = torch.randn((b, d), device=card, generator=g)
    gan_x = torch.relu(torch.randn((b, d), device=card, generator=g)) / d ** 0.5
    y = torch.as_tensor([(i // 16) * 43 % nv for i in range(b)], dtype=torch.int32,
                        device=card)
    ref = state._replace(features=state.features.clone(),
                         gan_features=state.gan_features.clone())
    before = kernels.BANK_FOLD.launches["forward"]
    update_memory(state, x, y, gan_x=gan_x, group_size=16)
    assert kernels.BANK_FOLD.launches["forward"] == before + 1
    update_memory_plain(ref, x, y, gan_x=gan_x)
    torch.cuda.synchronize()
    assert float((state.features - ref.features).abs().max()) <= 1e-6
    assert float((state.gan_features - ref.gan_features).abs().max()) <= 1e-5
    assert not state.features[nv:].any() and not state.gan_features[nv:].any()
    assert not torch.equal(state.gan_features[:nv], gan)


@pytest.mark.parametrize("case", ["one_label", "all_distinct", "pxk", "hard_tie"])
def test_update_memory_matches_plain(card, case):
    """Plain fold (feature and GAN banks, in one launch) and hard fold
    against the plain version on copies of the same bank: within 1e-6 on
    unit rows."""
    from reid_gan_torch import kernels
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
    before = kernels.BANK_FOLD.launches["forward"]
    update_memory(state, x, y, use_hard=hard, gan_x=None if hard else x * 3)
    assert kernels.BANK_FOLD.launches["forward"] == before + 1
    update_memory_plain(ref, x, y, use_hard=hard, gan_x=None if hard else x * 3)
    torch.cuda.synchronize()
    assert float((state.features - ref.features).abs().max()) <= 1e-6
    assert float((state.gan_features - ref.gan_features).abs().max()) <= 1e-5
    touched = torch.unique(y.long())
    norms = state.features[touched].norm(dim=1)
    assert float((norms - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("d", [8, 2048, 4096])
def test_update_memory_streams_a_label_past_the_staging(card, d):
    """One label with 200 slots among others, more than the kernel stages at
    once at any D (the rows stream in two alternating halves), and labels
    outside the bank (-1 and K_pad + 5), which are skipped: against the
    plain fold of the in-range slots, both banks."""
    from reid_gan_torch.ops.cluster_memory import update_memory, update_memory_plain

    b, k_pad = 256, 300
    labels = [9 if i % 5 else (i * 7) % 40 for i in range(b)]
    labels[3], labels[100], labels[201] = -1, k_pad + 5, -1
    state, x, y = _fold_inputs(card, b, d, k_pad, labels, seed=d)
    ref = state._replace(features=state.features.clone(),
                         gan_features=state.gan_features.clone())
    update_memory(state, x, y, gan_x=x * 3)
    keep = (y >= 0) & (y < k_pad)
    update_memory_plain(ref, x[keep], y[keep], gan_x=x[keep] * 3)
    torch.cuda.synchronize()
    assert float((state.features - ref.features).abs().max()) <= 1e-6
    assert float((state.gan_features - ref.gan_features).abs().max()) <= 1e-5


@pytest.mark.parametrize("hard", [False, True])
def test_update_memory_gives_the_same_bits_run_to_run(card, hard):
    """Two folds of the same batch from copies of the same banks write the
    same bits (the sums are in a fixed order, no atomics)."""
    from reid_gan_torch.ops.cluster_memory import update_memory

    b, d, k_pad = 256, 2048, 300
    labels = [(i * 37) % 16 * 17 for i in range(b)]
    state, x, y = _fold_inputs(card, b, d, k_pad, labels, seed=5)
    other = state._replace(features=state.features.clone(),
                           gan_features=state.gan_features.clone())
    gan_x = None if hard else x * 3
    update_memory(state, x, y, use_hard=hard, gan_x=gan_x)
    update_memory(other, x, y, use_hard=hard, gan_x=gan_x)
    torch.cuda.synchronize()
    for u, v in ((state.features, other.features), (state.gan_features, other.gan_features)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))


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

def _knn_features(card, n, d, seed, ties=False, first_copy=0):
    """Unit rows from a seed; ``ties``: rounded to multiples of 2^-8, so every
    key is exact on both sides (see chip_smoke._train_features), and every
    row ``first_copy + 2 i + 1`` a copy of the row before it."""
    g = torch.Generator(device=card).manual_seed(seed)
    f = torch.nn.functional.normalize(torch.randn((n, d), device=card, generator=g), dim=1)
    if ties:
        f = torch.round(f * 256) / 256
        dst = f[first_copy + 1::2]
        dst.copy_(f[first_copy::2][:dst.shape[0]])
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
    (127, 64, 30, "l2", False),     # N about the 128-row tile: one tile,
    (128, 64, 30, "ip", False),     # one whole tile, a tile and a row,
    (129, 64, 30, "l2", False),     # three tiles (a mailbox step)
    (129, 2048, 64, "ip", False),
    (257, 64, 30, "ip", False),
    (257, 2048, 100, "l2", False),
    (1000, 12, 30, "l2", False),    # D a multiple of 4, not of 8
    (1000, 20, 30, "ip", False),
    (513, 132, 100, "l2", False),   # D off 8 with the lists in scratch
    (257, 16, 257, "ip", False),    # k = N over three tiles
    (640, 24, 640, "l2", False),    # k = N over five tiles: the pairs both ends compute
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


def test_knn_search_checks_k_bounds(card):
    """K8 serves every k from 1 to N (64, the register lists, and 65, the
    lists in scratch, launch); k above N and k below 1 raise."""
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


@pytest.mark.parametrize("n,k,metric", [(300, 30, "l2"), (300, 15, "ip"), (520, 100, "l2"),
                                        (520, 130, "ip")])
def test_knn_search_orders_ties_across_tiles(card, n, k, metric):
    """Exact duplicates on both sides of every tile boundary (rows 127 and
    128, 255 and 256, ...: every odd row copied to the even row after it), so
    a tie reaches a row through the transposed side of a tile pair, after
    the row's own tile: indices and values identical to the plain version,
    the lower index first."""
    from reid_gan_torch.ops.distance import knn_search, knn_search_plain

    f = _knn_features(card, n, 36, seed=n + k, ties=True, first_copy=1)
    assert torch.equal(f[127], f[128]) and torch.equal(f[255], f[256])
    vals, idx = knn_search(f, k, metric)
    pv, pi = knn_search_plain(f, k, metric)
    assert (idx == pi).all() and (vals == pv).all()
    assert list(idx[128, :2]) == [127, 128] and list(idx[127, :2]) == [127, 128]


def test_knn_search_gives_the_same_bits_run_to_run(card):
    """K8 at N 4,100 (33 tiles, 17 steps, mailboxes every step), D 2048 and
    k 128 (the lists in scratch), twice: the same values and indices bit for
    bit (the steps' order is fixed and no sum depends on timing)."""
    from reid_gan_torch.ops.distance import knn_topk_cuda

    f = _knn_features(card, 4100, 2048, seed=41)
    first, second = knn_topk_cuda(f, 128, "l2"), knn_topk_cuda(f, 128, "l2")
    torch.cuda.synchronize()
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
    assert torch.equal(first[1], second[1])


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


@pytest.mark.parametrize("n,k,h,w", [(3, 18, 128, 64), (1, 5, 7, 3), (33, 18, 16, 8),
                                     (3, 18, 9, 5), (3, 3, 3, 1100)])
def test_pose_maps_match_plain(card, n, k, h, w):
    """K10 at an odd batch and frames (W off the float4 with H x W odd; a row
    of more float4s than the block has threads): joints missing in y, in x
    and in both, one image with every joint missing (all-zero maps), joints
    at the frame's corners (a peak of 1 there); within 1e-6."""
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


@pytest.mark.parametrize("h,w", [(128, 64), (9, 5)])
def test_pose_maps_give_the_same_bits_run_to_run(card, h, w):
    """K10 twice on the same keypoints, on and off the float4 path: the same
    bits."""
    from reid_gan_torch.ops.pose import batch_cords_to_map

    g = torch.Generator(device=card).manual_seed(h + w)
    old = torch.tensor([[256.0, 128.0]], device=card).expand(16, 2).contiguous()
    cords = (torch.rand((16, 18, 2), device=card, generator=g) * old[:, None, :]).contiguous()
    cords[0, :3] = -1
    first, second = (batch_cords_to_map(cords, old, h, w) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


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


@pytest.mark.parametrize("n,c,h,w", [(256, 2048, 8, 8), (256, 2048, 8, 4),
                                     (136, 2048, 16, 8)])
def test_gan_feat_l2n_in_inference_mode_matches_plain(card, n, c, h, w):
    """K11 as the ``test_all`` extraction runs it, under
    ``torch.inference_mode()``: the variants' 8x8 and 8x4 maps and the
    short last batch of Market-1501's 12,936 train images at 16x8; the map
    within 1e-6 of the plain version and its spatial mean (the pooled GAN
    feature) within 1e-6."""
    from reid_gan_torch import kernels
    from reid_gan_torch.models.resnet import gan_feat, gan_feat_plain

    g = torch.Generator(device=card).manual_seed(n + h * w)
    with torch.inference_mode():
        x = torch.relu(torch.randn((n, c, h, w), device=card, generator=g)).contiguous(
            memory_format=torch.channels_last)
        before = kernels.GAN_FEAT_L2N.launches["forward"]
        out = gan_feat(x)
        assert kernels.GAN_FEAT_L2N.launches["forward"] == before + 1
        ref = gan_feat_plain(x)
        torch.cuda.synchronize()
        assert out.is_inference() and out.is_contiguous(memory_format=torch.channels_last)
        assert float((out - ref).abs().max()) <= 1e-6
        assert float((out.mean(dim=(2, 3)) - ref.mean(dim=(2, 3))).abs().max()) <= 1e-6


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

@pytest.mark.parametrize("case", ["drawn", "flip", "no_flip", "all_erased"])
@pytest.mark.parametrize("n,h,w", [(9, 256, 128), (1, 64, 32), (4, 7, 5), (5, 6, 8)])
def test_fd_augment_matches_plain(card, n, h, w, case):
    """K14 with the port's draws plus rectangles on the four borders and the
    whole frame, with every image flipped, none, or every image erased:
    within 1e-6 (IEEE divisions in the same order on both sides; the table
    holds the same quotients); channels_last float32; the same bytes on a
    second launch. Widths on (the float4 path) and off W % 4, one image."""
    from reid_gan_torch.ops.transforms import (
        FD_ERASE,
        FD_FLIP,
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
    _set_draws(p, case, FD_FLIP, FD_ERASE)
    out = fd_augment(img, p)
    ref = fd_augment_plain(img, p)
    torch.cuda.synchronize()
    assert out.shape == (n, 3, h, w) and out.is_contiguous(memory_format=torch.channels_last)
    assert float((out - ref).abs().max()) <= 1e-6
    again = fd_augment(img, p)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_fd_augment_rejects_bad_inputs(card):
    """The wrapper's checks, and the C entry's size check (an empty batch) as
    a ValueError."""
    from reid_gan_torch.ops.transforms import fd_augment

    img = torch.zeros((2, 8, 4, 3), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="params"):
        fd_augment(img, torch.zeros((2, 10), device=card))
    with pytest.raises(ValueError, match="uint8"):
        fd_augment(img.float(), torch.zeros((2, 9), device=card))
    with pytest.raises(ValueError, match="reid_fd_augment"):
        fd_augment(img[:0], torch.zeros((0, 9), device=card))


@pytest.mark.parametrize("n", [8, 5])
def test_pose_ae_step_with_k9_k10_matches_plain(card, n):
    """One standalone step of the PoseAE engine (ngf 8, img_f 32, at 32x16)
    on uint8 GAN images through K9 and pose maps through K10, against the
    same step from the same weights through K9's and K10's plain versions,
    cuDNN's TF32 off: the G and D losses within 1e-4 relative, the fake
    within 1e-4, G's output conv gradient within 1e-3 relative."""
    import copy

    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.ops.pose import batch_cords_to_map, batch_cords_to_map_plain
    from reid_gan_torch.ops.transforms import gan_input_transform_plain

    torch.manual_seed(n)
    gan = AEModel(GANConfig(model="AE", model_gen="PoseAE"), gan_height=32, gan_width=16,
                  num_feats=32, ngf=8, device=card)
    g = torch.Generator(device=card).manual_seed(n)
    xs = torch.randint(0, 256, (n, 32, 16, 3), dtype=torch.uint8, device=card, generator=g)
    old = torch.tensor([[256.0, 128.0]], device=card).expand(n, 2).contiguous()
    cords = (torch.rand((n, 18, 2), device=card, generator=g) * old[:, None, :]).contiguous()
    cords[0, :4] = -1
    snap = [copy.deepcopy(m.state_dict()) for m in (gan.net_G, gan.net_D)]
    tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    out = []
    try:
        for plain in (False, True):
            for m, sd in zip((gan.net_G, gan.net_D), snap):
                m.load_state_dict(sd)
            state = gan.init_state()
            if plain:
                ps = batch_cords_to_map_plain(cords, old, 32, 16)
                _, errs, fake = gan.step(state, gan_input_transform_plain(xs), pose=ps)
            else:
                ps = batch_cords_to_map(cords, old, 32, 16)
                _, errs, fake = gan.optimize_parameters(state, xs, pose=ps)
            out.append((float(errs["G"]), float(errs["D"]), fake,
                        gan.net_G.decoder.outconv.conv1.conv.weight.grad.clone()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (gk, dk, fk, wk), (gp, dp, fp, wp) = out
    assert abs(gk - gp) <= 1e-4 * abs(gp) and abs(dk - dp) <= 1e-4 * abs(dp)
    assert float((fk - fp).abs().max()) <= 1e-4
    assert float((wk - wp).abs().max()) <= 1e-3 * float(wp.abs().max())


@pytest.mark.parametrize("n,h,w", [(4, 32, 16), (3, 128, 64)])
def test_vgg_loss_on_the_card_matches_the_cpu(card, n, h, w):
    """``VGGLoss`` on the card (fp32, TF32 off) against the same weights and
    inputs on the CPU: every tap the loss reads within 1e-4 of its largest
    value, content within 1e-4 relative, style (a mean |Δ| of Gram
    matrices that nearly cancel on random taps) within 1e-4 of the Gram
    entries it subtracts, and the input gradient of content + style within
    1e-3 of its norm (a ReLU whose input is near 0 may switch between the
    two sides); the weights get no gradient."""
    from reid_gan_torch.models.dual_gan.external_function import VGGLoss, compute_gram

    torch.manual_seed(h)
    cpu = VGGLoss()
    dev = VGGLoss(cpu.model.state_dict()).to(card)
    x = torch.tanh(torch.randn(n, 3, h, w))
    y = torch.tanh(torch.randn(n, 3, h, w))
    tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    out = []
    try:
        for loss, d in ((cpu, "cpu"), (dev, card)):
            xt = x.to(d).detach().requires_grad_(True)
            content, style = loss(xt, y.to(d))
            (content + style).backward()
            with torch.no_grad():
                taps = {k: v.cpu() for k, v in loss.model(x.to(d), loss.last).items()}
            out.append((content.item(), style.item(), xt.grad.cpu(), taps))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cc, sc, gc, tc), (cd, sd, gd, td) = out
    e_tap = max(float((td[k] - tc[k]).abs().max() / tc[k].abs().max()) for k in tc)
    gram = np.mean([float(compute_gram(tc[k]).abs().mean()) for k in VGGLoss.STYLE])
    e_grad = float((gd - gc).norm() / gc.norm())
    msg = (f"taps {e_tap:.3g}, content {abs(cd - cc) / abs(cc):.3g}, style {abs(sd - sc):.3g} "
           f"of Gram entries {gram:.3g}, gradient {e_grad:.3g}")
    print(f"[vgg card vs cpu] n {n} {h}x{w}: {msg}")
    assert e_tap <= 1e-4 and abs(cd - cc) <= 1e-4 * abs(cc), msg
    assert abs(sd - sc) <= 1e-4 * gram and e_grad <= 1e-3, msg
    assert all(p.grad is None for p in dev.parameters())


def test_msgpack_round_trip_of_a_cuda_model(card, tmp_path):
    """A resnet18 on the card (random BatchNorm stats, GeM p 3.2) written in
    the JAX package's flax msgpack layout and resumed into a fresh model on
    the card: every state-dict entry and the extracted features (K1, K2)
    bit-equal."""
    from reid_gan_torch.engine.evaluators import FeatureExtractor
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.utils.serialization import resume_checkpoint, save_msgpack_checkpoint

    torch.manual_seed(0)
    src = create("resnet18").to(card).eval()
    with torch.no_grad():
        src.gap.p.fill_(3.2)
        for name, b in src.named_buffers():
            if "running" in name:
                b.uniform_(0.5, 1.5)
    path = str(tmp_path / "model_best.msgpack")
    save_msgpack_checkpoint(dict(flax_variables_from_model(src), epoch=np.asarray(3),
                                 best_mAP=np.asarray(0.5)), False, path)
    dst = create("resnet18").to(card).eval()
    assert resume_checkpoint(path, dst) == (3, 0.5)
    for k, v in src.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, dst.state_dict()[k]), k
    img = np.random.RandomState(0).randint(0, 256, (4, 64, 32, 3)).astype(np.uint8)
    feats = [FeatureExtractor(m, height=64, width=32, batch_size=4, device=card)(img)
             for m in (src, dst)]
    assert np.array_equal(*feats)


@pytest.mark.parametrize("use_hard", [False, True])
def test_fp16_usl_step_holds_kernels_against_plain(card, use_hard):
    """One ``--fp16`` USL step (resnet18 computing in bf16 at 64x32, batch 32
    = 8 ids x 4): K4 against its plain version on the uint8 batch (within
    1e-5); the bf16 backbone then runs once on K4's image, and the train
    head (K5), InfoNCE (K6) and the fold (K7) take that one map on both
    sides, cuDNN's TF32 off: the loss within 1e-3 relative, the map's
    gradient within 1e-3 of its largest entry, GeM p's gradient within 1e-3
    relative, the folded bank within 1e-4; the parameters and their
    gradients fp32. (A whole bf16 step moves by a bf16 rounding wherever its
    input moves by an ulp, so the backbone is shared.)"""
    import copy

    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models import create
    from reid_gan_torch.models.pooling import gem_pool_plain, l2n
    from reid_gan_torch.models.resnet import ResNetBackbone
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        memory_loss,
        memory_loss_plain,
        update_memory,
        update_memory_plain,
    )
    from reid_gan_torch.ops.transforms import (
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    torch.manual_seed(1)
    model = create("resnet18", norm=True, dtype=torch.bfloat16)
    trainer = ClusterContrastTrainer(model, height=64, width=32, num_instances=4,
                                     use_hard=use_hard, device=card)
    g = torch.Generator(device=card).manual_seed(2)
    centers = torch.nn.functional.normalize(torch.randn((8, 512), device=card, generator=g),
                                            dim=1)
    state = trainer.init_state(init_memory(centers, k_pad=64, device=card))
    img = torch.randint(0, 256, (32, 64, 32, 3), dtype=torch.uint8, device=card, generator=g)
    y = torch.arange(8, device=card, dtype=torch.int32).repeat_interleave(4)
    params = sample_augment_params(32, 64, 32, g)
    x = train_augment(img, params, 64, 32)
    assert float((x - train_augment_plain(img, params)).abs().max()) <= 1e-5
    snap = copy.deepcopy(model.state_dict())
    tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    out = []
    try:
        model.train()
        fmap = ResNetBackbone.forward(model, x)
        assert fmap.dtype == torch.float32
        for plain in (False, True):
            model.load_state_dict(snap)
            fm = fmap.detach().clone().requires_grad_()
            mem = state.memory._replace(features=state.memory.features.clone())
            if plain:
                feat = l2n(model.feat_bn(gem_pool_plain(fm, model.gap.p)))
            else:
                feat = model._train_head(fm)
            loss = (memory_loss_plain if plain else memory_loss)(feat, y, mem)[0].mean()
            model.zero_grad(set_to_none=True)
            loss.backward()
            (update_memory_plain if plain else update_memory)(mem, feat.detach(), y,
                                                              use_hard=use_hard)
            out.append((float(loss.detach()), fm.grad, model.gap.p.grad.clone(),
                        mem.features))
        model.zero_grad(set_to_none=True)
        ResNetBackbone.forward(model, x).sum().backward()
        assert all(q.grad.dtype == torch.float32 for q in model.parameters()
                   if q.grad is not None)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lk, fk, pk, bk), (lp, fp, pp, bp) = out
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    assert float((fk - fp).abs().max()) <= 1e-3 * float(fp.abs().max())
    assert float((pk - pp).norm()) <= 1e-3 * float(pp.norm())
    assert float((bk - bp).abs().max()) <= 1e-4
    assert all(q.dtype == torch.float32 for q in model.parameters())


BF16_FACTOR = 2.0   # test_torch_port_fp16.FACTOR


def _bf16_case(kind):
    """(nets, inputs, forward) of a ``--fp16`` case with random weights:
    resnet18 (train forward, ``feat`` and ``gan_feat``) at 64x32, batch 8;
    or the pose G (ngf 8) and D at 16x8, batch 8, D scoring G's image."""
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.networks import define_D, define_G

    torch.manual_seed(3)
    rng = np.random.RandomState(4)
    if kind == "resnet18":
        nets = (create("resnet18", norm=True),)
        x = (rng.rand(8, 3, 64, 32) * 2 - 1,)

        def forward(nets, x):
            out = nets[0](*x)
            return out["feat"], out["gan_feat"]
    else:
        nets = (define_G("Pose", pose_nc=18, ngf=8, img_f=32, reid_nc=512, num_blocks=1),
                define_D())
        x = (rng.rand(8, 512, 2, 1), rng.rand(8, 18, 16, 8))

        def forward(nets, x):
            fake = nets[0](*x)
            return fake, nets[1](fake)
    return nets, tuple(torch.from_numpy(a.astype(np.float32)) for a in x), forward


def _bf16_step(case, dtype, device):
    """One forward in train mode and the gradients of a fixed random linear
    function of its outputs, on channels_last copies of the case's nets
    computing in ``dtype`` on ``device``: (outputs, gradients), on the CPU
    in fp32."""
    import copy

    from reid_gan_torch.models.precision import set_compute_dtype

    nets, x, forward = case
    cl = torch.channels_last   # as the trainers hold the nets and their inputs
    nets = [set_compute_dtype(copy.deepcopy(n), dtype).to(device, memory_format=cl).train()
            for n in nets]
    outs = forward(nets, [t.to(device).contiguous(memory_format=cl) for t in x])
    g = torch.Generator().manual_seed(5)
    weights = [torch.randn(o.shape, generator=g).to(device) for o in outs]
    sum((o * w).sum() for o, w in zip(outs, weights)).backward()
    assert all(q.dtype == torch.float32 for n in nets for q in n.parameters())
    return ([o.detach().cpu() for o in outs],
            {f"{i}.{k}": q.grad.cpu().double() for i, n in enumerate(nets)
             for k, q in n.named_parameters() if q.grad is not None})


def _tree_gap(a, b):
    num = sum(float((a[k] - b[k]).pow(2).sum()) for k in b)
    return (num / sum(float(v.pow(2).sum()) for v in b.values())) ** 0.5


@pytest.mark.parametrize("kind", ["resnet18", "pose"])
def test_bf16_on_the_card_matches_the_cpu_path(card, kind):
    """``--fp16`` on the card (cuDNN and cuBLAS in bf16) against the CPU
    path the JAX parity tests hold (fp32 products of the bf16-rounded
    operands, rounded once to bf16), same weights and inputs: each output,
    fp32 on both, within ``BF16_FACTOR`` times the CPU path's own gap to
    its fp32 run (max |.|); the gradients of one step (relative L2 over the
    tree, the same key set) within that factor times the CPU path's gap,
    and under 0.5 (a zero tree reads 1)."""
    case = _bf16_case(kind)
    ref_out, ref_grad = _bf16_step(case, None, "cpu")
    cpu_out, cpu_grad = _bf16_step(case, torch.bfloat16, "cpu")
    got_out, got_grad = _bf16_step(case, torch.bfloat16, card)
    for i, (got, cpu, ref) in enumerate(zip(got_out, cpu_out, ref_out)):
        assert got.dtype == cpu.dtype == torch.float32, (i, got.dtype)
        own = float((cpu - ref).abs().max())
        gap = float((got - cpu).abs().max())
        assert 0 < own and gap <= BF16_FACTOR * own, \
            f"{kind} output {i}: card - cpu {gap:.3g}, cpu bf16 - fp32 {own:.3g}"
    assert sorted(got_grad) == sorted(cpu_grad) == sorted(ref_grad)
    own, gap = _tree_gap(cpu_grad, ref_grad), _tree_gap(got_grad, cpu_grad)
    assert 0 < own and gap <= min(BF16_FACTOR * own, 0.5), \
        f"{kind} gradients: card - cpu {gap:.3g}, cpu bf16 - fp32 {own:.3g}"


@pytest.mark.parametrize("shape,channels_last", [((1, 7, 5, 3), True),
                                                 ((1, 33, 4, 2), False)])
def test_global_batch_norm_plain_matches_sync_batch_norm(card, tmp_path, shape,
                                                         channels_last):
    """``GlobalBatchNorm`` in train mode on the card (all-reduces of [Σx, n]
    and Σ(x − mean)² over an NCCL mesh of one rank, a ``file://`` store)
    against torch's ``SyncBatchNorm`` on the same CUDA tensor, with an odd channel
    count and one image a rank: the output and the input's and parameters'
    gradients within 1e-5 of their largest value, the running stats within
    1e-6 relative; in eval mode, the BatchNorm of the running stats."""
    from reid_gan_torch.ops.norm import GlobalBatchNorm
    from reid_gan_torch.parallel import destroy_mesh, get_mesh

    mesh = get_mesh(1, 0, init_method=f"file://{tmp_path}/store")
    try:
        g = torch.Generator(device=card).manual_seed(5)
        c = shape[1]
        x = torch.randn(shape, device=card, generator=g) * 3.0 + 2.0
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        dy = torch.randn(shape, device=card, generator=g)
        bn = GlobalBatchNorm(c).to(card).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0, 0.1, generator=g)
        ref_bn = torch.nn.SyncBatchNorm(c).to(card).train()
        ref_bn.load_state_dict(bn.state_dict())
        xs, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        ys = bn(xs)
        (ys * dy).sum().backward()
        yp = ref_bn(xp)
        (yp * dy).sum().backward()
        for got, ref in ((ys, yp), (xs.grad, xp.grad), (bn.weight.grad, ref_bn.weight.grad),
                         (bn.bias.grad, ref_bn.bias.grad)):
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        torch.testing.assert_close(bn.running_mean, ref_bn.running_mean, rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(bn.running_var, ref_bn.running_var, rtol=1e-6,
                                   atol=1e-7)
        bn.eval()
        rm, rv = bn.running_mean, bn.running_var
        with torch.no_grad():
            ref = (x - rm[:, None, None]) * torch.rsqrt(rv[:, None, None] + bn.eps) \
                * bn.weight[:, None, None] + bn.bias[:, None, None]
            torch.testing.assert_close(bn(x), ref, rtol=1e-5, atol=1e-5)
    finally:
        destroy_mesh()
