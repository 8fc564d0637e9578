"""On-card smoke run of the PyTorch/CUDA port (``reid_gan_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU
    python3 chip_smoke.py --kernels K4,K14 ROOT   # the named kernels alone, of the
                                                  # package under ROOT
    python3 chip_smoke.py --k5-k6 ROOT   # the same as --kernels K5,K6 ROOT

Phases, each ended by ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without printing a result:

1. the card's name and power limit (``nvidia-smi``) and the kernel build
   (``nvcc`` for sm_90a from ``reid_gan_torch/csrc``, one process per
   source; ptxas report), with ``g++`` building the host C++ library of
   ``reid_gan_torch/native`` at the same time, then the import of
   ``scipy.sparse`` that the Jaccard step needs;
2. every kernel against its plain PyTorch version at the main paths'
   shapes, with max error, tolerance, the kernel's and the plain version's
   device time, and the bound: K1 ``eval_transform`` at batch 256 of
   256x128, to bf16 and to fp32, each timed beside its own bound, every
   (channel, byte) value bit-equal to the float32 IEEE formula (bf16: its
   rounding to nearest even) and the same bits on a second launch; K2
   ``gem_bn_l2n`` at the extraction batch (256, 2048, 16, 8) and the
   hard-mix re-encode's (16, 2048, 16, 8), the latter timed in L2
   and after a flush of the L2, each with a digest and the same bits on a
   second launch; K3 ``rank_stats`` at Market-1501's eval shape
   (3,368 queries x 15,913 gallery, 751 ids, 6 cameras, 2048-d, in chunks
   of 1,024 and a short last one), once more with exact ties, each with a
   digest of AP, first bins and match counts and the same bits on a second
   launch, and at MSMT17's (a 1,024-query chunk x 82,161 gallery, 3,060
   ids, 15 cameras); K4 ``train_augment`` at 256 x 256x128 (once more with
   the erase flags zeroed, and the same bits on a second launch); K5 ``gem_pool``
   forward and backward (d map and dp) at (256, 2048, 16, 8); K6
   ``infonce`` forward and backward at B 256 x D 2048 against banks of 768
   rows (700 live) and 30,720 rows (30,000 live) (K5's and K6's forward and
   backward timed apart through their autograd functions, each beside its
   bound share; K6's bound takes its products at the 3xTF32 rate of the
   tensor cores, and K6 stands beside cuBLAS's two fp32 products); K7
   ``bank_fold``, plain and hard, on a 16 x 16 P×K batch, the joint fold of
   the feature and GAN banks in one launch, and one label 256 deep (each
   run twice for the same bits; the main run checks the joint fold's one
   launch); K8 ``knn_topk`` at Market-1501's train shape (12,936 x 2048),
   L2 with k 30 and inner product with k 15, once more with exact ties,
   and timed alone at MSMT17's 32,621 rows (its bound
   both at the 3xTF32 rate of the tensor cores and as fp32 FMA, beside the
   fp32 ``torch.matmul`` of the whole product as context, and its scratch
   bytes); K9 ``gan_input`` at 256 x 128x64; K10 ``pose_maps`` at (256, 18,
   128, 64) with missing joints, an image without joints and joints on the
   frame's corners (the same bits on a second launch); K11 ``gan_feat_l2n`` at (256, 2048, 16, 8), beside
   ``F.normalize`` as its library time; K6 once more with the hard-mix
   step's 16 extra negatives (groups of 16) against the 768-row bank (a
   digest of its outputs), and on the last rank's 64 rows of a mesh of four
   from ``row0`` 192, each row masked for its global group; K12
   ``diff_transform`` at (16, 3, 128, 64) -> 256x128, one image of -1/+1
   extremes so the renormalised edge taps see full swings, against the
   plain version and its fp64 arithmetic, edge rows and columns apart, and
   the same bits on a second launch (K1 and K12 also time their wrappers'
   host cost a call); K3's all-shots rows and separate camera set at
   Market-1501's eval shape (a 1,024-query chunk, distinct and with exact
   ties; a digest of the outputs and rows); K8 above its register lists (k 65,
   128, 256 and 300 at 2,048 rows, L2 and inner product, with exact ties)
   and k 128 timed at 12,936 rows; K13 ``pose_peaks`` at (512, 18, 256,
   128) with σ 4, 5 and 6, erased channels, missing and corner joints and
   flips; K14 ``fd_augment`` at 512 x 256x128 (the same bits on a second
   launch). K1's (each dtype), K4's, K10's, K12's and K14's lines carry a
   digest of the output bits, so that a commit and its parent, run in turns
   by ``--kernels``, show equal bits;
3. the eval main path: ``Evaluator(FeatureExtractor(resnet50)).evaluate``
   (the call ``cli/test.py`` makes) on an in-memory uint8 eval set made with
   numpy from a seed (1,024 queries + 3,072 gallery, 256x128, batch 256;
   random ResNet-50 with GeM and last stride 1). Launch counts are zeroed
   just before and read just after; K1-K3 must have launched. Then a warm
   extraction pass is timed, another is traced with ``torch.profiler``
   (device time by kernel, idle share), one batch of features is held
   against the same model through the plain versions, and the rank metrics
   against the plain rank pass;
4. the train main path: ``ClusterContrastTrainer(resnet50).train`` for 20
   steps of batch 256 (16 ids x 16 instances, 256x128) drawn by the P×K
   sampler from an in-memory pseudo-labelled set of 700 ids x 18 images,
   against a bank of 700 unit rows padded to 768. Launch counts are zeroed
   just before and read just after; K4-K7, and K5's and K6's backward, must
   have launched once per step. The loss must be finite, every parameter
   must have moved and the bank's rows must be unit vectors. One more step
   is held against the same step composed from the plain versions (loss,
   the ``feat`` gradient, the folded bank); then 10 warm steps are timed
   and 3 more traced with ``torch.profiler``;
5. the whole USL loop: one epoch of ``cli/train_usl.run`` on an in-memory
   set of Market-1501's train size (12,936 images of 751 ids, two colour
   blocks an id) and the eval set of phase 3, with the recipe's clustering
   (eps 0.4, min_samples 4, k1 30, k2 6) and 20 steps instead of 400.
   Launch counts are zeroed just before and read just after: K1, K2 once a
   batch of the clustering extraction and of both evals, K8 once, K4-K7
   once a step, K3 once an eval. It needs at least 16 clusters and half the
   images labelled, and prints the epoch's time split; then the labels of
   the features run() clustered, taken through the exact (fp64) kNN, must
   match the labels run() made through K8 (under 1% of the points moved
   where the two kNN tables differ; the plain fp32 kNN's labels are printed
   beside them), and Infomap runs once on K8's inner-product graph;
6. ``[ibn_main]``: phase 3 with the headline recipe's encoder,
   ``resnet_ibn50a`` (IBN-a in stages 1-3): K1-K3 must launch; its warm
   extraction rate beside phase 3's ``resnet50`` rate of the same call; the
   trace with the concatenation and copy kernels as groups of their own and
   the device time under ``aten::instance_norm`` and ``aten::cat``; the IBN
   splits timed alone at the batch's shapes against ``BatchNorm2d`` at the
   same places; one batch of features held against the plain K1/K2 path;
7. ``[ibn_train]``: phase 4 with ``resnet_ibn50a`` and K7's hard fold
   (``--use-hard``): K4-K7 once a step, one step held against the plain
   versions with the hard fold, 10 warm steps timed with the peak memory, 3
   traced as in ``[ibn_main]``, the IBN splits forward and backward against
   ``BatchNorm2d`` as a share of the step's busy time;
8. ``[ibn_usl]``: phase 5 with the headline recipe's flags (``--arch
   resnet_ibn50a --use-hard --eps 0.4 --k1 30 --k2 6``, batch 256 of 16
   instances, 20 steps): the same launch counts, labels check and epoch
   split;
9. ``[variants]``: K5 (forward and backward) and K2 at the variants' maps,
   8x8 and 8x4, and K5 on the halves of a channels_last 16x8 map through
   ``part_map``, each against its plain version and timed; then
   ``resnet_bip50``, ``resnet_bipd50`` and ``resnet_mp50`` (``sum`` fusion,
   and once more with the predictor) at full width: one eval batch of 256
   at 256x128 held against the plain heads (K2 twice, once, K5 three
   times), 3 USL steps of batch 256 on phase 4's set (K5 forward and
   backward 2, 1 and 3 times a step, K4, K6, K7 once; a finite loss; every
   parameter moved but a zero one the loss does not reach), the peak
   memory and 3 warm steps timed;
10. the joint main path: ``ClusterContrastWithGANTrainer.run_epoch`` in
   ``train_all`` mode at the recipe's width (a random ResNet-50, norm on, at
   256x128; the pose generator and the discriminator at 128x64; seed 0) for
   20 steps of batch 256 on phase 4's set with keypoints from a seed (a
   keypoint CSV) and GAN images at 128x64. One step is first held against
   the same step through the plain versions (losses, the ``feat``, a G and
   a D gradient, the folded bank). Launch counts are zeroed just before the
   20 steps and read just after: K4-K7 (K5's and K6's backward too) and
   K9-K11 once a step. Every encoder, G and D parameter must have moved, G's
   running stats and D's ``u`` changed, the losses finite; then the peak
   device memory, 10 warm steps timed, 3 traced with the profiler and split
   into the step's phases by CUDA events;
11. the AE hard-mix main path: ``ClusterContrastWithGANTrainer.run_epoch``
   in ``train`` mode at the recipe's width (a random ResNet-50, norm on, at
   256x128; the AE generator, ngf 64, img_f 256, 3 layers, 3 blocks, and
   the discriminator at 128x64; seed 0) for 20 steps of batch 256 on phase
   4's set with GAN images at 128x64. One step is first held against the
   same step through the plain versions (loss, three encoder gradients,
   the folded bank, G's running stats). Launch counts are zeroed just
   before the 20 steps and read just after: K2, K4-K7 (K5's and K6's
   backward too), K9 and K12 once a step, K10 and K11 never. Every encoder
   parameter must have moved, G's running stats all changed, G's
   parameters and D unchanged; then peak memory, 10 warm steps timed, 3
   traced and split into the step's phases by CUDA events;
12. the GAN warm-up's main path: ``GANTrainer.train_gan`` with the AE
   generator and the discriminator at 128x64 for 20 iterations of batch 256
   on an ``only_gan`` loader of phase 4's GAN images. One step is first
   held against the same step through K9's plain version. Launch counts are
   zeroed just before and read just after: K9 once an iteration, nothing
   else. Then peak memory, 10 warm iterations timed, 3 traced;
13. the whole joint loop: one epoch of ``cli/train_gan_usl.run`` on phase
   5's set with keypoints, Infomap (eps 0.5, k1 15) and 20 steps. Launch
   counts are zeroed just before and read just after: K1-K11 must all have
   launched, K12-K14 not. It writes the checkpoints and the GAN nets' files, and
   prints the epoch's split;
14. the whole hard-mix loop: ``cli/train_gan_warmup.run`` for 4 iterations
   (1 epoch, ``--debug``) writes the nets, then one epoch of
   ``cli/train_gan_usl.run`` with ``--model-gen AE --no-gan-train
   --continue-train`` loads them and runs on phase 5's set with the DBSCAN
   recipe and 20 steps. Launch counts are zeroed just before the epoch and
   read just after: K1-K9 and K12 must have launched, K10, K11, K13 and
   K14 not; then ``[gan_clusters]`` (two epochs of ``cli/train_gan_usl.run
   --cluster-with-gan-features``, one extraction batch and one step with
   both banks held against the plain versions);
14a. ``[vgg_joint]``: phase 10's step with ``--use-vgg`` (VGG19 on the 256
   fakes and GAN images at 128x64, random taps from seed 0) held against
   the plain versions, the content and style terms too; 5 warm steps
   without and with VGG in turns, each with its peak memory; 3 steps traced
   with and 3 without VGG (VGG's share of the busy time) and split by CUDA
   events; one epoch of ``cli/train_gan_usl.run --use-vgg`` at phase 13's
   configuration, and a 4-step one with ``--vgg-weights`` pointing at a
   torchvision-layout file of those taps, which the engine must hold. Both
   epochs' launches are counted as phase 13's and join the kernels line;
14a'. ``[bip_joint]`` and ``[memory_joint]``: the ``train_all_bip`` step
   (``resnet_bip50`` and the AE generator, ``--bipath``) and the
   ``train_all_with_memory`` step (ResNet-50 and the pose generator with
   trainable clusters, ``--learnable-memory``) at phase 10's width. One
   step each is run twice from the same state, through the kernels and
   through their plain versions (TF32 off), and held: each K6 call (two in
   bip, against one bank; one in memory, against the normalised clusters),
   the G and D losses, the encoder's GeM p and head gradients, a G and a D
   gradient, the bank after K7 or the clusters after their step; the
   step's launches (K7 none in memory); bip's K7 plain and hard on the
   step's own ``feat + feat2`` rows; memory's clusters moved on the touched
   rows only, each by ``cluster_lr``. Then 10 warm steps timed beside phase
   10's step and the peak memory, 3 traced through the port's
   ``utils/profiling.trace`` (the idle share) and split by CUDA events, and
   one epoch of ``cli/train_gan_usl.run`` with the mode's flag (10 steps,
   phase 13's set and clustering; G, D and ``iter.txt`` written), whose
   launches join the kernels line;
14a''. ``[ddp]``: the data mesh (``reid_gan_torch/parallel``) over
   ``min(4, cards)`` ranks, NCCL: one rank in this process with a
   ``file://`` store on one card, else one spawned process a card. The
   world size and backend; ``ops/norm.py``'s global BatchNorm on a CUDA
   tensor (one ResNet-50 layer's map, 64 channels at 128x64, the rank's
   share of 256 images) against torch's ``SyncBatchNorm`` (output, running
   stats, input gradient); one USL step (phase 4's ResNet-50, bank and
   batch of 256) under the mesh held against the same step without it, TF32
   off (loss; the gradient all-reduce against the fp64 mean of the ranks'
   own gradients; each parameter's gradient; bank; running stats), then
   warm steps with and without the mesh in turns; a sharded
   ``Evaluator.evaluate`` of phase 3's eval set held against the unsharded
   one (CMC, mAP); the hard-mix ``train``, ``train_all_bip`` and
   ``train_all_with_memory`` steps (``[joint]``'s nets: ResNet-50 or
   ``resnet_bip50``, the AE or pose generator and D at 128x64, batch 256)
   and the warm-up's ``GANTrainer.train_gan`` iteration under the mesh, each
   held against the same step without it, TF32 off (the losses; the
   gradient all-reduces against the fp64 mean of the ranks' own gradients;
   the memory mode's clusters, bit-equal on every rank), then warm steps
   with and without the mesh in turns; then, each with launch counts
   zeroed just before and read just after, a 2-step ``cli/train_usl.run``
   (K1-K8), 2-step epochs of ``cli/train_gan_usl.run`` in ``train_all``
   (K1-K11), ``--no-gan-train`` (K1-K9, K12), ``--bipath`` (K1-K9) and
   ``--learnable-memory`` (K1-K6, K8-K10) under the mesh on a smaller
   two-colour set (2,048 train images of 128 ids, 256 + 768 eval,
   Infomap), and 2 iterations of ``cli/train_gan_warmup.run`` (K9); their
   launches join the kernels line. Besides these, the bf16 (``--fp16``)
   USL step and the bf16 ``train_all`` step under the mesh held against the
   same steps without it, then warm in turns; FD-GAN's stage-I Siamese step
   (ResNet-50, 256 pairs) and one ``FDGANModel`` step of stage II and of
   stage III at full width (256 pairs; E, Di ResNet-50 at 256x128, G, Dp)
   under the mesh, each held against the same step without it, TF32 off and
   cuDNN deterministic (the losses, the ranks' means; the gradient
   all-reduces against the fp64 mean of the ranks' own; each gradient;
   the train-mode nets' running stats), then warm in turns; the sharded
   ``CascadeEvaluator`` against the unsharded one on phase 3's eval set;
   ``cli/test.run --dsbn`` (target and source domains) under the mesh
   against the run without it; and, counted as the ``run()`` epochs are, a
   2-step ``cli/fdgan_baseline.run`` (K1, K3, K14), then 2-step
   ``cli/fdgan_train.run`` of stage 1 (K13, K14) and stage 2 (K1, K3,
   K13, K14), each from the one before;
14b. ``[vgg_warmup]``: phase 12's ``GANTrainer.train_gan`` with ``--use-vgg``:
   20 iterations (K9 once an iteration, nothing else), the peak memory, 5
   warm iterations without and with VGG in turns;
14c. ``[dptn]``: ``DPTNModel`` at full width (ngf 64, num_feats 256, 3
   layers, 3 blocks, 2 CABs and 2 TTBs, 128x64, batch 256), source and
   target images through K9 and their pose maps through K10: 3 steps and
   one with VGG, each timed with the peak memory and finite losses, then
   ``synthesize_pair``;
14d. ``[generators]``: train-mode forwards at batch 256 of ``DECGenerator1``
   on a random ResNet-50's GAN map (K1, K11), ``FDGenerator`` on the pooled
   map and 512-wide noise and the pose generator with instance norm (cold
   and warm times, finite); one standalone ``PoseAE`` step through K9 and
   K10 held against their plain versions as phase 12's step, then 3 timed
   with the peak memory;
14e. ``[fp16]``: ``--fp16`` (bf16 compute as the JAX package's
   ``dtype=jnp.bfloat16``: bf16 convolutions and dense layers, fp32 norms,
   heads, parameters and optimiser state) at the recipe's width: the USL
   step (phase 4's ResNet-50), the joint ``train_all`` step (phase 10's
   nets) and the warm-up step (phase 12's), each step's kernels held
   against their plain versions on the step's own tensors (the bf16
   backbone run once; a whole bf16 step moves by a bf16 rounding wherever
   an input moves by an ulp) and launching once a step (10 steps each), with
   warm steps in bf16 and fp32 in turns on the same weights and their
   peaks, and the bf16 USL step traced (convolutions, BatchNorm,
   elementwise, the casts as a group of their own) beside the fp32 step;
   then one epoch of ``cli/train_usl.run --fp16`` (``[fp16_usl]``, phase
   5's set and launch counts, which join the kernels line) and phase 3's
   extraction with the bf16 backbone (``[fp16_main]``);
14f. ``[msgpack]``: a full-width ResNet-50 written in the JAX package's
   flax msgpack layout by the port's writer, and a DSBN checkpoint whose
   source and target BatchNorm stats differ; ``cli/test.run`` with
   ``--resume``, ``--dsbn`` and ``--dsbn --test-source`` on phase 3's eval
   set, each held against the model in memory (batch 0's features
   bit-equal, CMC and mAP equal; the target domain apart); the host seconds
   to read the file; then ``cli/train_gan_usl.run --continue-train`` from
   per-net ``latest_net_{G,D}.msgpack`` files for 2 joint steps, the loaded
   nets bit-equal to those written. Its launches join the kernels line;
15. FD-GAN stage I (``[fd_stage1]``): ``SiameseTrainer`` on a random
   ResNet-50 Siamese net (last stride 2, average pool, the square-difference
   head) at 256x128, batches of 256 pairs from ``RandomPairSampler`` over an
   in-memory set of 128 ids x 8 images with landmark files on disk. One
   step is first held against the same step through K14's plain version
   (loss, logits; the layer4 and classifier gradients gated between the
   plain repeat's spread and a reading with the input jittered by 1e-6).
   Launch counts are zeroed just before 20 steps and read just after: K14
   twice a step, nothing else. Then peak memory, 10 warm steps timed, 3
   traced, and ``CascadeEvaluator.evaluate`` on phase 3's eval set with the
   top 100 re-scored and ``dataset=None``: K1 once a batch and K3 six times
   (the mAP, all-shots and market1501 passes of both stages). The net is
   saved as the next phase's stage-I checkpoint;
16. FD-GAN stages II and III (``[fd_stage2]``, ``[fd_stage3]``):
   ``FDGANModel`` at full width (E and Di ResNet-50 Siamese nets, G with ngf
   64, Dp with ndf 64, at 256x128), batches of 256 pairs from the
   ``fdgan_pose`` loader; stage II starts from phase 15's checkpoint (Di
   from E), stage III from the nets stage II saved. One step each is held
   against the same step through K13's and K14's plain versions (the
   losses, the fake, a G, a Dp, two Di and in stage III an E gradient);
   then 3 steps with launch counts (K13 once and K14 twice a step, nothing
   else; the nets of the stage move), peak memory, 2 warm steps timed and
   1 traced, split into the input, E and G forward, Di, Dp and G phases by
   CUDA events;
17. the FD-GAN chain (``[fd_chain]``): ``cli/fdgan_baseline.run`` →
   ``cli/fdgan_train.run`` stage II from its checkpoint → stage III from
   the stage-II nets, one epoch each at full width, on 64 ids x 8 train
   images and 128 + 384 eval images in memory with landmark files on disk.
   Launch counts are zeroed just before and read just after: K1, K3, K13
   and K14 must have launched;
18. the learning and scale checks (``[validate]``, after ``[cuhk03]``):
   the ``main`` of each ``scripts/torch_validate_*.py`` at its own sizes:
   ``cli/train_usl.run`` on the synthetic set (best mAP > 0.5),
   ``cli/train_gan_usl.run`` on it (best mAP > 0.5, ``latest_net_G.pth``
   written), the Jaccard build at 12,936 rows (< 23 s) and ``--fp16``
   ``cli/train_usl.run`` on the hard set of 500 ids x 26 (first mAP < 0.6,
   best ≥ first + 0.10, best > 0.5), and the clustering phase at MSMT17's
   32,621 rows (Jaccard fp32 and fp16, DBSCAN, Infomap, each < 146 s; the
   bank step at the DBSCAN cluster count held against its plain version, <
   1 s; peak RSS < 24 GB), the last in a process of its own, as the JAX
   script runs alone. Launch counts are zeroed before each script and read
   after; K6 and K8 must launch;
19. a JSON line with every kernel's launches (the sum over the two whole
   joint loops, phases 13 and 14, ``[gan_clusters]``, ``[vgg_joint]``'s two
   epochs, the ``run()`` epochs of ``[bip_joint]`` and ``[memory_joint]``,
   ``[ddp]``'s ``run()`` epochs,
   ``[fp16_usl]``, ``[msgpack]``, the FD-GAN chain, phase 17,
   ``[cuhk03]``, ``[validate]`` and the headline recipe's loop, phase 8), error,
   times and bound; K5's and K6's entries carry ``forward_ms``,
   ``backward_ms`` and ``autograd_ms`` (``ms`` is forward + backward;
   ``autograd_ms`` adds autograd's accumulation into ``x.grad``), K6's
   ``library_ms`` is cuBLAS's two fp32 products, and
   K6's entry also carries its times with the extra negatives
   (``ex_f_*``) and at 30,720 bank rows (``bank_30720_*``), K3's its
   variants' (``variant_ms``), MSMT17's chunk (``msmt_ms``) and the
   chunk's distance product (``distance_ms``, context), K8's its k 128 time (``k128_ms``), its
   time at 32,621 rows (``n32621_ms``), its fp32 FMA bound
   (``bound_fp32_ms``) and the fp32 ``torch.matmul`` of the product alone
   (``matmul_fp32_ms``, context, not a library version of K8);
20. the last line: ``{"ok": true, "device": {...}}``.
"""

import functools
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores


def device_ms(fn, reps=10, lead_cycles=20_000_000, before=None):
    """Device time of ``fn`` per call, from CUDA events around each call.
    A sleep kernel ahead of each call keeps the card busy while the host
    enqueues, so host launch overhead stays out of the measurement.
    ``before`` runs ahead of each call, outside the events (an L2 flush)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        torch.cuda._sleep(lead_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_us(fn, reps=200, lead_cycles=200_000_000):
    """Host time of one call of ``fn`` in microseconds: the calls are
    enqueued behind a sleep kernel, so the card never waits for them and
    their wall time is the host's alone (the wrapper, ctypes, the C entry,
    the launch)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(lead_cycles)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def bound_ms(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from concurrent.futures import ThreadPoolExecutor

    from reid_gan_torch import kernels, native

    # g++ builds the host C++ beside nvcc, so that no later span times a build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.ensure_built)
        lib = kernels.load_library()
        host.result()
    print(f"[build] {lib.path} in {lib.seconds:.1f} s; the host C++ library "
          f"(g++) beside it, both ready after {time.perf_counter() - t0:.1f} s")
    # the Jaccard step imports scipy.sparse at its first call; importing it
    # here keeps that one-time cost out of the epoch's spans
    t0 = time.perf_counter()
    importlib.import_module("scipy.sparse")
    print(f"[build] scipy.sparse imported in {time.perf_counter() - t0:.2f} s")
    for line in lib.log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"[ptxas] {line.strip()}")


def k1_table(mean, std):
    """numpy's float32 IEEE ``(b / 255 - mean[c]) / std[c]`` of every byte b
    in every channel c, (3, 256), and its bf16 bits rounded to nearest even,
    as int16."""
    b = np.arange(256, dtype=np.float32)
    table = np.stack([(b / np.float32(255) - np.float32(m)) / np.float32(s)
                      for m, s in zip(mean, std)])
    bits = table.view(np.uint32)
    bf16 = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    return table, bf16.view(np.int16)


def check_k1(report):
    """K1 at batch 256 of 256x128 in both dtypes: against the plain version,
    every (channel, byte) value bit-equal to the IEEE formula (the random
    batch holds all 768), the same bits on a second launch, a digest of each
    dtype's bits (equal between two versions that compute the same values),
    then timed, each dtype beside its own bound."""
    from reid_gan_torch.ops.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        eval_transform,
        eval_transform_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (256, 256, 128, 3), dtype=torch.uint8,
                       device="cuda", generator=g)
    table, bf16_bits = k1_table(IMAGENET_MEAN, IMAGENET_STD)
    chan = torch.arange(3, device="cuda").view(1, 1, 1, 3)
    idx = u8.long()
    want = {torch.float32: torch.from_numpy(table).cuda()[chan, idx].view(torch.int32),
            torch.bfloat16: torch.from_numpy(bf16_bits).cuda()[chan, idx]}
    del idx
    errs, times = {}, {}
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -6)):
        run = lambda dtype=dtype: eval_transform(u8, 256, 128, dtype)  # noqa: E731
        out = run()
        ref = eval_transform_plain(u8, dtype)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.stride() == ref.stride(),
              "K1 layout differs from the plain version")
        errs[dtype] = float((out.float() - ref.float()).abs().max())
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        exact = bool(torch.equal(out.permute(0, 2, 3, 1).view(bits), want[dtype]))
        again = run()
        torch.cuda.synchronize()
        same = bool(torch.equal(again.view(bits), out.view(bits)))
        # fp32: both divide in fp32 (torch's CUDA scalar division may
        # multiply by the reciprocal: 1 ulp). bf16: one bf16 step at |x| < 4
        # where an fp32 ulp crosses a rounding boundary.
        print(f"[K1] eval_transform {dtype}: max_abs_err {errs[dtype]:.3g} "
              f"(tol {tol:.3g}); every (channel, byte) bit-equal to the float32 IEEE "
              f"formula{' rounded to bf16' if bits == torch.int16 else ''}: {exact}; "
              f"the same bits on a second launch: {same}; digest {_digest(out.view(bits))}")
        check(errs[dtype] <= tol, f"K1 {dtype} error {errs[dtype]} > {tol}")
        check(exact and same, f"K1 {dtype}: bits differ from the formula or run to run")
        del out, ref, again
        ms = device_ms(run)
        plain = device_ms(lambda dtype=dtype: eval_transform_plain(u8, dtype))
        b, by = bound_ms(u8.numel() * (1 + torch.finfo(dtype).bits // 8), 3 * u8.numel())
        times[dtype] = (ms, plain, b, by)
        print(f"[K1] {dtype}: ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by}, "
              f"{b / ms:.1%})")
    ms, plain, b, by = times[torch.bfloat16]
    ms32, plain32, b32, _ = times[torch.float32]
    host = host_us(lambda: eval_transform(u8, 256, 128, torch.bfloat16), reps=50)
    print(f"[K1] host {host:.1f} us a call")
    report["eval_transform"] = dict(max_abs_err=errs[torch.bfloat16], ms=ms, host_us=host,
                                    plain_ms=plain, bound_ms=b, bound_by=by,
                                    fp32_max_abs_err=errs[torch.float32], fp32_ms=ms32,
                                    fp32_plain_ms=plain32, fp32_bound_ms=b32)


def check_k2(report):
    """K2 at the extraction batch (256 images) and at the hard-mix step's
    re-encode of 16 images, both of 2048 x 16x8; the 16-image map timed in
    L2 (its caller has just written it) and after a flush of the 50 MB L2."""
    from reid_gan_torch.models.pooling import gem_bn_l2n, gem_bn_l2n_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    c, h, w = 2048, 16, 8
    p = torch.tensor([3.0], device="cuda")
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    mean = torch.rand(c, device="cuda", generator=g) * 0.2
    var = torch.rand(c, device="cuda", generator=g) + 0.5
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    entry, worst = {}, 0.0
    for n in (256, 16):
        fmap = torch.rand((n, c, h, w), device="cuda", generator=g) * 2.0
        fmap = torch.relu(fmap - 0.3).contiguous(memory_format=torch.channels_last)
        run = lambda: gem_bn_l2n(fmap, p, gamma, mean, var)  # noqa: E731
        out = run()
        ref = gem_bn_l2n_plain(fmap, p, gamma, mean, var)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5   # unit vectors; lg2/ex2 against torch.pow and the sum order
        same = _same_bits(run, out)
        print(f"[K2] gem_bn_l2n N {n}: max_abs_err {err:.3g} (tol {tol:.3g}); the same "
              f"bits on a second launch: {same}; digest {_digest(out)}")
        check(err <= tol and same, f"K2 N {n}: error {err} > {tol} or bits differ")
        worst = max(worst, err)
        ms = device_ms(run)
        plain = device_ms(lambda: gem_bn_l2n_plain(fmap, p, gamma, mean, var))
        b, by = bound_ms(4 * (fmap.numel() + 3 * c + 1 + n * c), 3 * fmap.numel())
        line = f"[K2] N {n}: ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by})"
        if n == 256:
            entry.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        else:
            cold = device_ms(run, before=flush.zero_)
            line += f"; after an L2 flush ms {cold:.4f}"
            entry.update(n16_ms=ms, n16_flushed_ms=cold, n16_plain_ms=plain, n16_bound_ms=b)
        print(line)
    report["gem_bn_l2n"] = dict(max_abs_err=worst, **entry)


def _market_block(g, ties, m=3368, n=15913, ids=751, cams=6, dim=2048):
    """Market-1501 eval shape from a seed: 751 ids, 6 cameras, identity
    centroids plus noise, L2-normalised 2048-d features (other shapes by
    the arguments: MSMT17's gallery is 82,161 images of 3,060 ids and 15
    cameras). The noise puts the block's mAP near one half, so matches land
    at every rank and each AP is a sum of unequal precision terms."""
    centers = torch.randn((ids, dim), device="cuda", generator=g)
    qid = torch.randint(0, ids, (m,), device="cuda", generator=g, dtype=torch.int32)
    gid = torch.randint(0, ids, (n,), device="cuda", generator=g, dtype=torch.int32)
    qcam = torch.randint(0, cams, (m,), device="cuda", generator=g, dtype=torch.int32)
    gcam = torch.randint(0, cams, (n,), device="cuda", generator=g, dtype=torch.int32)
    qf = centers[qid.long()] + 3.5 * torch.randn((m, dim), device="cuda", generator=g)
    gf = centers[gid.long()] + 3.5 * torch.randn((n, dim), device="cuda", generator=g)
    if ties:   # every odd gallery row duplicates the even row before it
        gf[1::2], gid[1::2], gcam[1::2] = gf[0::2][:n // 2], gid[0::2][:n // 2], \
            gcam[0::2][:n // 2]
    qf = torch.nn.functional.normalize(qf, dim=1)
    gf = torch.nn.functional.normalize(gf, dim=1)
    return qf, gf, qid, qcam, gid, gcam


def _k3_held(args, tol, label, **kw):
    """K3 on ``args`` against its plain version: match counts and first
    bins equal, AP (and the all-shots rows) within ``tol``, the same bits on
    a second launch. Returns (outputs, plain outputs, max_abs_err)."""
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain

    out = rank_stats(*args, **kw)
    ref = rank_stats_plain(*args, **kw)
    again = rank_stats(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(out[2], ref[2]), f"K3 {label}: match counts differ")
    check(torch.equal(out[1], ref[1]), f"K3 {label}: first-match bins differ")
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(out, again)), f"K3 {label}: other bits on a second launch")
    err = max(float((a - b).abs().max()) for a, b in zip(out[::3], ref[::3]))
    check(err <= tol, f"K3 {label}: error {err} > {tol}")
    return out, ref, err


def _k3_bound(q, n, topk=0, ops_per_entry=2):
    """K3's least time: the block, ids, cameras and outputs moved once."""
    return bound_ms(4 * (q * n + 2 * q + 2 * n + 3 * q + q * topk), ops_per_entry * q * n)


def check_k3(report):
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain
    from reid_gan_torch.ops.distance import squared_euclidean

    g = torch.Generator(device="cuda").manual_seed(3)
    chunk = 1024
    tol = 1e-5   # fp32 AP sums (plain) against double sums (kernel)
    worst = 0.0
    for ties in (False, True):
        qf, gf, qid, qcam, gid, gcam = _market_block(g, ties)
        m, n = qf.shape[0], gf.shape[0]
        err, n_tied, first, ap_sum, n_valid, outs = 0.0, 0, None, 0.0, 0, []
        for s in range(0, m, chunk):   # a short last chunk is ranked as it is
            e = min(s + chunk, m)
            args = (squared_euclidean(qf[s:e], gf), qid[s:e], qcam[s:e], gid, gcam)
            d = args[0]
            if ties:   # exact ties whatever the product's summation order
                d[:, 1::2] = d[:, 0::2][:, :n // 2]
                n_tied += int((d[:, 1::2] == d[:, 0::2][:, :n // 2]).sum())
            out, ref, e_ap = _k3_held(args, tol, f"{m}x{n} ties {ties}")
            err = max(err, e_ap)
            ap_sum += float(ref[0][ref[2] > 0].double().sum())
            n_valid += int((ref[2] > 0).sum())
            outs.append(out)
            first = first or args
        label = "exact ties" if ties else "distinct"
        print(f"[K3] rank_stats {m}x{n} ({label}, {n_tied} tied pairs, "
              f"mAP {ap_sum / n_valid:.4f}): bins and counts equal, "
              f"AP max_abs_err {err:.3g} (tol {tol:.3g}), the same bits on a second "
              f"launch; digest of AP, first bins, |M| "
              f"{_digest(*(torch.cat(t) for t in zip(*outs)))}")
        check(not ties or n_tied > 0, "K3 tie case has no ties")
        worst = max(worst, err)
        if not ties:
            timed, feats = first, (qf[:chunk], gf)
    d = timed[0]
    ms = device_ms(lambda: rank_stats(*timed))
    plain = device_ms(lambda: rank_stats_plain(*timed), reps=3)
    q_, n_ = d.shape
    b, by = _k3_bound(q_, n_)
    dist = device_ms(lambda: squared_euclidean(*feats))
    print(f"[K3] per {q_}-query chunk of the distinct case: ms {ms:.4f} "
          f"plain_ms {plain:.4f} bound_ms {b:.4f} ({by}, {100 * b / ms:.1f}%); the "
          f"chunk's distance product ahead of it (fp32 torch.matmul, context) ms {dist:.4f}")
    report["rank_stats"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                                bound_ms=b, bound_by=by, distance_ms=dist)
    del timed, first, d, feats
    worst = max(worst, _check_k3_msmt17(report, g, tol))
    report["rank_stats"]["max_abs_err"] = worst


def _check_k3_msmt17(report, g, tol):
    """K3 on a 1,024-query chunk against MSMT17's gallery (82,161 images,
    3,060 ids, 15 cameras), from ``_market_block``'s recipe: counts and
    bins against the plain version, the time, the plain time, the bound."""
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain
    from reid_gan_torch.ops.distance import squared_euclidean

    qf, gf, qid, qcam, gid, gcam = _market_block(g, False, m=1024, n=82161, ids=3060,
                                                 cams=15)
    args = (squared_euclidean(qf, gf), qid, qcam, gid, gcam)
    del qf, gf
    out, ref, err = _k3_held(args, tol, "MSMT17 chunk")
    has = ref[2] > 0
    q_, n_ = args[0].shape
    ms = device_ms(lambda: rank_stats(*args))
    plain = device_ms(lambda: rank_stats_plain(*args), reps=3)
    b, by = _k3_bound(q_, n_)
    print(f"[K3] MSMT17 chunk {q_}x{n_} (3,060 ids, 15 cameras, mean |M| "
          f"{float(ref[2][has].float().mean()):.1f}, max {int(ref[2].max())}, mAP "
          f"{float(ref[0][has].double().mean()):.4f}): bins and counts equal, AP "
          f"max_abs_err {err:.3g} (tol {tol:.3g}), the same bits on a second launch; "
          f"digest {_digest(*out)}; ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} "
          f"({by}, {100 * b / ms:.1f}%)")
    report["rank_stats"].update(msmt_ms=ms, msmt_plain_ms=plain, msmt_bound_ms=b)
    return err


def _digest(*ts):
    """A short hash of tensors' bytes, so that two processes (a commit and
    its parent) can show that they wrote the same bits."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _same_bits(fn, out):
    """``fn()`` once more on the same inputs writes the same bytes as ``out``."""
    again = fn()
    torch.cuda.synchronize()
    return bool(torch.equal(again.view(torch.int32), out.view(torch.int32)))


def check_k4(report):
    """K4 at 256 x 256x128 with the port's draws: against the plain version,
    once more with the erase flags zeroed (the weights and texels alone,
    which the digest lets a parent's run match bit for bit), the same bits
    on a second launch, then timed."""
    from reid_gan_torch.ops.transforms import (
        ERASE,
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(4)
    n, h, w = 256, 256, 128
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device="cuda",
                       generator=g)
    params = sample_augment_params(n, h, w, g)
    out = train_augment(u8, params, h, w)
    ref = train_augment_plain(u8, params)
    torch.cuda.synchronize()
    check(out.stride() == ref.stride(), "K4 layout differs from the plain version")
    err = float((out - ref).abs().max())
    tol = 1e-5   # the same fp32 arithmetic; the erase fill sums in another order
    same = _same_bits(lambda: train_augment(u8, params, h, w), out)
    no_erase = params.clone()
    no_erase[:, ERASE] = 0
    out0 = train_augment(u8, no_erase, h, w)
    err0 = float((out0 - train_augment_plain(u8, no_erase)).abs().max())
    print(f"[K4] train_augment: max_abs_err {err:.3g} (tol {tol:.3g}); "
          f"{int(params[:, 0].sum())} flips, {int(params[:, 5].sum())} erases; "
          f"erase off: max_abs_err {err0:.3g}, digest {_digest(out0)}; "
          f"a second launch gives the same bits: {same}")
    check(err <= tol and err0 <= tol, f"K4 error {err} / {err0} > {tol}")
    check(same, "K4 wrote other bits on a second launch")
    ms = device_ms(lambda: train_augment(u8, params, h, w))
    plain = device_ms(lambda: train_augment_plain(u8, params))
    b, by = bound_ms(u8.numel() * (1 + 4) + params.numel() * 4, 20 * u8.numel())
    print(f"[K4] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by}, {b / ms:.1%})")
    report["train_augment"] = dict(max_abs_err=err, max_abs_err_erase_off=err0, ms=ms,
                                   plain_ms=plain, bound_ms=b, bound_by=by)


def check_k5(report):
    from reid_gan_torch.models.pooling import gem_pool, gem_pool_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    n, c, h, w = 256, 2048, 16, 8
    fmap = torch.relu(torch.rand((n, c, h, w), device="cuda", generator=g) * 2 - 0.6)
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    gout = torch.randn((n, c), device="cuda", generator=g) / n

    def run(fn):
        x = fmap.detach().requires_grad_(True)
        p = torch.tensor([3.0], device="cuda", requires_grad=True)
        out = fn(x, p)
        out.backward(gout)
        return out, x.grad, p.grad

    out, dx, dp = run(gem_pool)
    ref, dx_r, dp_r = run(gem_pool_plain)
    torch.cuda.synchronize()
    out, ref = out.detach(), ref.detach()
    e_out = float((out - ref).abs().max() / ref.abs().max())
    e_dx = float((dx - dx_r).abs().max() / dx_r.abs().max())
    e_dp = abs(float(dp) - float(dp_r)) / abs(float(dp_r))
    # relative: lg2/ex2 against torch.pow and the sum order; dp: the kernel
    # sums 524,288 terms in double, the plain autograd in fp32
    tol, tol_dp = 1e-5, 1e-3
    print(f"[K5] gem_pool: rel err forward {e_out:.3g}, d map {e_dx:.3g} "
          f"(tol {tol:.3g}), dp {e_dp:.3g} (tol {tol_dp:.3g}; dp {float(dp):.6g})")
    check(e_out <= tol and e_dx <= tol and e_dp <= tol_dp, "K5 differs from plain")
    x = fmap.detach().requires_grad_(True)
    pp = torch.tensor([3.0], device="cuda", requires_grad=True)
    t = _time_phases(lambda: gem_pool(x, pp), (x, pp), gout)
    plain = device_ms(lambda: torch.autograd.grad(gem_pool_plain(x, pp), (x, pp), gout))
    bf, _ = bound_ms(4 * (fmap.numel() + 2 * n * c), 4 * fmap.numel())
    bb, _ = bound_ms(4 * (2 * fmap.numel() + 3 * n * c), 4 * fmap.numel())
    fwd, bwd = t["forward_ms"], t["backward_ms"]
    print(f"[K5] forward ms {fwd:.4f} bound_ms {bf:.4f} (bytes, {bf / fwd:.1%}); "
          f"backward ms {bwd:.4f} bound_ms {bb:.4f} (bytes, {bb / bwd:.1%}); "
          f"together {t['ms']:.4f} against {bf + bb:.4f} ({(bf + bb) / t['ms']:.1%}); "
          f"autograd_ms (+ the x.grad accumulation) {t['autograd_ms']:.4f}; plain_ms "
          f"{plain:.4f}; library: none (no PyTorch call computes GeM with a learned p)")
    report["gem_pool"] = dict(max_abs_err=float((dx - dx_r).abs().max()), **t,
                              plain_ms=plain, bound_ms=bf + bb, bound_by="bytes",
                              library_ms=None)


def _time_phases(fn, inputs, grad, reps=10):
    """The forward and the backward of the autograd op ``fn()`` apart:
    ``forward_ms`` is ``fn()`` on leaves that require a gradient,
    ``backward_ms`` is ``torch.autograd.grad`` of its output on the saved
    graph (no leaf's ``.grad`` is touched), ``ms`` their sum. ``autograd_ms``
    is ``fn().backward(grad)`` on leaves that already hold a gradient, as a
    training step runs it: it adds the accumulation into each ``.grad``."""
    out = fn()
    fwd = device_ms(fn, reps)
    bwd = device_ms(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True), reps)
    auto = device_ms(lambda: fn().backward(grad), reps)
    return dict(ms=fwd + bwd, forward_ms=fwd, backward_ms=bwd, autograd_ms=auto)


def _k6_inputs(k_pad, nv, seed, t=0, group=16, b=256, d=2048):
    from reid_gan_torch.ops.cluster_memory import init_memory

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device="cuda", generator=g), dim=1)
    state = init_memory(centers, k_pad=k_pad, device="cuda")
    y = torch.randint(0, nv, (b,), device="cuda", generator=g, dtype=torch.int32)
    x0 = centers[y.long()] + 0.05 * torch.randn((b, d), device="cuda", generator=g)
    ex = (centers[y[::group].long()] + 0.05 * torch.randn((t, d), device="cuda", generator=g)
          if t else None)
    return state, y, x0, ex


def _time_k6(label, state, y, x0, ex=None, group=16, reps=10, **row0):
    """K6's forward and backward apart (``_time_phases``), its plain version
    (forward + backward) and cuBLAS's two fp32 products alone
    (``torch.matmul``, TF32 off, on the padded bank as the plain version
    takes it). The bound of each phase: its bytes, or its product as the
    kernel does it at fp32 accuracy, three TF32 products (3xTF32) on the
    tensor cores; ``fp32_simt_bound_ms`` is the two products at the fp32
    rate outside the tensor cores."""
    from reid_gan_torch.ops.cluster_memory import memory_loss, memory_loss_plain

    b, d = x0.shape
    k_pad, nv = state.features.shape[0], int(state.num_valid)
    t = 0 if ex is None else ex.shape[0]
    gl = torch.full((b,), 1.0 / b, device="cuda")
    x = x0.detach().requires_grad_(True)
    times = _time_phases(lambda: memory_loss(x, y, state, ex_f=ex, group_size=group,
                                             **row0)[0], (x,), gl, reps)
    plain = device_ms(lambda: torch.autograd.grad(
        memory_loss_plain(x, y, state, ex_f=ex, group_size=group, **row0)[0], x, gl),
        reps)
    rows = state.features if ex is None else torch.cat([state.features, ex])
    dl = torch.randn((b, rows.shape[0]), device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cublas = device_ms(lambda: (torch.matmul(x0, rows.T), torch.matmul(dl, rows)), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    flops = 2 * b * (nv + t) * d
    io = (nv + t) * d + b * (k_pad + t)   # the live rows and the logits
    bf, byf = bound_ms(4 * (b * d + io), 3 * flops, TF32_OPS_PER_S)
    bb, byb = bound_ms(4 * (2 * b * d + io), 3 * flops, TF32_OPS_PER_S)
    simt = 2 * flops / FP32_OPS_PER_S * 1e3
    fwd, bwd, ms = times["forward_ms"], times["backward_ms"], times["ms"]
    print(f"[K6] {label}: forward ms {fwd:.4f} bound_ms {bf:.4f} ({byf}, {bf / fwd:.1%}); "
          f"backward ms {bwd:.4f} bound_ms {bb:.4f} ({byb}, {bb / bwd:.1%}); together "
          f"{ms:.4f} against {bf + bb:.4f} ({(bf + bb) / ms:.1%}; fp32 SIMT bound "
          f"{simt:.4f}, {simt / ms:.1%}); autograd_ms (+ the x.grad accumulation) "
          f"{times['autograd_ms']:.4f}; plain_ms {plain:.4f}; cuBLAS's two fp32 "
          f"products {cublas:.4f}")
    return dict(**times, plain_ms=plain, bound_ms=bf + bb, bound_by=byf, library_ms=cublas,
                fp32_simt_bound_ms=simt)


def check_k6(report):
    from reid_gan_torch.ops.cluster_memory import memory_loss, memory_loss_plain

    b, d = 256, 2048
    worst, timed = 0.0, {}
    for k_pad, nv in ((768, 700), (30720, 30000)):
        state, y, x0, _ = _k6_inputs(k_pad, nv, k_pad)

        def run(fn, x0=x0, y=y, state=state):
            x = x0.detach().requires_grad_(True)
            loss, logits = fn(x, y, state)
            loss.mean().backward()
            return loss, logits, x.grad

        loss, logits, dx = run(memory_loss)
        loss_r, logits_r, dx_r = run(memory_loss_plain)
        torch.cuda.synchronize()
        e_l = float((logits[:, :nv] - logits_r[:, :nv]).abs().max())
        e_loss = float((loss - loss_r).abs().max())
        e_dx = float((dx - dx_r).abs().max())
        masked = bool(torch.isneginf(logits[:, nv:]).all())
        # temp 0.05 multiplies the fp32 product's rounding (~1e-7) by 20
        tol, tol_dx = 1e-4, 1e-6
        print(f"[K6] infonce B {b} D {d} K_pad {k_pad} num_valid {nv}: max_abs_err "
              f"logits {e_l:.3g}, loss {e_loss:.3g} (tol {tol:.3g}), dx {e_dx:.3g} "
              f"(tol {tol_dx:.3g}); masked columns -inf: {masked}")
        check(masked and e_l <= tol and e_loss <= tol and e_dx <= tol_dx,
              "K6 differs from plain")
        worst = max(worst, e_loss)
        timed[k_pad] = _time_k6(f"K_pad {k_pad}", state, y, x0,
                                reps=10 if k_pad == 768 else 3)
    ex_err, ex_times = _check_k6_extra_negatives()
    report["infonce"] = dict(max_abs_err=max(worst, ex_err), **timed[768],
                             **{f"ex_f_{k}": v for k, v in ex_times.items()},
                             **{f"bank_30720_{k}": v for k, v in timed[30720].items()})


def _check_k6_extra_negatives():
    """K6 with the hard-mix step's 16 extra negatives (groups of 16) at B
    256, D 2048, K_pad 768, num_valid 700: loss, logits and dx against the
    plain version, and forward and backward ms."""
    from reid_gan_torch.ops.cluster_memory import memory_loss, memory_loss_plain

    b, d, k_pad, nv, t, group = 256, 2048, 768, 700, 16, 16
    state, y, x0, ex = _k6_inputs(k_pad, nv, 6, t=t, group=group)

    def run(fn):
        x = x0.detach().requires_grad_(True)
        loss, logits = fn(x, y, state, ex_f=ex, group_size=group)
        loss.mean().backward()
        return loss, logits, x.grad

    loss, logits, dx = run(memory_loss)
    loss_r, logits_r, dx_r = run(memory_loss_plain)
    torch.cuda.synchronize()
    digest = _digest(loss.detach(), logits, dx)
    masked = (torch.arange(b, device="cuda")[:, None] // group ==
              torch.arange(t, device="cuda")[None])
    lex, lex_r = logits[:, k_pad:], logits_r[:, k_pad:]
    e_l = max(float((logits[:, :nv] - logits_r[:, :nv]).abs().max()),
              float(torch.where(masked, 0.0, (lex - lex_r).abs()).max()))
    e_mask = float(torch.where(masked, (lex - lex_r).abs() / lex_r.abs(), 0.0).max())
    e_loss = float((loss - loss_r).abs().max())
    e_dx = float((dx - dx_r).abs().max())
    # as without ex_f; the masked columns sit near -2e5, where an fp32 ulp is 0.016
    tol, tol_dx, tol_mask = 1e-4, 1e-6, 1e-6
    print(f"[K6] ex_f B {b} D {d} K_pad {k_pad} num_valid {nv} T {t} group {group}: "
          f"max_abs_err logits {e_l:.3g}, loss {e_loss:.3g} (tol {tol:.3g}), dx "
          f"{e_dx:.3g} (tol {tol_dx:.3g}); self-masked columns rel err {e_mask:.3g} "
          f"(tol {tol_mask:.3g}); digest {digest}")
    check(e_l <= tol and e_loss <= tol and e_dx <= tol_dx and e_mask <= tol_mask
          and tuple(logits.shape) == (b, k_pad + t), "K6 with ex_f differs from plain")
    times = _time_k6(f"ex_f T {t}", state, y, x0, ex, group)
    # a package from before the data mesh's hard-mix step (``--kernels K6
    # ROOT`` on an older commit) has no row0
    if "row0" not in inspect.signature(memory_loss).parameters:
        return max(e_loss, e_l), times
    e_row0, row0_times = _check_k6_row0(state, y, x0, ex, group)
    return max(e_loss, e_l, e_row0), dict(times, **{f"row0_{k}": v
                                                   for k, v in row0_times.items()})


def _check_k6_row0(state, y, x0, ex, group, ranks=4):
    """K6 as the hard-mix step runs it on a rank of a data mesh of ``ranks``
    cards: the rank's 256 / ``ranks`` rows from ``row0`` = rank · rows (the
    last rank), the 16 extra negatives of the whole batch, each masked for
    its global group, against the plain version with the same ``row0``;
    timed beside the whole batch's call."""
    from reid_gan_torch.ops.cluster_memory import memory_loss, memory_loss_plain

    b = x0.shape[0] // ranks
    row0 = (ranks - 1) * b
    xs, ys = x0[row0:].contiguous(), y[row0:].contiguous()
    t, k_pad = ex.shape[0], state.features.shape[0]

    def run(fn):
        x = xs.detach().requires_grad_(True)
        loss, logits = fn(x, ys, state, ex_f=ex, group_size=group, row0=row0)
        loss.mean().backward()
        return loss, logits, x.grad

    loss, logits, dx = run(memory_loss)
    loss_r, logits_r, dx_r = run(memory_loss_plain)
    torch.cuda.synchronize()
    masked = ((row0 + torch.arange(b, device="cuda"))[:, None] // group ==
              torch.arange(t, device="cuda")[None])
    lex, lex_r = logits[:, k_pad:], logits_r[:, k_pad:]
    nv = int(state.num_valid)
    e_l = max(float((logits[:, :nv] - logits_r[:, :nv]).abs().max()),
              float(torch.where(masked, 0.0, (lex - lex_r).abs()).max()))
    e_mask = float(torch.where(masked, (lex - lex_r).abs() / lex_r.abs(), 0.0).max())
    e_loss = float((loss - loss_r).abs().max())
    e_dx = float((dx - dx_r).abs().max())
    tol, tol_dx, tol_mask = 1e-4, 1e-6, 1e-6
    on_mask = bool((torch.where(masked, lex, 0.0).sum(1) < -1e5).all())
    print(f"[K6] ex_f on a rank of {ranks}: B {b} from row0 {row0}, T {t} group {group}: "
          f"max_abs_err logits {e_l:.3g}, loss {e_loss:.3g} (tol {tol:.3g}), dx "
          f"{e_dx:.3g} (tol {tol_dx:.3g}); self-masked columns rel err {e_mask:.3g} "
          f"(tol {tol_mask:.3g}), each row's at its global group: {on_mask}")
    check(on_mask and e_l <= tol and e_loss <= tol and e_dx <= tol_dx
          and e_mask <= tol_mask, "K6 with row0 differs from plain")
    return max(e_loss, e_l), _time_k6(f"ex_f T {t} B {b} row0 {row0}", state, ys, xs,
                                      ex, group, row0=row0)


def check_k7(report):
    """K7 on a 16 x 16 P×K batch (plain, hard, and the joint fold of the
    feature and GAN banks in one call) and on one label for the whole batch
    (a 256-deep chain, more slots than the kernel stages at once), each
    against the plain fold and run twice from the same bank for the same
    bits; timed plain, joint and 256 deep."""
    from reid_gan_torch import kernels
    from reid_gan_torch.ops.cluster_memory import (
        init_memory,
        update_memory,
        update_memory_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(7)
    b, d, nv, k_pad = 256, 2048, 700, 768
    centers = torch.nn.functional.normalize(
        torch.randn((nv, d), device="cuda", generator=g), dim=1)
    gan_centers = torch.randn((nv, d), device="cuda", generator=g)
    ids = torch.randperm(nv, device="cuda", generator=g)[:16]
    y = ids.repeat_interleave(16)[torch.randperm(b, device="cuda", generator=g)]
    y = y.to(torch.int32).contiguous()
    one = torch.full_like(y, int(ids[0]))
    x = centers[y.long()] + 0.3 * torch.randn((b, d), device="cuda", generator=g)
    gx = gan_centers[y.long()] + torch.randn((b, d), device="cuda", generator=g)
    cases = {"plain (16 labels x 16)": (y, False, None),
             "hard (16 labels x 16)": (y, True, None),
             "joint, both banks (16 labels x 16)": (y, False, gx),
             "one label, 256 deep": (one, False, None)}

    def fresh(gan):
        return init_memory(centers, k_pad=k_pad, device="cuda",
                           gan_centroids=gan_centers if gan is not None else None)

    worst, entry = 0.0, {}
    for name, (yy, hard, gan) in cases.items():
        state, ref, again = fresh(gan), fresh(gan), fresh(gan)
        before = kernels.BANK_FOLD.launches["forward"]
        update_memory(state, x, yy, use_hard=hard, gan_x=gan, group_size=16)
        launches = kernels.BANK_FOLD.launches["forward"] - before
        update_memory_plain(ref, x, yy, use_hard=hard, gan_x=gan)
        update_memory(again, x, yy, use_hard=hard, gan_x=gan, group_size=16)
        torch.cuda.synchronize()
        err = float((state.features - ref.features).abs().max())
        gerr = float((state.gan_features - ref.gan_features).abs().max()) if gan is not None \
            else 0.0
        same = all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                   for u, v in zip(state, again) if u.dtype == torch.float32)
        tol, gtol = 1e-6, 1e-5   # unit rows, fp32 sums in other orders
        print(f"[K7] bank_fold {name}: max_abs_err {err:.3g} (tol {tol:.3g})"
              + (f", GAN bank {gerr:.3g} (tol {gtol:.3g})" if gan is not None else "")
              + f"; {launches} launch(es); the same bits on a second run: {same}")
        check(err <= tol and gerr <= gtol and same, f"K7 {name}: error {err}, GAN bank "
              f"{gerr} or bits differ")
        worst = max(worst, err)
        if gan is not None:
            entry["joint_launches"] = launches
    for key, (yy, gan, rows) in {"": (y, None, 1), "joint_": (y, gx, 2),
                                 "deep256_": (one, None, 1)}.items():
        state = fresh(gan)
        ms = device_ms(lambda: update_memory(state, x, yy, gan_x=gan, group_size=16))
        labels = len(torch.unique(yy))
        bnd, by = bound_ms(4 * (rows * (b * d + 2 * labels * d) + b), 10 * rows * b * d)
        entry.update({f"{key}ms": ms, f"{key}bound_ms": bnd})
        if not key:
            plain = device_ms(lambda: update_memory_plain(state, x, yy), reps=3)
            entry.update(plain_ms=plain, bound_by=by)
        print(f"[K7] {key or 'plain fold '}ms {ms:.4f}"
              + (f" plain_ms {plain:.4f}" if not key else "")
              + f" bound_ms {bnd:.4f} ({by})")
    report["bank_fold"] = dict(max_abs_err=worst, **entry)


def _train_features(g, n, ids=751, dim=2048, quantize=False):
    """Features shaped like Market-1501's train set from a seed: identity
    centroids plus noise, L2-normalised. ``quantize``: rounded to multiples
    of 2^-8 with every odd row a copy of the even row before it. Then every
    partial sum of a norm or a product is an integer multiple of 2^-16 below
    2^24 of them, so both versions compute every key exactly, whatever their
    summation order, and the rows hold exact ties (the duplicates, and many
    coincidences on the coarse grid)."""
    centers = torch.randn((ids, dim), device="cuda", generator=g)
    pid = torch.randint(0, ids, (n,), device="cuda", generator=g)
    f = torch.nn.functional.normalize(
        centers[pid] + 3.5 * torch.randn((n, dim), device="cuda", generator=g), dim=1)
    if quantize:
        f = torch.round(f * 256) / 256
        f[1::2] = f[0::2][:n // 2]
    return f.contiguous()


def _swap_gap(f, idx, pv, pi, metric):
    """Where K8's index table ``idx`` differs from the plain one ``pi``:
    the rows of the differing entries, and the largest gap between the plain
    version's key of the index K8 put there and the plain key at that slot
    (``pv``). A swap of a near-tie leaves a gap at rounding level."""
    from reid_gan_torch.ops.distance import matmul_fp32, squared_euclidean

    rows, cols = np.nonzero(idx != pi)
    if not rows.size:
        return rows, 0.0
    ur, at = np.unique(rows, return_inverse=True)
    gap = 0.0
    for s in range(0, ur.size, 2048):    # a few (2048, N) key blocks at a time
        sel = (at >= s) & (at < s + 2048)
        fr = f[torch.from_numpy(ur[s:s + 2048]).cuda()]
        dr = squared_euclidean(fr, f) if metric == "l2" else matmul_fp32(fr, f.T)
        got = dr[torch.from_numpy(at[sel] - s).cuda(),
                 torch.from_numpy(idx[rows[sel], cols[sel]].astype(np.int64)).cuda()]
        gap = max(gap, float(np.abs(got.cpu().numpy() - pv[rows[sel], cols[sel]]).max()))
    return rows, gap


def _k8_bound(n, dim, k):
    """K8's bound at N rows of D and k: the upper triangle's N (N + 1) / 2
    products (the keys are symmetric: q.g = g.q, |q|^2 + |g|^2 = |g|^2 +
    |q|^2), as 3xTF32 on the tensor cores (three products, as K6's), and the
    same as fp32 FMA outside them. Returns (ms, bound_by, fp32 FMA ms)."""
    nbytes, ops = 4 * (n * dim + 2 * n * k), n * (n + 1) * dim
    b, by = bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)
    return b, by, bound_ms(nbytes, ops)[0]


def _k8_scratch_bytes(n, k):
    """The device scratch K8 allocates at N rows and k: the norms and its two
    scratch buffers."""
    from reid_gan_torch.kernels import KNN_TOPK

    return 4 * (n + 2 * KNN_TOPK.scratch_size(n, k))


def check_k8(report):
    """K8 against its plain version (row-blocked distances, stable sort) at
    Market-1501's train shape: L2 with k 30 (the Jaccard step) and inner
    product with k 15 (the Infomap graph)."""
    from reid_gan_torch.ops.distance import knn_search_plain, knn_topk_cuda, matmul_fp32

    g = torch.Generator(device="cuda").manual_seed(8)
    n, dim, tol = 12936, 2048, 2e-5   # fp32 products summed in other orders
    f = _train_features(g, n)
    worst = 0.0
    for metric, k in (("l2", 30), ("ip", 15)):
        vals, idx = (t.cpu().numpy() for t in knn_topk_cuda(f, k, metric))
        pv, pi = knn_search_plain(f, k, metric)
        torch.cuda.synchronize()
        err = float(np.abs(vals - pv).max())
        rows, gap = _swap_gap(f, idx, pv, pi, metric)
        self_first = bool(np.array_equal(idx[:, 0], np.arange(n)))
        print(f"[K8] knn_topk {metric} N {n} D {dim} k {k}: vals max_abs_err {err:.3g} "
              f"(tol {tol:.3g}); {rows.size} swapped entries in {np.unique(rows).size} "
              f"rows, largest plain-side gap {gap:.3g} (tol {tol:.3g}); self first: "
              f"{self_first}")
        check(err <= tol and gap <= tol and self_first, f"K8 {metric} differs from plain")
        worst = max(worst, err)
    fq = _train_features(g, n, quantize=True)
    for metric, k in (("l2", 30), ("ip", 15)):
        vals, idx = (t.cpu().numpy() for t in knn_topk_cuda(fq, k, metric))
        pv, pi = knn_search_plain(fq, k, metric)
        ties = int((pv[:, 1:] == pv[:, :-1]).sum())
        print(f"[K8] exact ties {metric} k {k}: {ties} tied neighbour pairs; indices "
              f"identical: {np.array_equal(idx, pi)}, values identical: "
              f"{np.array_equal(vals, pv)}")
        check(ties > 0 and np.array_equal(idx, pi) and np.array_equal(vals, pv),
              f"K8 {metric} orders exact ties otherwise than the plain version")

    ms = device_ms(lambda: knn_topk_cuda(f, 30, "l2"))
    plain = device_ms(lambda: knn_search_plain(f, 30, "l2"))
    mm = device_ms(lambda: matmul_fp32(f, f.T), reps=3)
    b, by, b_fp32 = _k8_bound(n, dim, 30)
    print(f"[K8] L2 k 30 at N {n}: ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} "
          f"({by}, 3xTF32; {b_fp32:.4f} as fp32 FMA); fp32 torch.matmul of the same "
          f"product alone: {mm:.4f} ms (context, not a library version of K8); "
          f"scratch {_k8_scratch_bytes(n, 30)} bytes")
    n2 = 32621   # MSMT17's train set
    f2 = _train_features(g, n2)
    ms2 = device_ms(lambda: knn_topk_cuda(f2, 30, "l2"), reps=3)
    b2, by2, b2_fp32 = _k8_bound(n2, dim, 30)
    print(f"[K8] L2 k 30 at N {n2}: ms {ms2:.4f} bound_ms {b2:.4f} ({by2}, 3xTF32; "
          f"{b2_fp32:.4f} as fp32 FMA); scratch {_k8_scratch_bytes(n2, 30)} bytes")
    report["knn_topk"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b,
                              bound_by=by, bound_fp32_ms=b_fp32, matmul_fp32_ms=mm,
                              n32621_ms=ms2, n32621_bound_ms=b2)


def check_k9(report):
    from reid_gan_torch.ops.transforms import (
        gan_input_transform,
        gan_input_transform_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(9)
    n, h, w = 256, 128, 64
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device="cuda",
                       generator=g)
    out = gan_input_transform(u8, h, w)
    ref = gan_input_transform_plain(u8)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.stride() == ref.stride(),
          "K9 layout differs from the plain version")
    err = float((out - ref).abs().max())
    tol = 1e-6   # IEEE division in both; torch's CUDA scalar division may
    #              multiply by the reciprocal (1 ulp)
    print(f"[K9] gan_input {n}x{h}x{w}: max_abs_err {err:.3g} (tol {tol:.3g})")
    check(err <= tol, f"K9 error {err} > {tol}")
    ms = device_ms(lambda: gan_input_transform(u8, h, w))
    plain = device_ms(lambda: gan_input_transform_plain(u8))
    b, by = bound_ms(u8.numel() * (1 + 4), 2 * u8.numel())
    print(f"[K9] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by})")
    report["gan_input"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                               bound_by=by)


def _keypoints(rng, n, old):
    """(n, 18, 2) float32 keypoints uniform in each image's original frame
    ``old`` (n, 2), a fifth of the joints missing in y, in x or in both."""
    kp = rng.uniform(0, 1, (n, 18, 2)) * old[:, None, :]
    miss = rng.integers(0, 15, (n, 18))
    kp[miss == 0, 0] = -1
    kp[miss == 1, 1] = -1
    kp[miss == 2] = -1
    return kp.astype(np.float32)


def check_k10(report):
    from reid_gan_torch.ops.pose import batch_cords_to_map, batch_cords_to_map_plain

    rng = np.random.default_rng(10)
    n, k, h, w = 256, 18, 128, 64
    old = np.where(np.arange(n)[:, None] % 2, (256.0, 128.0), (311.0, 97.0))
    kp = _keypoints(rng, n, old)
    kp[1, :4] = ((0, 0), (old[1, 0] - 1e-3, old[1, 1] - 1e-3), (0, old[1, 1] - 1e-3),
                 (old[1, 0] - 1e-3, 0))              # the frame's corners
    kp[2] = -1                                       # every joint missing
    cords = torch.from_numpy(kp).cuda()
    old_size = torch.from_numpy(old.astype(np.float32)).cuda()
    out = batch_cords_to_map(cords, old_size, h, w)
    ref = batch_cords_to_map_plain(cords, old_size, h, w)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    missing = int(((cords[..., 0] == -1) | (cords[..., 1] == -1)).sum())
    zeros = bool((out[2] == 0).all())
    corners = [float(out[1, j, r, c]) for j, (r, c) in
               enumerate(((0, 0), (h - 1, w - 1), (0, w - 1), (h - 1, 0)))]
    tol = 1e-6   # expf against torch.exp: an ulp or two of values <= 1
    same = _same_bits(lambda: batch_cords_to_map(cords, old_size, h, w), out)
    print(f"[K10] pose_maps {n}x{k}x{h}x{w}: max_abs_err {err:.3g} (tol {tol:.3g}); "
          f"{missing} missing joints, all-missing image zero: {zeros}, corner "
          f"peaks {corners}; digest {_digest(out)}, a second launch gives the same "
          f"bits: {same}")
    check(err <= tol and zeros and corners == [1.0] * 4, "K10 differs from plain")
    check(same, "K10 wrote other bits on a second launch")
    ms = device_ms(lambda: batch_cords_to_map(cords, old_size, h, w))
    plain = device_ms(lambda: batch_cords_to_map_plain(cords, old_size, h, w))
    b, by = bound_ms(4 * (out.numel() + cords.numel() + old_size.numel()),
                     10 * out.numel())
    print(f"[K10] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by}, {b / ms:.1%})")
    report["pose_maps"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                               bound_by=by)


def check_k11(report):
    from reid_gan_torch.models.resnet import gan_feat, gan_feat_plain

    g = torch.Generator(device="cuda").manual_seed(11)
    n, c, h, w = 256, 2048, 16, 8
    fmap = torch.relu(torch.randn((n, c, h, w), device="cuda", generator=g))
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    out = gan_feat(fmap)
    ref = gan_feat_plain(fmap)
    torch.cuda.synchronize()
    check(out.stride() == ref.stride(), "K11 layout differs from the plain version")
    err = float((out - ref).abs().max())
    tol = 1e-6   # unit columns; fp32 sums of 2048 squares in another order
    print(f"[K11] gan_feat_l2n ({n}, {c}, {h}, {w}) channels_last: max_abs_err "
          f"{err:.3g} (tol {tol:.3g})")
    check(err <= tol, f"K11 error {err} > {tol}")
    ms = device_ms(lambda: gan_feat(fmap))
    plain = device_ms(lambda: gan_feat_plain(fmap))
    lib = device_ms(lambda: torch.nn.functional.normalize(fmap, dim=1))
    b, by = bound_ms(4 * 2 * fmap.numel(), 4 * fmap.numel())
    print(f"[K11] ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
          f"(F.normalize(dim=1)) bound_ms {b:.4f} ({by})")
    report["gan_feat_l2n"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                  bound_by=by, library_ms=lib)


def check_k12(report):
    from reid_gan_torch.ops.transforms import diff_transform, diff_transform_plain

    g = torch.Generator(device="cuda").manual_seed(12)
    n, h, w = 16, 128, 64
    img = torch.tanh(2 * torch.randn((n, 3, h, w), device="cuda", generator=g))
    # one image of extremes: -1 and +1 alternating, so the renormalised taps
    # of the edge rows and columns see full swings
    img[0] = ((torch.arange(h, device="cuda")[:, None] +
               torch.arange(w, device="cuda")[None]) % 2).float() * 2 - 1
    out = diff_transform(img, 2 * h, 2 * w)
    ref = diff_transform_plain(img, 2 * h, 2 * w)
    ref64 = diff_transform_plain(img.double(), 2 * h, 2 * w)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.stride() == ref.stride(),
          "K12 layout differs from the plain version")
    err = float((out - ref).abs().max())
    err64 = float((out.double() - ref64).abs().max())
    edges = [0, 1, 2, -3, -2, -1]
    edge = max(float((out - ref)[:, :, edges].abs().max()),
               float((out.double() - ref64)[:, :, edges].abs().max()),
               float((out.double() - ref64)[:, :, :, edges].abs().max()))
    same = _same_bits(lambda: diff_transform(img, 2 * h, 2 * w), out)
    tol = 5e-6   # ~20 fp32 ulps of the outputs: 16 taps in another order, then / std
    print(f"[K12] diff_transform ({n}, 3, {h}, {w}) -> ({2 * h}, {2 * w}) channels_last: "
          f"max_abs_err {err:.3g}, against fp64 {err64:.3g}, edge rows and columns "
          f"{edge:.3g} (tol {tol:.3g}); the same bits on a second launch: {same}; "
          f"digest {_digest(out)}")
    check(max(err, err64, edge) <= tol, f"K12 error {max(err, err64, edge)} > {tol}")
    check(same, "K12 wrote other bits on a second launch")
    ms = device_ms(lambda: diff_transform(img, 2 * h, 2 * w))
    plain = device_ms(lambda: diff_transform_plain(img, 2 * h, 2 * w))
    host = host_us(lambda: diff_transform(img, 2 * h, 2 * w))
    b, by = bound_ms(4 * (img.numel() + out.numel()), 75 * out.numel())
    print(f"[K12] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by}, {b / ms:.1%}); "
          f"host {host:.1f} us a call")
    report["diff_transform"] = dict(max_abs_err=err, max_abs_err_fp64=err64, ms=ms,
                                    plain_ms=plain, bound_ms=b, bound_by=by, host_us=host)


def _eval_set(seed=0, n_ids=256, n_query=1024, n_gallery=3072, h=256, w=128,
              batch=256):
    """In-memory uint8 eval set: per-identity base colour plus noise, ids
    spread evenly over query and gallery, 6 cameras."""
    rng = np.random.default_rng(seed)
    n = n_query + n_gallery
    pids = np.arange(n) % n_ids
    cams = rng.integers(0, 6, n)
    base = rng.integers(0, 256, (n_ids, 3)).astype(np.int16)
    imgs = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        noise = rng.integers(-40, 40, (e - s, h, w, 3), dtype=np.int16)
        imgs[s:e] = np.clip(base[pids[s:e]][:, None, None] + noise, 0, 255)
    fnames = [f"{pids[i]:04d}_c{cams[i] + 1}_{i:06d}.jpg" for i in range(n)]
    items = [(fnames[i], int(pids[i]), int(cams[i])) for i in range(n)]
    batches = [{"img": imgs[s:s + batch], "fname": fnames[s:s + batch],
                "pid": pids[s:s + batch]} for s in range(0, n, batch)]
    return batches, items[:n_query], items[n_query:]


def _plain_rank_metrics(x, y, query, gallery, topk=100):
    """The main path's rank metrics through the plain rank pass."""
    from reid_gan_torch.engine.metrics import rank_stats_plain
    from reid_gan_torch.ops.distance import squared_euclidean

    ids = lambda items, k: torch.tensor([it[k] for it in items],  # noqa: E731
                                        dtype=torch.int32, device="cuda")
    d = squared_euclidean(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    ap, fb, nm = rank_stats_plain(d, ids(query, 1), ids(query, 2),
                                  ids(gallery, 1), ids(gallery, 2))
    has = nm > 0
    hist = torch.bincount(fb[has & (fb < topk)].long(), minlength=topk).double()
    valid = int(has.sum())
    return hist.cpu().numpy().cumsum() / valid, float(ap[has].double().sum()) / valid


# Device work by kind, matched on kernel names in this order
PROFILE_GROUPS = (
    ("K1 eval_transform", ("eval_transform_kernel",)),
    ("K2 gem_bn_l2n", ("gem_bn_l2n_kernel",)),
    ("K4 train_augment", ("train_augment_kernel", "erase_fill_kernel")),
    ("K5 gem_pool", ("gem_pool_forward_kernel", "gem_pool_backward_kernel",
                     "gem_pool_dp_kernel")),
    ("K6 infonce", ("infonce_logits_kernel", "infonce_lse_kernel", "infonce_dl_kernel",
                    "infonce_dxh_kernel", "infonce_l2n_backward_kernel")),
    ("K7 bank_fold", ("bank_fold_kernel",)),
    ("K9 gan_input", ("gan_input_kernel",)),
    ("K10 pose_maps", ("pose_maps_kernel",)),
    ("K11 gan_feat_l2n", ("gan_feat_l2n_kernel",)),
    ("K12 diff_transform", ("diff_transform_kernel",)),
    ("K13 pose_peaks", ("pose_peaks_kernel", "pose_peaks_vec_kernel")),
    ("K14 fd_augment", ("fd_augment_kernel",)),
    ("batchnorm", ("bn_fw", "bn_bw", "batchnorm", "batch_norm")),
    ("host-to-device copy", ("Memcpy HtoD",)),
    ("Adam (multi-tensor)", ("multi_tensor_apply",)),
    ("attention softmax", ("softmax",)),
    ("convolution and matmul", ("xmma", "gemm", "conv", "implicit", "dgrad", "wgrad",
                                "cutlass", "sm90", "nvjet")),
    ("max pool", ("max_pool",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise (ReLU, add, casts)", ("elementwise_kernel",)),
)


# The IBN phases' extra groups, matched ahead of PROFILE_GROUPS: the split's
# concatenation and the copies of its halves into one memory format
IBN_GROUPS = (
    ("concatenate (torch.cat)", ("CatArrayBatchedCopy",)),
    ("copy (contiguous, memory format)", ("direct_copy_kernel",)),
)


def profile_device(label, fn, groups=(), ops=()):
    """Run ``fn`` under ``torch.profiler``: device time by group and kernel,
    and the share of the window (first device event to last) in which the
    card ran nothing. ``groups`` are matched ahead of ``PROFILE_GROUPS``;
    ``ops`` names host operators whose device time (their kernels', as the
    profiler links them) is printed too. Returns the busy ms, or None when
    the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return report_profile(label, prof, groups, ops)


def report_profile(label, prof, groups=(), ops=()):
    """``profile_device``'s report of a finished ``torch.profiler`` run
    ``prof``. Returns the busy ms, or None when it saw no device events."""
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA))
    if not dev:
        print(f"[profile] {label}: the profiler saw no device events: "
              "breakdown not measured")
        return None
    busy, reach, by_name = 0.0, dev[0][0], {}
    for start, end, name in dev:
        busy += max(0.0, end - max(start, reach))   # union of the intervals
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    span = reach - dev[0][0]
    print(f"[profile] {label}: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms window, idle share {1 - busy / span:.4f}")
    by_group = {}
    for name, us in by_name.items():
        group = next((g for g, keys in tuple(groups) + PROFILE_GROUPS
                      if any(k in name for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + us
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label} group {group}: {us / busy:.2%} ({us / 1e3:.3f} ms)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] {label} {us / busy:7.2%} {us / 1e3:9.3f} ms  {name[:110]}")
    for op in ops:
        us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages() if e.key == op)
        print(f"[profile] {label} op {op}: {us / busy:.2%} ({us / 1e3:.3f} ms of device "
              f"time under the operator)")
    return busy / 1e3


def _split_by_marks(marks, steps):
    """Device ms per phase, each step's (phase, CUDA event) marks in order
    (``trainer.marks``), averaged over ``steps``."""
    split, total = {}, 0.0
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name != "start":
            ms = a.elapsed_time(b)
            split[name] = split.get(name, 0.0) + ms / steps
            total += ms / steps
    return ", ".join(f"{k} {v:.3f} ({v / total:.1%})" for k, v in split.items())


def phase_main_path(counts, arch="resnet50", label="main", dtype=None):
    """The eval main path on a random ``arch`` (its backbone in bf16 with
    ``dtype``, ``--fp16``); returns the warm extraction rate in img/s."""
    from reid_gan_torch import kernels
    from reid_gan_torch.engine.evaluators import (
        Evaluator,
        FeatureExtractor,
        extract_features,
    )
    from reid_gan_torch.engine.metrics import rank_metrics_features
    from reid_gan_torch.models import create
    from reid_gan_torch.models.pooling import gem_bn_l2n_plain
    from reid_gan_torch.models.resnet import ResNetBackbone
    from reid_gan_torch.ops.transforms import eval_transform_plain

    torch.backends.cudnn.allow_tf32 = True   # as cli/test.py sets it
    batches, query, gallery = _eval_set()
    torch.manual_seed(0)
    model = create(arch, dtype=dtype)        # GeM, last stride 1, fp32 weights
    extractor = FeatureExtractor(model, height=256, width=128, batch_size=256,
                                 device="cuda")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, mAP = Evaluator(extractor).evaluate(batches, query, gallery,
                                                cmc_flag=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update({k: v for k, v in kernels.launch_counts().items()
                   if k in ("eval_transform", "gem_bn_l2n", "rank_stats")})
    n_img = len(query) + len(gallery)
    print(f"[{label}] {arch}: Evaluator.evaluate on {n_img} images (1st run, cuDNN "
          f"cold): {wall:.2f} s; mAP {mAP:.4f} top-1 {scores[0]:.4f} "
          f"top-5 {scores[4]:.4f} top-10 {scores[9]:.4f}")
    print(f"[{label}] launches: {counts}")
    check(all(v > 0 for v in counts.values()), f"a kernel did not launch: {counts}")
    check(0.0 <= mAP <= 1.0 and np.all(np.diff(scores) >= 0), "bad metrics")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    features, _ = extract_features(extractor, batches)
    torch.cuda.synchronize()
    ext = time.perf_counter() - t0
    print(f"[{label}] extraction (warm): {n_img / ext:.1f} img/s ({arch}"
          f"{', bf16 backbone' if dtype is not None else ''})")
    ibn = arch.startswith("resnet_ibn")
    profile_device(f"extraction ({arch})", lambda: extract_features(extractor, batches),
                   groups=IBN_GROUPS if ibn else (FP16_GROUPS if dtype is not None else ()),
                   ops=("aten::instance_norm", "aten::cat") if ibn else ())
    if ibn:
        _ibn_cost(label, extractor.model, train=False)
    x = np.stack([features[f] for f, _, _ in query])
    y = np.stack([features[f] for f, _, _ in gallery])
    norms = np.linalg.norm(np.concatenate([x, y]), axis=1)
    check(x.shape == (len(query), 2048) and np.all(np.isfinite(x))
          and np.all(np.isfinite(y)) and np.all(np.abs(norms - 1) < 1e-4),
          "features are not finite unit vectors of width 2048")

    # one batch through the plain versions of K1 and K2 on the card
    img = torch.from_numpy(batches[0]["img"]).cuda()
    with torch.inference_mode():
        xin = eval_transform_plain(img, torch.bfloat16).float()
        fmap = ResNetBackbone.forward(extractor.model, xin)
        bn = extractor.model.feat_bn
        ref = gem_bn_l2n_plain(fmap, extractor.model.gap.p, bn.weight,
                               bn.running_mean, bn.running_var)
    got = torch.from_numpy(np.stack([features[f] for f in batches[0]["fname"]])).cuda()
    err = float((got - ref).abs().max())
    tol = 1e-4   # K2's sum order; a pixel where K1's bf16 rounding differs
    print(f"[{label}] batch 0 features vs plain K1/K2 path: max_abs_err {err:.3g} "
          f"(tol {tol:.3g})")
    check(err <= tol, f"main-path features differ from the plain path: {err}")

    cmc_k, map_k = rank_metrics_features(
        x, y, [p for _, p, _ in query], [p for _, p, _ in gallery],
        [c for _, _, c in query], [c for _, _, c in gallery], device="cuda")
    cmc_p, map_p = _plain_rank_metrics(x, y, query, gallery)
    print(f"[{label}] rank metrics kernel vs plain: mAP {map_k:.6f} vs {map_p:.6f}, "
          f"top-1 {cmc_k[0]:.6f} vs {cmc_p[0]:.6f}")
    check(np.array_equal(cmc_k, cmc_p) and abs(map_k - map_p) <= 1e-6,
          "rank metrics differ from the plain rank pass")
    return n_img / ext


def _in_memory_images(imgs, gan_imgs=None, old_size=(256.0, 128.0)):
    """The loader's image source of staged arrays
    (``reid_gan_torch.data.in_memory.InMemoryImages``)."""
    from reid_gan_torch.data.in_memory import InMemoryImages

    return InMemoryImages(imgs, gan_imgs, old_size)


@functools.lru_cache(maxsize=1)
def _pseudo_set(seed=0, n_ids=700, per_id=18, h=256, w=128):
    """A pseudo-labelled train set in memory: 700 ids x 18 images, 6
    cameras, a base colour per id plus noise, staged at 256x128 (made once
    and shared by the phases that train on it; none writes to it)."""
    rng = np.random.default_rng(seed)
    n = n_ids * per_id
    pids = np.repeat(np.arange(n_ids), per_id)
    cams = rng.integers(0, 6, n)
    base = rng.integers(0, 256, (n_ids, 3)).astype(np.int16)
    noise = rng.integers(-40, 40, (64, h, w, 3), dtype=np.int16)
    imgs = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, 64):
        e = min(s + 64, n)
        imgs[s:e] = np.clip(base[pids[s:e]][:, None, None] + noise[:e - s], 0, 255)
    items = [(f"{pids[i]:04d}_c{cams[i] + 1}_{i:06d}.jpg", int(pids[i]), int(cams[i]))
             for i in range(n)]
    return items, imgs


def _compare_step(trainer, state, batch, label="train"):
    """One step's loss, feature gradient, GeM p gradients (K5's backward)
    and folded bank through the kernels (the model's own forward:
    K4, K5, K6, K7, in the trainer's fold mode) and through the plain
    versions (the same forward under
    ``_plain_heads``), from the same parameters, bank and draws. cuDNN's
    TF32 is off on both sides, so the two differ only by the kernels'
    arithmetic."""
    from reid_gan_torch.ops.cluster_memory import (
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

    model, dev, h, w = trainer.model, trainer.device, trainer.height, trainer.width
    img = torch.from_numpy(batch["img"]).to(dev)
    y = torch.from_numpy(batch["pid"].astype(np.int32)).to(dev)
    params = sample_augment_params(img.shape[0], h, w,
                                   torch.Generator(device=dev).manual_seed(99))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    model.zero_grad(set_to_none=True)    # the trainer's last step leaves its gradients
    try:
        results = []
        for plain in (False, True):
            mem = state.memory._replace(features=state.memory.features.clone(),
                                        gan_features=state.memory.gan_features.clone())
            if plain:
                x = train_augment_plain(img, params)
                with _plain_heads():
                    feat = model(x, with_gan_feat=False)["feat"]
            else:
                x = train_augment(img, params, h, w)
                feat = model(x, with_gan_feat=False)["feat"]
            feat.retain_grad()
            loss = (memory_loss_plain if plain else memory_loss)(feat, y, mem)[0].mean()
            loss.backward()
            (update_memory_plain if plain else update_memory)(
                mem, feat.detach(), y, use_hard=trainer.use_hard)
            grads = torch.cat([q.grad.flatten() for n, q in model.named_parameters()
                               if n.rsplit(".", 1)[-1] == "p" and q.grad is not None])
            model.zero_grad(set_to_none=True)
            results.append((float(loss.detach()), feat.grad, grads, mem.features))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lk, gk, wk, bk), (lp, gp, wp, bp) = results
    e_loss = abs(lk - lp)
    e_g = float((gk - gp).abs().max() / gp.abs().max())
    e_w = float((wk - wp).norm() / wp.norm())
    e_bank = float((bk - bp).abs().max())
    # fp32 ResNet-50 on inputs that differ by K4's rounding, then temp 0.05
    tol_loss, tol_g, tol_w, tol_bank = 1e-3, 1e-3, 1e-3, 1e-4
    print(f"[{label}] one step, kernels vs plain versions (TF32 off, "
          f"{'hard' if trainer.use_hard else 'plain'} fold): loss {lk:.6f} "
          f"vs {lp:.6f} (err {e_loss:.3g}, tol {tol_loss:.3g}); feat grad rel err "
          f"{e_g:.3g} (tol {tol_g:.3g}); GeM p grads rel err (2-norm, {wp.numel()} "
          f"of them) {e_w:.3g} (tol {tol_w:.3g}); folded bank "
          f"max_abs_err {e_bank:.3g} (tol {tol_bank:.3g})")
    check(e_loss <= tol_loss and e_g <= tol_g and e_w <= tol_w and e_bank <= tol_bank,
          "the train step through the kernels differs from the plain versions")


def phase_train(counts, arch="resnet50", use_hard=False, label="train"):
    """The train main path: ``ClusterContrastTrainer.train`` on a random
    ``arch`` (ResNet-50), K7 in its hard mode with ``use_hard``."""
    from reid_gan_torch import kernels
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.engine.usl import bank_rows, make_train_loader
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.cluster_memory import init_memory

    t0 = time.perf_counter()
    items, imgs = _pseudo_set()
    n_ids = 700
    g = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((n_ids, 2048), device="cuda", generator=g), dim=1)
    memory = init_memory(centers, k_pad=bank_rows(n_ids), device="cuda")
    torch.manual_seed(0)
    model = create(arch, norm=True)                  # GeM, last stride 1, fp32
    trainer = ClusterContrastTrainer(model, height=256, width=128, use_hard=use_hard,
                                     num_instances=16, device="cuda")
    state = trainer.init_state(memory)
    loader = make_train_loader(items, 256, 128, 256, 16, workers=4, iters=400,
                               seed=1, cache=_in_memory_images(imgs))
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    print(f"[{label}] {arch}, {'hard' if use_hard else 'plain'} fold; set-up (data "
          f"{len(items)} images, bank {tuple(memory.features.shape)}, "
          f"{memory.num_valid.item()} live): {time.perf_counter() - t0:.1f} s")

    steps = 20
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = trainer.train(state, 0, loader, train_iters=steps, print_freq=10,
                                base_seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update({k: v for k, v in kernels.launch_counts().items()
                   if k in ("train_augment", "gem_pool", "infonce", "bank_fold")})
    phases = kernels.phase_launch_counts()
    print(f"[{label}] {steps} steps (1st, cuDNN cold): {wall:.2f} s, mean loss {loss:.4f}")
    print(f"[{label}] launches: {phases}")
    for name in ("train_augment.forward", "gem_pool.forward", "gem_pool.backward",
                 "infonce.forward", "infonce.backward", "bank_fold.forward"):
        check(phases[name] == steps, f"{name} launched {phases[name]} times, "
                                     f"not once per step")
    check(np.isfinite(loss), f"loss is not finite: {loss}")
    still = [n for n, p in model.named_parameters() if p.requires_grad
             and torch.equal(p.detach(), before[n])]
    check(not still, f"parameters that did not move: {still[:5]}")
    norms = state.memory.features[:n_ids].norm(dim=1)
    err = float((norms - 1).abs().max())
    print(f"[{label}] {len(before)} parameter tensors all moved; bank rows' norm - 1: "
          f"max {err:.3g}")
    check(err <= 1e-5, "bank rows are not unit vectors after the fold")

    _compare_step(trainer, state, loader.next(), label)

    warm = 10
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.train(state, 1, loader, train_iters=warm, print_freq=warm,
                             base_seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[{label}] warm: {warm / dt:.3f} steps/s, {warm * 256 / dt:.1f} img/s "
          f"(batch 256, 256x128, {arch}, fp32 weights, TF32 convolutions); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ibn = arch.startswith("resnet_ibn")
    busy = profile_device(f"{label} (3 warm steps)", lambda: trainer.train(
        state, 2, loader, train_iters=3, print_freq=3, base_seed=1),
        groups=IBN_GROUPS if ibn else (),
        ops=("aten::instance_norm", "aten::cat") if ibn else ())
    if ibn:
        _ibn_cost(label, model, train=True, step_ms=None if busy is None else busy / 3)
    loader.close()


def _ibn_cost(label, model, train, step_ms=None, batch=256):
    """The model's IBN splits timed alone at the shapes a batch of 256 at
    256x128 gives them, forward (and backward with ``train``), against
    ``nn.BatchNorm2d`` of the same width at the same places, on channels_last
    maps as the model runs them: what the split costs beyond the BatchNorm
    it replaces (instance norm, the halves' copies and the concatenation)."""
    from reid_gan_torch.models.resnet import IBN

    shapes = {}

    def count(module, args):
        shape = tuple(args[0].shape)
        shapes[shape] = shapes.get(shape, 0) + 1

    hooks = [m.register_forward_pre_hook(count) for m in model.modules()
             if isinstance(m, IBN)]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.rand((batch, 3, 256, 128), device="cuda").contiguous(
            memory_format=torch.channels_last))
    model.train(was)
    for h in hooks:
        h.remove()
    total = {"IBN": 0.0, "BatchNorm2d": 0.0}
    for shape, n in shapes.items():
        x = torch.randn(shape, device="cuda").contiguous(memory_format=torch.channels_last)
        grad = torch.randn_like(x)
        per = {}
        for name, m in (("IBN", IBN(shape[1])),
                        ("BatchNorm2d", torch.nn.BatchNorm2d(shape[1]))):
            m = m.cuda().train(train)
            if train:
                xg = x.detach().requires_grad_(True)
                per[name] = device_ms(lambda: m(xg).backward(grad))
            else:
                with torch.no_grad():
                    per[name] = device_ms(lambda: m(x))
            total[name] += n * per[name]
        print(f"[{label}] IBN at {shape} x {n}: {per['IBN']:.4f} ms against BatchNorm2d "
              f"{per['BatchNorm2d']:.4f} ms ({'forward and backward' if train else 'forward'})")
    extra = total["IBN"] - total["BatchNorm2d"]
    share = "" if not step_ms else f", {extra / step_ms:.2%} of a step's {step_ms:.3f} ms busy"
    print(f"[{label}] IBN splits: {sum(shapes.values())} at {len(shapes)} shapes, "
          f"{total['IBN']:.3f} ms a batch against {total['BatchNorm2d']:.3f} ms for "
          f"BatchNorm2d at the same places: +{extra:.3f} ms{share}")


def _plain_heads():
    """The kernel wrappers the variants' heads call (K2, K5, K11) swapped for
    their plain versions, for a hold against the model's own forward."""
    import contextlib
    from unittest import mock

    from reid_gan_torch.models import pooling, resnet, resnet_variants

    stack = contextlib.ExitStack()
    for module, name, fn in ((pooling, "gem_pool", pooling.gem_pool_plain),
                             (pooling, "gem_bn_l2n", pooling.gem_bn_l2n_plain),
                             (resnet_variants, "gan_feat",
                              lambda f: resnet.gan_feat_plain(f.detach()))):
        stack.enter_context(mock.patch.object(module, name, fn))
    return stack


def check_variant_maps():
    """K5 (forward and backward) and K2 at the variants' map shapes, batch
    256 x 2048 channels: 8x8 (a half of ``resnet_mp50``'s 16x8 part map) and
    8x4 (its global branch at stride 2), each against its plain version and
    timed beside its bound; then K5 on the two halves of a channels_last
    16x8 map through ``part_map``, the route ``ResNetMP`` takes, its
    gradient reaching the whole map."""
    from reid_gan_torch.models.pooling import (
        gem_bn_l2n,
        gem_bn_l2n_plain,
        gem_pool,
        gem_pool_plain,
    )
    from reid_gan_torch.models.resnet_variants import part_map

    g = torch.Generator(device="cuda").manual_seed(13)
    n, c = 256, 2048
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    mean = torch.rand(c, device="cuda", generator=g) * 0.2
    var = torch.rand(c, device="cuda", generator=g) + 0.5
    p3 = torch.tensor([3.0], device="cuda")
    gout = torch.randn((n, c), device="cuda", generator=g) / n
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731

    def grads(fn, fmap):
        x = fmap.detach().requires_grad_(True)
        p = p3.clone().requires_grad_(True)
        out = fn(x, p)
        out.backward(gout)
        return out.detach(), x.grad, p.grad

    for h, w in ((8, 8), (8, 4)):
        fmap = torch.relu(torch.rand((n, c, h, w), device="cuda", generator=g) * 2 - 0.6)
        fmap = fmap.contiguous(memory_format=torch.channels_last)
        (o, dx, dp), (o_r, dx_r, dp_r) = grads(gem_pool, fmap), grads(gem_pool_plain, fmap)
        e5 = (rel(o, o_r), rel(dx, dx_r), abs(float(dp - dp_r)) / abs(float(dp_r)))
        out = gem_bn_l2n(fmap, p3, gamma, mean, var)
        e2 = float((out - gem_bn_l2n_plain(fmap, p3, gamma, mean, var)).abs().max())
        torch.cuda.synchronize()
        print(f"[variants] K5 at {h}x{w}: rel err forward {e5[0]:.3g}, d map {e5[1]:.3g} "
              f"(tol 1e-05), dp {e5[2]:.3g} (tol 0.001); K2 at {h}x{w}: max_abs_err "
              f"{e2:.3g} (tol 1e-05)")
        check(max(e5[:2]) <= 1e-5 and e5[2] <= 1e-3 and e2 <= 1e-5,
              f"K5 or K2 at {h}x{w} differs from its plain version")
        x = fmap.detach().requires_grad_(True)
        pp = p3.clone().requires_grad_(True)
        t = _time_phases(lambda: gem_pool(x, pp), (x, pp), gout)
        k5_plain = device_ms(lambda: torch.autograd.grad(gem_pool_plain(x, pp), (x, pp), gout))
        bf, _ = bound_ms(4 * (fmap.numel() + 2 * n * c), 4 * fmap.numel())
        bb, _ = bound_ms(4 * (2 * fmap.numel() + 3 * n * c), 4 * fmap.numel())
        k2 = device_ms(lambda: gem_bn_l2n(fmap, p3, gamma, mean, var))
        k2_plain = device_ms(lambda: gem_bn_l2n_plain(fmap, p3, gamma, mean, var))
        b2, by2 = bound_ms(4 * (fmap.numel() + 3 * c + 1 + n * c), 3 * fmap.numel())
        print(f"[variants] K5 at {h}x{w}: forward ms {t['forward_ms']:.4f} backward ms "
              f"{t['backward_ms']:.4f} together {t['ms']:.4f} bound_ms {bf + bb:.4f} "
              f"(bytes, {(bf + bb) / t['ms']:.1%}) plain_ms {k5_plain:.4f}; K2 at {h}x{w}: "
              f"ms {k2:.4f} bound_ms {b2:.4f} ({by2}, {b2 / k2:.1%}) plain_ms {k2_plain:.4f}")

    full = torch.relu(torch.rand((n, c, 16, 8), device="cuda", generator=g) * 2 - 0.6)
    full = full.contiguous(memory_format=torch.channels_last)
    res = []
    for fn, part in ((gem_pool, part_map), (gem_pool_plain, lambda m, a, b: m[:, :, a:b])):
        x = full.detach().requires_grad_(True)
        p = p3.clone().requires_grad_(True)
        halves = [fn(part(x, 0, 8), p), fn(part(x, 8, 16), p)]
        sum((hv * gout).sum() for hv in halves).backward()
        res.append((torch.cat([hv.detach() for hv in halves], 1), x.grad, p.grad))
    torch.cuda.synchronize()
    (o, dx, dp), (o_r, dx_r, dp_r) = res
    errs = (rel(o, o_r), rel(dx, dx_r), abs(float(dp - dp_r)) / abs(float(dp_r)))
    print(f"[variants] K5 on the halves of a channels_last (256, 2048, 16, 8) map through "
          f"part_map: rel err forward {errs[0]:.3g}, d map {errs[1]:.3g} (tol 1e-05), dp "
          f"{errs[2]:.3g} (tol 0.001)")
    check(max(errs[:2]) <= 1e-5 and errs[2] <= 1e-3, "K5 on part maps differs from plain")


# (factory name, keyword arguments, GeMs a step: K5 launches per step, the
# parameters the USL loss cannot reach: bip's second branch, which the fused
# feature weighs by 1 - output_balance = 0, bipd's GAN branch, mp's GAN
# projection and predictor, none of whose outputs the loss reads)
VARIANT_RUNS = (("resnet_bip50", {}, 2, ("p2_", "gap2.", "feat_bn2.")),
                ("resnet_bipd50", {}, 1, ("p2_",)),
                ("resnet_mp50", {"fusion": "sum"}, 3, ("proj_gan.",)),
                ("resnet_mp50", {"fusion": "sum", "need_predictor": True}, 3,
                 ("proj_gan.", "predictor.")))


def phase_variants():
    """``[variants]``: K5 and K2 at the variants' map shapes, then for each
    backbone variant at full width (random weights, ``norm`` on): one eval
    batch of 256 at 256x128 held against the same forward through the plain
    heads (K2 ``bip``/``bipd``, K5 ``mp``), then 3 USL steps of batch 256
    (16 x 16) on phase 4's set with their launches (K5 forward and backward
    once per GeM per step; K4, K6, K7 once a step), a finite loss, every
    parameter the loss reaches moved, one step held against the plain
    versions, the peak memory and 3 warm steps timed."""
    from reid_gan_torch import kernels
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.engine.usl import bank_rows, make_train_loader
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.ops.transforms import eval_transform

    check_variant_maps()
    t_phase = time.perf_counter()
    img = torch.from_numpy(_eval_set()[0][0]["img"]).cuda()
    items, imgs = _pseudo_set()
    n_ids, steps = 700, 3
    for name, kw, n_gem, unreached in VARIANT_RUNS:
        tag = f"[variants] {name}" + "".join(f" {k}={v}" for k, v in kw.items())
        torch.manual_seed(0)
        model = create(name, norm=True, **kw).to("cuda", memory_format=torch.channels_last)
        model.eval()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.inference_mode():
                x = eval_transform(img, 256, 128, torch.bfloat16).float()
                kernels.reset_launch_counts()
                got = model(x)
                launched = {k: v for k, v in kernels.phase_launch_counts().items() if v}
                with _plain_heads():
                    ref = model(x)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.synchronize()
        want = {"gem_pool.forward": 3} if name == "resnet_mp50" else \
            {"gem_bn_l2n.forward": 2 if name == "resnet_bip50" else 1}
        err = float((got - ref).abs().max())
        print(f"{tag}: eval batch of 256 at 256x128, features vs the plain heads (TF32 "
              f"off): max_abs_err {err:.3g} (tol 0.0001); launches {launched}")
        check(got.shape == (256, 2048) and bool(torch.isfinite(got).all()) and err <= 1e-4
              and launched == want, f"{name} eval differs from its plain heads or "
                                    f"launched {launched}, not {want}")

        gen = torch.Generator(device="cuda").manual_seed(0)
        centers = torch.nn.functional.normalize(
            torch.randn((n_ids, 2048), device="cuda", generator=gen), dim=1)
        trainer = ClusterContrastTrainer(model, height=256, width=128, num_instances=16,
                                         device="cuda")
        state = trainer.init_state(init_memory(centers, k_pad=bank_rows(n_ids), device="cuda"))
        loader = make_train_loader(items, 256, 128, 256, 16, workers=4, iters=400, seed=1,
                                   cache=_in_memory_images(imgs))
        before = {n: p.detach().clone() for n, p in model.named_parameters()
                  if p.requires_grad}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state, loss = trainer.train(state, 0, loader, train_iters=steps, print_freq=steps,
                                    base_seed=1)
        torch.cuda.synchronize()
        phases = kernels.phase_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"gem_pool.forward": steps * n_gem, "gem_pool.backward": steps * n_gem,
                "train_augment.forward": steps, "infonce.forward": steps,
                "infonce.backward": steps, "bank_fold.forward": steps}
        bad = {k: phases[k] for k, v in want.items() if phases[k] != v}
        reached = [n for n in before if not n.startswith(unreached)]
        params = dict(model.named_parameters())
        still = [n for n in reached if torch.equal(params[n].detach(), before[n])]
        print(f"{tag}: {steps} USL steps (1st, cuDNN cold), mean loss {loss:.4f}; "
              f"launches per step K5 forward {phases['gem_pool.forward'] / steps:g}, "
              f"backward {phases['gem_pool.backward'] / steps:g}, K4 "
              f"{phases['train_augment.forward'] / steps:g}, K6 "
              f"{phases['infonce.forward'] / steps:g}, K7 {phases['bank_fold.forward'] / steps:g};"
              f" {len(reached) - len(still)} of the {len(reached)} parameter tensors the "
              f"loss reaches moved ({len(before) - len(reached)} it cannot reach: "
              f"{', '.join(unreached)}); peak {peak:.3f} GiB")
        check(not bad, f"{name}: launches {bad}, not {want}")
        check(np.isfinite(loss) and not still, f"{name}: loss {loss} or parameters that "
                                               f"did not move: {still[:5]}")
        _compare_step(trainer, state, loader.next(), tag[1:].replace("]", "", 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train(state, 1, loader, train_iters=steps, print_freq=steps,
                                 base_seed=1)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        print(f"{tag}: warm {dt * 1e3:.1f} ms a step, {256 / dt:.1f} img/s (batch 256, "
              f"256x128, fp32 weights, TF32 convolutions)")
        loader.close()
        del model, trainer, state
        torch.cuda.empty_cache()
    print(f"[variants] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _two_colour_images(rng, pids, h=256, w=128):
    """uint8 (N, h, w, 3) images of ids ``pids`` (0 to max): an upper and a
    lower colour block an id from ``rng``, then per-pixel noise from a bank
    of 64 fields (±40) drawn after the colours."""
    colours = rng.integers(0, 256, (int(pids.max()) + 1, 2, 3)).astype(np.int16)
    noise = rng.integers(-40, 40, (64, h, w, 3), dtype=np.int16)
    n = len(pids)
    imgs = np.empty((n, h, w, 3), np.uint8)
    block = np.empty((64, h, 1, 3), np.int16)
    for s in range(0, n, 64):
        e = min(s + 64, n)
        block[:e - s, :h // 2] = colours[pids[s:e], 0][:, None, None]
        block[:e - s, h // 2:] = colours[pids[s:e], 1][:, None, None]
        np.clip(block[:e - s] + noise[:e - s], 0, 255, out=imgs[s:e], casting="unsafe")
    return imgs


def _usl_set(seed=0, n_train=12936, ids=751, n_query=1024, n_gallery=3072,
             eval_ids=256, h=256, w=128):
    """An in-memory dataset at Market-1501's train size (12,936 images of 751
    ids) and the eval set of ``[main]`` (1,024 queries + 3,072 gallery of 256
    other ids), 6 cameras, staged at 256x128. Each id wears two colours, an
    upper and a lower block, so even a random ResNet-50 tells ids apart and
    DBSCAN finds clusters; per-pixel noise (a bank of 64 fields, ±40) makes
    every image of an id different."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    n = n_train + n_query + n_gallery
    pids = np.concatenate([np.arange(n_train) % ids,
                           ids + np.arange(n_query + n_gallery) % eval_ids])
    cams = rng.integers(0, 6, n)
    imgs = _two_colour_images(rng, pids, h, w)
    items = [(f"{pids[i]:04d}_c{cams[i] + 1}_{i:06d}.jpg", int(pids[i]), int(cams[i]))
             for i in range(n)]
    return SimpleNamespace(train=items[:n_train], query=items[n_train:n_train + n_query],
                           gallery=items[n_train + n_query:]), imgs


def knn_fp64(f, k, block=2048):
    """The exact reference of K8's L2 table: the k nearest rows of each row
    of the card's (N, D) features by squared distance in fp64, ties to the
    lower index, as host (N, k) int32."""
    f = f.double()
    sq = (f * f).sum(1)
    out = []
    for s in range(0, f.shape[0], block):
        d = sq[s:s + block, None] + sq[None] - 2.0 * (f[s:s + block] @ f.T)
        out.append(torch.sort(d, dim=1, stable=True)[1][:, :k].to(torch.int32).cpu().numpy())
    return np.concatenate(out)


def _changed_points(a, b):
    """Points whose cluster in ``a`` is not the one most of their ``b``
    cluster went to (noise counts as a cluster of its own)."""
    changed = 0
    for lab in np.unique(b):
        members = a[b == lab]
        vals, counts = np.unique(members, return_counts=True)
        changed += members.size - counts.max()
    return int(changed)


def phase_usl(counts, arch="resnet50", use_hard=False, label="usl", fp16=False):
    """The whole USL epoch through ``cli/train_usl.run``: extraction (K1,
    K2), kNN (K8), Jaccard and DBSCAN (host C++), the bank, 20 P×K steps
    (K4-K7, K7 hard with ``use_hard``), eval (K1-K3) and the checkpoint, on
    a random ``arch``; with ``fp16`` the ``--fp16`` run, without the labels'
    check against the exact kNN."""
    import tempfile

    from reid_gan_torch import kernels
    from reid_gan_torch.cli.train_usl import run
    from reid_gan_torch.clustering.dbscan import dbscan
    from reid_gan_torch.config import Config
    from reid_gan_torch.engine.usl import pseudo_labels_infomap
    from reid_gan_torch.ops.distance import knn_search, knn_search_plain
    from reid_gan_torch.ops.jaccard import jaccard_from_rank
    from reid_gan_torch.utils import Timer

    t_phase = time.perf_counter()
    dataset, imgs = _usl_set()
    cache = _in_memory_images(imgs)
    cfg = Config()                     # the recipe: eps 0.4, min_samples 4, k1 30, k2 6
    cfg.model.arch, cfg.cluster.use_hard, cfg.train.fp16 = arch, use_hard, fp16
    cfg.data.workers = 4
    cfg.train.epochs, cfg.train.iters, cfg.train.eval_step = 1, 20, 1
    print(f"[{label}] --arch {arch}{' --use-hard' if use_hard else ''}"
          f"{' --fp16' if fp16 else ''} --eps "
          f"{cfg.cluster.eps} --k1 {cfg.cluster.k1} --k2 {cfg.cluster.k2}, batch "
          f"{cfg.data.batch_size} of {cfg.data.num_instances} instances")
    print(f"[{label}] data: {len(dataset.train)} train images of 751 ids, "
          f"{len(dataset.query)} + {len(dataset.gallery)} eval, 256x128, made in "
          f"{time.perf_counter() - t_phase:.1f} s; depth cut: 1 epoch of "
          f"{cfg.train.iters} steps instead of {Config().train.iters}")

    clustered = []                     # the epoch's (features, labels)
    with tempfile.TemporaryDirectory() as logs:
        cfg.train.logs_dir = logs
        Timer.spans.clear()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = run(cfg, dataset, device="cuda", image_cache=cache,
                   on_cluster=lambda f, lab: clustered.append((f, lab)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = kernels.phase_launch_counts()
        counts.update(kernels.launch_counts())
        secs = dict(Timer.spans)
        saved = sorted(os.listdir(logs))
    (feats, run_labels), = clustered
    n_clusters, n_train = int(run_labels.max()) + 1, len(dataset.train)
    n_labelled = int((run_labels >= 0).sum())
    print(f"[{label}] run(): {wall:.2f} s, best mAP {best:.4f}; {n_clusters} clusters, "
          f"{n_labelled} of {n_train} images pseudo-labelled; wrote {saved}")
    print(f"[{label}] launches: {phases}")
    check(phases["knn_topk.forward"] == 1, "K8 did not launch once in the clustering")
    for name in ("train_augment.forward", "gem_pool.forward", "gem_pool.backward",
                 "infonce.forward", "infonce.backward", "bank_fold.forward"):
        check(phases[name] == cfg.train.iters, f"{name} launched {phases[name]} times, "
                                               f"not once per step")
    # K1, K2: one per batch of the clustering extraction and of both evals
    # (the epoch's and the best model's); K3: one per 1,024-query chunk of each eval
    batches = -(-n_train // cfg.data.batch_size) + 2 * -(
        -(len(dataset.query) + len(dataset.gallery)) // cfg.data.batch_size)
    for name, want in (("eval_transform.forward", batches), ("gem_bn_l2n.forward", batches),
                       ("rank_stats.forward", 2 * -(-len(dataset.query) // 1024))):
        check(phases[name] == want, f"{name} launched {phases[name]} times, not {want}")
    check(n_clusters >= 16 and n_labelled >= n_train / 2,
          f"too few clusters ({n_clusters}) or pseudo-labels ({n_labelled})")
    check(np.isfinite(best) and {"checkpoint.pth.tar", "model_best.pth.tar"} <= set(saved),
          "no finite mAP or no checkpoint")
    steps = f"{cfg.train.iters} steps"
    split = {"extraction": secs["extract"], "kNN": secs["knn"],
             "Jaccard": secs["jaccard"] - secs["knn"], "DBSCAN": secs["dbscan"],
             "bank": secs["bank"], steps: secs["train"], "eval": secs["eval"]}
    cluster_s = sum(v for k, v in split.items() if k not in (steps, "eval"))
    print(f"[{label}] epoch split (s, host clock): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    # at the 20 steps' mean pace, which carries the new trainer's start: an upper figure
    full, step_s = Config().train.iters, secs["train"] / cfg.train.iters
    print(f"[{label}] projected {full}-step epoch: clustering {cluster_s:.2f} s + {full} steps "
          f"{full * step_s:.2f} s ({step_s:.3f} s a step, the {steps}' mean) + eval "
          f"{split['eval']:.2f} s")
    if fp16:
        print(f"[{label}] phase wall time {time.perf_counter() - t_phase:.1f} s")
        return

    # the labels run() made through K8 against those of the exact (fp64)
    # kNN on the same features, and the plain fp32 version's beside them: on
    # random weights the features nearly collapse (cosines about 0.999), and
    # fp32 rounding alone then moves points, as the plain kNN on its own
    # input jittered by about one part in 10^7 shows
    f_dev = torch.from_numpy(feats).cuda()
    k1, k2 = cfg.cluster.k1, cfg.cluster.k2
    rank = knn_search(f_dev, k1)[1]
    exact_rank = knn_fp64(f_dev, k1)
    plain_vals, plain_rank = knn_search_plain(f_dev, k1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    jit = f_dev * (1 + 1e-7 * torch.randn(f_dev.shape, device="cuda", generator=gen))
    jit_rank = knn_search_plain(jit / jit.norm(dim=1, keepdim=True), k1)[1]
    exact_labels, plain_labels, jit_labels = (
        dbscan(jaccard_from_rank(r, feats, k1, k2), cfg.cluster.eps, cfg.cluster.min_samples)
        for r in (exact_rank, plain_rank, jit_rank))
    rows, gap = _swap_gap(f_dev, rank, plain_vals, plain_rank, "l2")
    swapped = int((rank != exact_rank).any(1).sum())
    changed = _changed_points(run_labels, exact_labels)
    same = np.array_equal(run_labels, exact_labels)
    print(f"[{label}] labels check against the fp64 kNN: K8's table differs in {swapped} "
          f"rows; labels identical: {same}; {changed} of {n_train} points changed cluster "
          f"(the plain fp32 kNN: {int((plain_rank != exact_rank).any(1).sum())} rows, "
          f"{_changed_points(plain_labels, exact_labels)} points; K8 against the plain "
          f"fp32 kNN: {int(np.unique(rows).size)} rows, largest plain-side gap "
          f"{gap:.3g}, {_changed_points(run_labels, plain_labels)} points; the plain fp32 "
          f"kNN against itself on a 1e-7 jitter: "
          f"{int((jit_rank != plain_rank).any(1).sum())} rows, "
          f"{_changed_points(jit_labels, plain_labels)} points)")
    check(same if swapped == 0 else changed < n_train / 100,
          "K8's kNN changes the labels against the exact kNN")
    info = pseudo_labels_infomap(feats, eps=0.5, k1=15, cluster_num=4,
                                 print_flag=False, device="cuda")
    print(f"[{label}] Infomap (eps 0.5, k1 15, through K8's inner product): "
          f"{int(info.max()) + 1} clusters, {int((info < 0).sum())} outliers")
    print(f"[{label}] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _write_pose_csv(items, path, seed):
    """The keypoint CSV of the ``with_gan`` loader for ``items``, keypoints
    from a seed in the 256x128 original frame, a fifth of them missing."""
    rng = np.random.default_rng(seed)
    kp = _keypoints(rng, len(items), np.tile([[256.0, 128.0]], (len(items), 1)))
    with open(path, "w") as f:
        f.write("name:keypoints_y:keypoints_x\n")
        for (fname, _, _), k in zip(items, kp):
            f.write(f"{os.path.basename(fname)}:{json.dumps(k[:, 0].tolist())}:"
                    f"{json.dumps(k[:, 1].tolist())}\n")
    return path


def _compare_joint_step(trainer, state, batch, label="joint"):
    """One joint step's losses, ``feat`` gradient, a G and a D parameter
    gradient and folded bank (and GAN bank, where the state has one, fed the
    pooled GAN map as ``train_all_step`` feeds it) through the kernels
    (K4-K7, K9-K11) and through the plain versions, from the same weights,
    buffers, banks and draws, with cuDNN's TF32 off on both sides; the
    weights and buffers are restored after."""
    import copy

    from reid_gan_torch.models.pooling import gem_pool_plain, l2n
    from reid_gan_torch.models.resnet import ResNetBackbone, gan_feat_plain
    from reid_gan_torch.ops.cluster_memory import (
        memory_loss,
        memory_loss_plain,
        update_memory,
        update_memory_plain,
    )
    from reid_gan_torch.ops.pose import batch_cords_to_map, batch_cords_to_map_plain
    from reid_gan_torch.ops.transforms import (
        gan_input_transform,
        gan_input_transform_plain,
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    model, gan, dev = trainer.model, trainer.gan, trainer.device
    G, D = gan.net_G, gan.net_D
    h, w, gh, gw = trainer.height, trainer.width, gan.h, gan.w
    d = trainer._to_device(batch, "train_all")
    y = d["pid"]
    conf = (torch.arange(y.shape[0], device=dev) % 8 != 0).float()
    params = sample_augment_params(y.shape[0], h, w,
                                   torch.Generator(device=dev).manual_seed(99))
    nets = (model, G, D)
    snap = [copy.deepcopy(m.state_dict()) for m in nets]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    results, vgg_terms = [], []
    try:
        for plain in (False, True):
            for m, sd in zip(nets, snap):
                m.load_state_dict(sd)
            mem = state.memory._replace(features=state.memory.features.clone(),
                                        gan_features=state.memory.gan_features.clone())
            model.train()
            if plain:
                x = train_augment_plain(d["img"], params)
                xs = gan_input_transform_plain(d["Xs"])
                ps = batch_cords_to_map_plain(d["keypoints"], d["old_size"], gh, gw)
                fmap = ResNetBackbone.forward(model, x)
                feat = l2n(model.feat_bn(gem_pool_plain(fmap, model.gap.p)))
                f_gan = gan_feat_plain(fmap.detach())
            else:
                x = train_augment(d["img"], params, h, w)
                xs = gan_input_transform(d["Xs"], gh, gw)
                ps = batch_cords_to_map(d["keypoints"], d["old_size"], gh, gw)
                out = model(x)
                feat, f_gan = out["feat"], out["gan_feat"]
            feat.retain_grad()
            fake = gan.synthesize_p(f_gan, ps, train=True)
            if gan.vgg is not None:
                with torch.no_grad():
                    vgg_terms.append([float(t) for t in gan.vgg(fake, xs)])
            loss_G = gan.get_loss_G_train(fake, xs)
            loss_cl = ((memory_loss_plain if plain else memory_loss)(feat, y, mem)[0]
                       * conf).mean()
            for m in nets:
                m.zero_grad(set_to_none=True)
            (loss_cl + loss_G).backward()
            loss_D = gan.d_loss(xs, fake)
            loss_D.backward()
            gan_x = f_gan.mean(dim=(2, 3)) if mem.gan_features.shape[0] else None
            (update_memory_plain if plain else update_memory)(mem, feat.detach(), y,
                                                              gan_x=gan_x)
            results.append((loss_cl.item(), loss_G.item(), loss_D.item(), feat.grad,
                            G.outconv.conv1.conv.weight.grad.clone(),
                            D.conv.conv.weight.grad.clone(), mem.features,
                            mem.gan_features))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for m, sd in zip(nets, snap):
            m.load_state_dict(sd)
            m.zero_grad(set_to_none=True)
    (ck, gk, dk, fk, ggk, dgk, bk, gbk), (cp, gp, dp, fp, ggp, dgp, bp, gbp) = results
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    e_loss = max(abs(ck - cp) / abs(cp), abs(gk - gp) / abs(gp), abs(dk - dp) / abs(dp))
    e_grad = max(rel(fk, fp), rel(ggk, ggp), rel(dgk, dgp))
    e_bank = float((bk - bp).abs().max())
    e_gan = float((gbk - gbp).abs().max()) if gbk.shape[0] else 0.0
    # fp32 ResNet-50, G and D on inputs that differ by the kernels' rounding
    tol_loss, tol_grad, tol_bank = 1e-3, 1e-3, 1e-4
    gan_bank = f"; folded GAN bank {tuple(gbk.shape)} max_abs_err {e_gan:.3g} (tol " \
        f"{tol_bank:.3g})" if gbk.shape[0] else ""
    print(f"[{label}] one step, kernels vs plain versions (TF32 off): loss_cl {ck:.6f} vs "
          f"{cp:.6f}, G {gk:.6f} vs {gp:.6f}, D {dk:.6f} vs {dp:.6f} (max rel err "
          f"{e_loss:.3g}, tol {tol_loss:.3g}); feat / G outconv / D conv grad max rel "
          f"err {rel(fk, fp):.3g} / {rel(ggk, ggp):.3g} / {rel(dgk, dgp):.3g} (tol "
          f"{tol_grad:.3g}); folded bank max_abs_err {e_bank:.3g} (tol {tol_bank:.3g})"
          + gan_bank)
    check(e_loss <= tol_loss and e_grad <= tol_grad and max(e_bank, e_gan) <= tol_bank,
          "the joint step through the kernels differs from the plain versions")
    if vgg_terms:
        (ck, sk), (cp, sp) = vgg_terms
        e_vgg = max(abs(ck - cp) / abs(cp), abs(sk - sp) / abs(sp))
        tol_vgg = 1e-4      # VGG19 in fp32 on fakes and targets the kernels' ulps move
        print(f"[{label}] VGG terms, kernels vs plain versions (TF32 off): content "
              f"{ck:.6f} vs {cp:.6f}, style {sk:.6e} vs {sp:.6e} (max rel err "
              f"{e_vgg:.3g}, tol {tol_vgg:.3g})")
        check(e_vgg <= tol_vgg, "the VGG terms through the kernels differ from the plain "
                                "versions")


def _joint_trainer(gan_bank=False, iters=400, seed=1, use_vgg=False, dtype=None,
                   arch="resnet50", model_gen="Pose"):
    """The joint step at the recipe's width: a random ``arch`` (ResNet-50:
    GeM, last stride 1, norm on) at 256x128, the ``model_gen`` generator
    (the pose generator) and the discriminator at 128x64, from seed 0; a
    bank of 700 unit rows padded to 768, with a GAN half of as many rows
    with ``gan_bank``; a ``with_gan`` loader of ``iters`` batches of 256 (16
    ids x 16) over phase 4's set with keypoints; with ``use_vgg`` the VGG19
    perceptual loss (random taps from seed 0, the AE defaults' λ_style 500
    and λ_content 0.5); with ``dtype`` bf16 the encoder, G and D compute in
    bf16 (``--fp16``). Returns (trainer, state, loader)."""
    import tempfile

    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.engine.usl import bank_rows, make_train_loader
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.ops.cluster_memory import init_memory

    items, imgs = _pseudo_set()
    n_ids = 700
    g = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((n_ids, 2048), device="cuda", generator=g), dim=1)
    gan_centers = torch.nn.functional.normalize(
        torch.randn((n_ids, 2048), device="cuda", generator=g), dim=1) if gan_bank else None
    memory = init_memory(centers, k_pad=bank_rows(n_ids), gan_centroids=gan_centers,
                         device="cuda")
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="AE", model_gen=model_gen, use_vgg=use_vgg),
                     gan_height=128, gan_width=64, reid_feat_dim=2048, device="cuda",
                     dtype=dtype)
    model = create(arch, norm=True, dtype=dtype)
    trainer = ClusterContrastWithGANTrainer(model, gan, height=256, width=128,
                                            num_instances=16, device="cuda")
    state = trainer.init_state(memory, gan.init_state())
    with tempfile.TemporaryDirectory() as tmp:   # the loader reads the CSV at once
        loader = make_train_loader(
            items, 256, 128, 256, 16, workers=4, iters=iters, seed=seed,
            cache=_in_memory_images(imgs, imgs[:, ::2, ::2]), mode="with_gan",
            gan_height=128, gan_width=64, flip_all=True,
            pose_file=_write_pose_csv(items, os.path.join(tmp, "poses.csv"), 12))
    return trainer, state, loader


def phase_joint(counts):
    """The joint main path: ``ClusterContrastWithGANTrainer.run_epoch`` in
    ``train_all`` mode on ResNet-50, the pose generator and the
    discriminator. Returns the warm step's wall ms."""
    from reid_gan_torch import kernels

    t0 = time.perf_counter()
    trainer, state, loader = _joint_trainer()
    model, gan = trainer.model, trainer.gan
    print(f"[joint] set-up ({len(_pseudo_set()[0])} images at 256x128 and 128x64 with "
          f"keypoints, bank {tuple(state.memory.features.shape)}): "
          f"{time.perf_counter() - t0:.1f} s")

    _compare_joint_step(trainer, state, loader.next())

    nets = {"encoder": model, "G": gan.net_G, "D": gan.net_D}
    before = {(k, n): p.detach().clone() for k, m in nets.items()
              for n, p in m.named_parameters() if p.requires_grad}
    g_stats = {n: b.clone() for n, b in gan.net_G.named_buffers() if "running" in n}
    d_u = {n: b.clone() for n, b in gan.net_D.named_buffers() if n.endswith(".u")}
    steps = 20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, errs = trainer.run_epoch(state, 0, loader, mode="train_all",
                                    train_iters=steps, print_freq=10, base_seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update(kernels.launch_counts())
    phases = kernels.phase_launch_counts()
    print(f"[joint] {steps} train_all steps (1st, cuDNN cold): {wall:.2f} s; mean "
          + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))
    print(f"[joint] launches: {phases}")
    for name in ("train_augment.forward", "gem_pool.forward", "gem_pool.backward",
                 "infonce.forward", "infonce.backward", "bank_fold.forward",
                 "gan_input.forward", "pose_maps.forward", "gan_feat_l2n.forward"):
        check(phases[name] == steps, f"{name} launched {phases[name]} times, "
                                     f"not once per step")
    check(all(np.isfinite(v) for v in errs.values()), f"losses not finite: {errs}")
    still = [k for k, m in nets.items() for n, p in m.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), before[(k, n)])]
    check(not still, f"parameters that did not move: {still[:5]}")
    stats_same = [n for n, b in gan.net_G.named_buffers() if n in g_stats
                  and torch.equal(b, g_stats[n])]
    u_same = [n for n, b in gan.net_D.named_buffers() if n in d_u and torch.equal(b, d_u[n])]
    print(f"[joint] {len(before)} parameter tensors all moved (encoder, G, D); G running "
          f"stats changed: {len(g_stats) - len(stats_same)} of {len(g_stats)}; D u "
          f"changed: {len(d_u) - len(u_same)} of {len(d_u)}")
    check(not stats_same and not u_same, "G's running stats or D's u did not change")
    print(f"[joint] peak device memory (20 steps): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    warm = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.run_epoch(state, 1, loader, train_iters=warm, print_freq=warm,
                                 base_seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[joint] warm: {warm / dt:.3f} steps/s, {warm * 256 / dt:.1f} img/s (batch "
          f"256, ResNet-50 at 256x128 + pose G and D at 128x64, fp32 weights, TF32 "
          f"convolutions)")
    trainer.marks = []
    profile_device("joint (3 warm steps)", lambda: trainer.run_epoch(
        state, 2, loader, train_iters=3, print_freq=3, base_seed=1))
    marks, trainer.marks = trainer.marks, None
    print("[joint] device time by phase (CUDA events, mean of 3 steps, ms): "
          + _split_by_marks(marks, 3))
    loader.close()
    return dt / warm * 1e3


JOINT_RUN_OFF = ("diff_transform", "pose_peaks", "fd_augment")


def phase_joint_run(counts, label="joint", iters=20, vgg_weights=None, flags=None,
                    off=JOINT_RUN_OFF):
    """One epoch of ``cli/train_gan_usl.run`` on the ``[usl]`` set with
    keypoints: extraction (K1, K2), Infomap on K8's inner-product kNN, the
    bank, ``iters`` joint steps (K4-K7, K9-K11), eval (K1-K3), the
    checkpoints and the GAN nets' files. ``vgg_weights``: with ``--use-vgg``,
    random taps ("") or the torchvision-layout file at that path, which the
    engine ``run()`` built must then hold. ``flags``: other ``cfg.model`` and
    ``cfg.gan`` fields (``arch``, ``model_gen``, ``bipath``,
    ``learnable_memory``). Every kernel but those in ``off`` must launch,
    those in ``off`` not. Returns the engine."""
    import tempfile

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.config import Config
    from reid_gan_torch.utils import Timer

    t_phase = time.perf_counter()
    dataset, imgs = _usl_set()
    cfg = Config()
    cfg.data.workers = 4
    cfg.train.epochs, cfg.train.iters, cfg.train.eval_step = 1, iters, 1
    cfg.cluster.cluster_backend, cfg.cluster.eps = "infomap", 0.5
    cfg.cluster.k1, cfg.cluster.k2 = 15, 4
    cfg.gan.model, cfg.gan.model_gen = "AE", "Pose"
    if vgg_weights is not None:
        cfg.gan.use_vgg, cfg.gan.vgg_weights = True, vgg_weights
    for k, v in (flags or {}).items():
        setattr(cfg.model if k == "arch" else cfg.gan, k, v)
    created, create_gan = [], train_gan_usl.create_gan

    def creating(*args, **kwargs):
        created.append(create_gan(*args, **kwargs))
        return created[-1]

    with tempfile.TemporaryDirectory() as tmp:
        dataset.train_pose_dir = _write_pose_csv(dataset.train,
                                                 os.path.join(tmp, "poses.csv"), 13)
        cfg.train.logs_dir = os.path.join(tmp, "logs")
        cfg.gan.save_dir = os.path.join(tmp, "ckpt")
        vgg = "" if vgg_weights is None else (
            f"; --use-vgg with {'--vgg-weights' if vgg_weights else 'random taps'}")
        vgg += "".join(f"; {k} {v}" for k, v in (flags or {}).items())
        print(f"[{label}] run(): data {len(dataset.train)} train images of 751 ids with "
              f"keypoints, {len(dataset.query)} + {len(dataset.gallery)} eval; Infomap "
              f"(eps 0.5, k1 15); depth cut: 1 epoch of {cfg.train.iters} steps{vgg}")
        Timer.spans.clear()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        train_gan_usl.create_gan = creating
        try:
            t0 = time.perf_counter()
            best = train_gan_usl.run(cfg, dataset, device="cuda",
                                     image_cache=_in_memory_images(imgs, imgs[:, ::2, ::2]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            train_gan_usl.create_gan = create_gan
        launches = kernels.launch_counts()
        secs = dict(Timer.spans)
        saved = sorted(os.listdir(cfg.train.logs_dir)) + sorted(
            os.listdir(os.path.join(cfg.gan.save_dir, "experiment")))
    counts.update(launches)
    print(f"[{label}] run(): {wall:.2f} s, best mAP {best:.4f}; wrote {saved}")
    print(f"[{label}] run() launches: {kernels.phase_launch_counts()}")
    check(all(v > 0 for k, v in launches.items() if k not in off)
          and all(launches[k] == 0 for k in off),
          f"all kernels but {', '.join(off)} must launch, those not: {launches}")
    check(np.isfinite(best) and {"checkpoint.pth.tar", "latest_net_G.pth",
                                 "latest_net_D.pth", "iter.txt"} <= set(saved),
          "no finite mAP or a missing checkpoint")
    gan, = created
    check((gan.vgg is not None) == (vgg_weights is not None)
          and (gan.vgg is None or gan.vgg.pretrained == bool(vgg_weights)),
          "the engine run() built has not the VGG loss it was asked for")
    print(f"[{label}] run() epoch split (s, host clock, Timer.spans): "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    print(f"[{label}] run() phase wall time {time.perf_counter() - t_phase:.1f} s")
    return gan


def _hardmix_trainer(items, imgs):
    """The hard-mix step at the recipe's width: a random ResNet-50 (GeM, last
    stride 1, norm on) at 256x128 and the AE generator (ngf 64, img_f 256, 3
    layers, 3 blocks) with the discriminator at 128x64, seed 0; the bank of
    phase 4 and a ``with_gan`` loader (no keypoints: the AE generator reads
    none) of batch 256 as 16 ids x 16."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.engine.usl import bank_rows, make_train_loader
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.ops.cluster_memory import init_memory

    n_ids = 700
    g = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((n_ids, 2048), device="cuda", generator=g), dim=1)
    memory = init_memory(centers, k_pad=bank_rows(n_ids), device="cuda")
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="AE", model_gen="AE"), gan_height=128,
                     gan_width=64, device="cuda")
    model = create("resnet50", norm=True)
    trainer = ClusterContrastWithGANTrainer(model, gan, height=256, width=128,
                                            num_instances=16, device="cuda")
    loader = make_train_loader(items, 256, 128, 256, 16, workers=4, iters=400, seed=1,
                               cache=_in_memory_images(imgs, imgs[:, ::2, ::2]),
                               mode="with_gan", gan_height=128, gan_width=64,
                               flip_all=True)
    return trainer, trainer.init_state(memory, gan.init_state()), loader


def _compare_hardmix_step(trainer, state, batch, seed=99):
    """One hard-mix step through the kernels (``train_step`` itself: K4, K9,
    K5, K12, K2, K6, K7) and the same step composed from the plain versions,
    from the same weights, buffers, bank and draws, with cuDNN's TF32 off:
    the loss, the gradient at ``feat_bn``'s output (the head's, as
    ``feat``'s in the joint check), the gradients of ``gap.p`` and
    ``layer4.2.conv3.weight`` (both behind K5's backward), the folded bank
    and G's running stats after its two folds are held. Two more plain
    steps place the gradients' limit: it must lie above a plain repeat's
    spread (the card's own summation order) and below the reading of a
    plain step whose augmented input is multiplied by (1 + 1e-6 noise).
    ``conv1.weight``'s gradient is printed only: in a random ResNet-50 that
    noise moves it by percents. Weights and buffers are restored after; the
    step's Adam is a throwaway one."""
    import copy

    from reid_gan_torch.models.pooling import gem_bn_l2n_plain, gem_pool_plain, l2n
    from reid_gan_torch.models.resnet import ResNetBackbone
    from reid_gan_torch.ops.cluster_memory import memory_loss_plain, update_memory_plain
    from reid_gan_torch.ops.transforms import (
        diff_transform_plain,
        gan_input_transform_plain,
        sample_augment_params,
        train_augment_plain,
    )

    model, gan, dev = trainer.model, trainer.gan, trainer.device
    G = gan.net_G
    d = trainer._to_device(batch, "train")
    y = d["pid"]
    nets = (model, G)
    snap = [copy.deepcopy(m.state_dict()) for m in nets]
    grad_names = ("gap.p", "layer4.2.conv3.weight", "conv1.weight")
    named = dict(model.named_parameters())
    head = []

    def keep_head(module, inputs, out):   # the train forward's feat_bn output
        if out.requires_grad:
            out.retain_grad()
            head.append(out)

    hook = model.feat_bn.register_forward_hook(keep_head)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    results = []
    try:
        for plain, jitter in ((False, 0.0), (True, 0.0), (True, 0.0), (True, 1e-6)):
            for m, sd in zip(nets, snap):
                m.load_state_dict(sd)
            mem = state.memory._replace(features=state.memory.features.clone(),
                                        gan_features=state.memory.gan_features.clone())
            st = trainer.init_state(mem, state.gan)
            model.zero_grad(set_to_none=True)
            head.clear()
            if not plain:
                st, errs = trainer.train_step(st, d, seed)
                loss = float(errs["loss"])
            else:
                params = sample_augment_params(
                    y.shape[0], trainer.height, trainer.width,
                    torch.Generator(device=dev).manual_seed(seed))
                x = train_augment_plain(d["img"], params)
                if jitter:
                    x = x * (1 + jitter * torch.randn(
                        x.shape, device=dev, generator=torch.Generator(device=dev)
                        .manual_seed(1)).contiguous(memory_format=torch.channels_last))
                xs = gan_input_transform_plain(d["Xs"])
                model.train()
                fmap = ResNetBackbone.forward(model, x)
                feat = l2n(model.feat_bn(gem_pool_plain(fmap, model.gap.p)))
                with torch.no_grad():
                    fc = gan.synthesize_fc(xs, feat.detach(), trainer.num_instances,
                                           train=True)
                    model.eval()
                    fmap_e = ResNetBackbone.forward(
                        model, diff_transform_plain(fc, trainer.height, trainer.width))
                    bn = model.feat_bn
                    f_ex = gem_bn_l2n_plain(fmap_e, model.gap.p, bn.weight,
                                            bn.running_mean, bn.running_var)
                    model.train()
                loss_t = memory_loss_plain(feat, y, mem, ex_f=f_ex,
                                           group_size=trainer.num_instances)[0].mean()
                loss_t.backward()
                update_memory_plain(mem, feat.detach(), y)
                loss = float(loss_t.detach())
            (bn_out,) = head
            grads = [named[n].grad.clone() for n in grad_names]
            stats = torch.cat([b.flatten() for n, b in G.named_buffers() if "running" in n])
            results.append((loss, bn_out.grad, grads, mem.features, stats))
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = tf32
        for m, sd in zip(nets, snap):
            m.load_state_dict(sd)
            m.zero_grad(set_to_none=True)
    (lk, hk, gk, bk, sk), (lp, hp, gp, bp, sp), (_, _, g_rep, _, _), \
        (_, _, g_jit, _, _) = results
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    e_loss = abs(lk - lp) / abs(lp)
    e_head = rel(hk, hp)
    e_grads, e_rep, e_jit = ([rel(a, b) for a, b in zip(g, gp)] for g in (gk, g_rep, g_jit))
    e_bank = float((bk - bp).abs().max())
    e_stats = rel(sk, sp)
    # fp32 ResNet-50 and G on inputs that differ by the kernels' rounding; the
    # extra negatives enter at 1/temp = 20x
    tol_loss, tol_head, tol_grad, tol_bank, tol_stats = 1e-3, 1e-3, 1e-4, 1e-4, 1e-4
    print(f"[hardmix] one step, kernels vs plain versions (TF32 off): loss {lk:.6f} vs "
          f"{lp:.6f} (rel err {e_loss:.3g}, tol {tol_loss:.3g}); feat_bn output grad "
          f"max rel err {e_head:.3g} (tol {tol_head:.3g}); folded bank max_abs_err "
          f"{e_bank:.3g} (tol {tol_bank:.3g}); G running stats rel err {e_stats:.3g} "
          f"(tol {tol_stats:.3g})")
    print(f"[hardmix] parameter grads, max rel err kernels vs plain (plain repeat; "
          f"plain with the input x(1 + 1e-6 noise)), tol {tol_grad:.3g} on gap.p and "
          f"layer4.2.conv3.weight, conv1.weight printed only: " + ", ".join(
              f"{n} {a:.3g} ({b:.3g}; {c:.3g})"
              for n, a, b, c in zip(grad_names, e_grads, e_rep, e_jit)))
    check(e_loss <= tol_loss and e_head <= tol_head and e_bank <= tol_bank
          and e_stats <= tol_stats and max(e_grads[:2]) <= tol_grad,
          "the hard-mix step through the kernels differs from the plain versions")
    check(max(e_rep[:2]) < tol_grad < min(e_jit[:2]),
          f"the gradients' limit {tol_grad:.3g} no longer lies between the plain "
          f"repeat's spread and the 1e-6 input noise's reading")


def phase_hardmix():
    """The AE hard-mix main path: ``ClusterContrastWithGANTrainer.run_epoch``
    in ``train`` mode on ResNet-50 and the AE generator."""
    from reid_gan_torch import kernels

    t0 = time.perf_counter()
    items, imgs = _pseudo_set()
    trainer, state, loader = _hardmix_trainer(items, imgs)
    model, G = trainer.model, trainer.gan.net_G
    print(f"[hardmix] set-up ({len(items)} images at 256x128 and 128x64, bank "
          f"{tuple(state.memory.features.shape)}): {time.perf_counter() - t0:.1f} s")
    _compare_hardmix_step(trainer, state, loader.next())

    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    g_before = {n: b.clone() for n, b in G.state_dict().items()}
    d_before = {n: b.clone() for n, b in trainer.gan.net_D.state_dict().items()}
    steps = 20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, errs = trainer.run_epoch(state, 0, loader, mode="train", train_iters=steps,
                                    print_freq=10, base_seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = kernels.phase_launch_counts()
    print(f"[hardmix] {steps} train steps (1st, cuDNN cold): {wall:.2f} s; mean loss "
          f"{errs['loss']:.4f}")
    print(f"[hardmix] launches: {phases}")
    for name in ("train_augment.forward", "gem_pool.forward", "gem_pool.backward",
                 "infonce.forward", "infonce.backward", "bank_fold.forward",
                 "gan_input.forward", "gem_bn_l2n.forward", "diff_transform.forward"):
        check(phases[name] == steps, f"{name} launched {phases[name]} times, "
                                     f"not once per step")
    for name in ("pose_maps.forward", "gan_feat_l2n.forward"):
        check(phases[name] == 0, f"{name} launched on the hard-mix path")
    check(np.isfinite(errs["loss"]), f"loss not finite: {errs}")
    still = [n for n, p in model.named_parameters() if p.requires_grad
             and torch.equal(p.detach(), before[n])]
    check(not still, f"encoder parameters that did not move: {still[:5]}")
    g_after, d_after = G.state_dict(), trainer.gan.net_D.state_dict()
    stats_moved = sum(not torch.equal(g_after[n], v) for n, v in g_before.items()
                      if "running" in n)
    frozen = all(torch.equal(g_after[n], v) for n, v in g_before.items()
                 if "running" not in n and "num_batches" not in n) and \
        all(torch.equal(d_after[n], v) for n, v in d_before.items())
    n_stats = sum("running" in n for n in g_before)
    print(f"[hardmix] {len(before)} encoder parameter tensors all moved; G's running "
          f"stats changed: {stats_moved} of {n_stats}; G's parameters and D unchanged: "
          f"{frozen}")
    check(stats_moved == n_stats and frozen, "G's stats did not move or G/D changed")
    print(f"[hardmix] peak device memory (20 steps): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    warm = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.run_epoch(state, 1, loader, mode="train", train_iters=warm,
                                 print_freq=warm, base_seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[hardmix] warm: {warm / dt:.3f} steps/s, {warm * 256 / dt:.1f} img/s (batch "
          f"256, ResNet-50 at 256x128 + AE G at 128x64 under no gradient + 16 "
          f"re-encoded images, fp32 weights, TF32 convolutions)")
    trainer.marks = []
    profile_device("hardmix (3 warm steps)", lambda: trainer.run_epoch(
        state, 2, loader, mode="train", train_iters=3, print_freq=3, base_seed=1))
    marks, trainer.marks = trainer.marks, None
    print("[hardmix] device time by phase (CUDA events, mean of 3 steps, ms): "
          + _split_by_marks(marks, 3))
    loader.close()


def _hold_standalone_step(label, gan, xs_u8, cords=None, old=None):
    """One standalone D→G step of ``gan`` (an ``AEModel``) on the uint8 GAN
    batch ``xs_u8`` through K9, and with the PoseAE generator on the pose
    maps of ``cords`` (in frames ``old``) through K10, against the same step
    through their plain versions, from the same weights, TF32 off: the
    losses, the fake, G's output conv and D's last conv gradients. The nets
    are restored after."""
    import copy

    from reid_gan_torch.ops.pose import batch_cords_to_map, batch_cords_to_map_plain
    from reid_gan_torch.ops.transforms import gan_input_transform_plain

    nets = (gan.net_G, gan.net_D)
    snap = [copy.deepcopy(m.state_dict()) for m in nets]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    results = []
    try:
        for plain in (False, True):
            for m, sd in zip(nets, snap):
                m.load_state_dict(sd)
            st = gan.init_state()
            pose = None
            if plain:
                if cords is not None:
                    pose = batch_cords_to_map_plain(cords, old, gan.h, gan.w)
                _, errs, fake = gan.step(st, gan_input_transform_plain(xs_u8), pose=pose)
            else:
                if cords is not None:
                    pose = batch_cords_to_map(cords, old, gan.h, gan.w)
                _, errs, fake = gan.optimize_parameters(st, xs_u8, pose=pose)
            results.append((float(errs["G"]), float(errs["D"]), fake,
                            gan.net_G.decoder.outconv.conv1.conv.weight.grad.clone(),
                            gan.net_D.conv.conv.weight.grad.clone()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for m, sd in zip(nets, snap):
            m.load_state_dict(sd)
            m.zero_grad(set_to_none=True)
    (gk, dk, fk, ggk, dgk), (gp, dp, fp, ggp, dgp) = results
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    e_loss = max(abs(gk - gp) / abs(gp), abs(dk - dp) / abs(dp))
    e_grad = max(rel(ggk, ggp), rel(dgk, dgp))
    e_fake = float((fk - fp).abs().max())
    tol_loss, tol_grad, tol_fake = 1e-4, 1e-3, 1e-4   # K9's ulp through fp32 G and D
    which = "K9" if cords is None else "K9, K10"
    print(f"[{label}] one step, {which} vs the plain versions (TF32 off): G {gk:.6f} vs "
          f"{gp:.6f}, D {dk:.6f} vs {dp:.6f} (max rel err {e_loss:.3g}, tol "
          f"{tol_loss:.3g}); fake max_abs_err {e_fake:.3g} (tol {tol_fake:.3g}); G outconv "
          f"/ D conv grad max rel err {rel(ggk, ggp):.3g} / {rel(dgk, dgp):.3g} (tol "
          f"{tol_grad:.3g})")
    check(e_loss <= tol_loss and e_grad <= tol_grad and e_fake <= tol_fake,
          f"the standalone GAN step through {which} differs from the plain versions")


def phase_warmup():
    """The GAN warm-up's main path: ``GANTrainer.train_gan`` with the AE
    generator and the discriminator at 128x64, batch 256, on an ``only_gan``
    loader of phase 4's set."""
    from reid_gan_torch import kernels
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.data import IterLoader
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.engine.gan_trainers import GANTrainer
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan

    t0 = time.perf_counter()
    items, imgs = _pseudo_set()
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="AE", model_gen="AE"), gan_height=128, gan_width=64,
                     device="cuda")
    pre = Preprocessor(items, mode="only_gan", gan_height=128, gan_width=64,
                       cache=_in_memory_images(imgs, imgs[:, ::2, ::2]))
    it = IterLoader(DataLoader(pre, batch_size=256, shuffle=True, num_workers=4,
                               drop_last=True, seed=1))
    it.new_epoch()
    trainer = GANTrainer(gan, print_freq=10, device="cuda")
    state = gan.init_state()
    print(f"[warmup] set-up ({len(items)} GAN images at 128x64): "
          f"{time.perf_counter() - t0:.1f} s")

    # one step through K9 and through its plain version, TF32 off
    _hold_standalone_step("warmup", gan, torch.from_numpy(
        np.ascontiguousarray(it.next()["Xs"])).cuda())

    before = {(k, n): p.detach().clone() for k, m in (("G", gan.net_G), ("D", gan.net_D))
              for n, p in m.named_parameters()}
    iters = 20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, errs = trainer.train_gan(state, 0, it, train_iters=iters, base_seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[warmup] {iters} D->G iterations (1st, cuDNN cold): {wall:.2f} s; mean "
          + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()))
    print(f"[warmup] launches: {kernels.phase_launch_counts()}")
    check(launches["gan_input"] == iters and
          all(v == 0 for k, v in launches.items() if k != "gan_input"),
          f"the warm-up launched other than K9 once an iteration: {launches}")
    check(all(np.isfinite(v) for v in errs.values()), f"losses not finite: {errs}")
    still = [k for k, m in (("G", gan.net_G), ("D", gan.net_D))
             for n, p in m.named_parameters() if torch.equal(p.detach(), before[(k, n)])]
    check(not still and state.step == iters, f"parameters that did not move: {still[:5]}")
    print(f"[warmup] {len(before)} G and D parameter tensors all moved; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    warm = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.train_gan(state, 1, it, train_iters=warm, base_seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[warmup] warm: {warm / dt:.3f} iterations/s, {warm * 256 / dt:.1f} img/s "
          f"(batch 256, AE G and D at 128x64, fp32 weights, TF32 convolutions)")
    profile_device("warmup (3 warm iterations)", lambda: trainer.train_gan(
        state, 2, it, train_iters=3, base_seed=1))
    it.close()


def phase_hardmix_run(counts):
    """One epoch of ``cli/train_gan_usl.run`` in the hard-mix mode
    (``--model-gen AE --no-gan-train --continue-train``) on the ``[usl]``
    set, from the nets a 4-iteration ``cli/train_gan_warmup.run`` saved:
    extraction (K1, K2), DBSCAN on K8's kNN, the bank, 20 hard-mix steps
    (K4-K7, K9, K12, K2), eval (K1-K3)."""
    import tempfile

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import train_gan_usl, train_gan_warmup
    from reid_gan_torch.config import Config
    from reid_gan_torch.utils import Timer

    t_phase = time.perf_counter()
    dataset, imgs = _usl_set()
    cache = _in_memory_images(imgs, imgs[:, ::2, ::2])
    cfg = Config()                   # the DBSCAN recipe: eps 0.4, min_samples 4, k1 30, k2 6
    cfg.data.workers = 4
    cfg.gan.model, cfg.gan.model_gen, cfg.gan.gan_train = "AE", "AE", False
    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.logs_dir = os.path.join(tmp, "warmup")
        cfg.gan.save_dir = os.path.join(tmp, "ckpt")
        cfg.train.debug = True       # the warm-up: 1 epoch of 4 iterations
        t0 = time.perf_counter()
        train_gan_warmup.run(cfg, dataset, device="cuda", image_cache=cache)
        torch.cuda.synchronize()
        nets = sorted(os.listdir(os.path.join(cfg.gan.save_dir, "experiment")))
        print(f"[hardmix] run(): cli/train_gan_warmup.run (4 iterations) in "
              f"{time.perf_counter() - t0:.2f} s wrote {nets}")
        cfg.train.debug, cfg.gan.continue_train = False, True
        cfg.train.epochs, cfg.train.iters, cfg.train.eval_step = 1, 20, 1
        cfg.train.logs_dir = os.path.join(tmp, "logs")
        print(f"[hardmix] run(): data {len(dataset.train)} train images of 751 ids, "
              f"{len(dataset.query)} + {len(dataset.gallery)} eval; DBSCAN; depth cut: "
              f"1 epoch of {cfg.train.iters} steps")
        Timer.spans.clear()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = train_gan_usl.run(cfg, dataset, device="cuda", image_cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        secs = dict(Timer.spans)
        saved = sorted(os.listdir(cfg.train.logs_dir))
    counts.update(launches)
    print(f"[hardmix] run(): {wall:.2f} s, best mAP {best:.4f}; wrote {saved}")
    print(f"[hardmix] run() launches: {kernels.phase_launch_counts()}")
    off = ("pose_maps", "gan_feat_l2n", "pose_peaks", "fd_augment")
    check(all(v > 0 for k, v in launches.items() if k not in off) and
          all(launches[k] == 0 for k in off),
          f"K1-K9 and K12 must launch, K10, K11, K13 and K14 not: {launches}")
    check(launches["diff_transform"] == cfg.train.iters, "K12 not once a step")
    check(np.isfinite(best) and {"checkpoint.pth.tar", "model_best.pth.tar"} <= set(saved),
          "no finite mAP or a missing checkpoint")
    print("[hardmix] run() epoch split (s, host clock, Timer.spans): "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    print(f"[hardmix] run() phase wall time {time.perf_counter() - t_phase:.1f} s")



# ---------------------------------------------------------------------------
# FD-GAN: K3's variants, K8 for any k, K13, K14, the three stages, the chain
# ---------------------------------------------------------------------------

def _check_test_all_batch():
    """One extraction batch of ``[main]``'s eval set through a
    ``FeatureExtractor(extra_features=True)`` on a random ResNet-50 (K1, K2,
    K11), held against the same model through the plain versions: the
    features and the GAN maps' spatial means. Then the extra work's cost:
    the warm extraction of the eval set without and with ``extra_features``
    in turns, and K11 with the mean alone on one batch's map."""
    from reid_gan_torch.engine.evaluators import FeatureExtractor, extract_features
    from reid_gan_torch.models import create
    from reid_gan_torch.models.pooling import gem_bn_l2n_plain
    from reid_gan_torch.models.resnet import ResNetBackbone, gan_feat, gan_feat_plain
    from reid_gan_torch.ops.transforms import eval_transform_plain

    torch.backends.cudnn.allow_tf32 = True   # as the CLIs set it
    batches, _, _ = _eval_set()
    torch.manual_seed(0)
    model = create("resnet50")
    extractor = FeatureExtractor(model, height=256, width=128, batch_size=256,
                                 device="cuda", extra_features=True)
    img = torch.from_numpy(batches[0]["img"]).cuda()
    (feat, pooled), _ = extractor.dispatch(batches[0]["img"])
    with torch.inference_mode():
        fmap = ResNetBackbone.forward(model, eval_transform_plain(img, torch.bfloat16).float())
        bn = model.feat_bn
        ref = gem_bn_l2n_plain(fmap, model.gap.p, bn.weight, bn.running_mean,
                               bn.running_var)
        ref_pooled = gan_feat_plain(fmap).mean(dim=(2, 3))
    torch.cuda.synchronize()
    e_feat = float((feat - ref).abs().max())
    e_gan = float((pooled - ref_pooled).abs().max())
    # K2's sum order, a pixel where K1's bf16 rounding differs; K11's sums of
    # 2048 squares, averaged over the 128 positions
    tol_feat, tol_gan = 1e-4, 1e-5
    print(f"[gan_clusters] one test_all extraction batch {tuple(img.shape)} vs the plain "
          f"K1/K2/K11 path: feat {tuple(feat.shape)} max_abs_err {e_feat:.3g} (tol "
          f"{tol_feat:.3g}), pooled GAN feature {tuple(pooled.shape)} max_abs_err "
          f"{e_gan:.3g} (tol {tol_gan:.3g})")
    check(e_feat <= tol_feat and e_gan <= tol_gan,
          "the test_all extraction differs from the plain path")

    rates = {False: [], True: []}
    n_img = sum(len(b["fname"]) for b in batches)
    for extra in (False, True, True, False):
        extractor.extra = extra
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_features(extractor, batches)
        torch.cuda.synchronize()
        rates[extra].append(n_img / (time.perf_counter() - t0))
    fmap = fmap.contiguous(memory_format=torch.channels_last)
    extra_ms = device_ms(lambda: gan_feat(fmap).mean(dim=(2, 3)))
    print(f"[gan_clusters] warm extraction of {n_img} images, without / with test_all, "
          f"in turns: {rates[False][0]:.1f}, {rates[True][0]:.1f}, {rates[True][1]:.1f}, "
          f"{rates[False][1]:.1f} img/s (with / without, means: "
          f"{np.mean(rates[True]) / np.mean(rates[False]):.4f}); K11 and the spatial mean "
          f"on one batch's map {tuple(fmap.shape)}: {extra_ms:.4f} ms")


def _check_gan_bank_step():
    """One ``train_all`` step of ``[joint]``'s set-up with a GAN bank beside
    the bank, held against the plain versions by ``_compare_joint_step``:
    both banks after the joint fold."""
    trainer, state, loader = _joint_trainer(gan_bank=True, iters=1, seed=3)
    _compare_joint_step(trainer, state, loader.next(), label="gan_clusters")
    loader.close()


def _plain_reconstruction_losses(gan, pseudo, bank, cfg, pose_file, cache):
    """``reconstruction_losses`` of ``cli/train_gan_usl`` through the plain
    versions of K9 and K10, with G as it is."""
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.ops.pose import batch_cords_to_map_plain
    from reid_gan_torch.ops.transforms import gan_input_transform_plain

    gh, gw = cfg.data.gan_height, cfg.data.gan_width
    loader = DataLoader(Preprocessor(pseudo, mode="only_gan", gan_height=gh, gan_width=gw,
                                     pose_file=pose_file, cache=cache),
                        batch_size=cfg.data.batch_size, drop_last=False,
                        num_workers=cfg.data.workers)
    rec = np.zeros(len(pseudo), np.float32)
    with torch.no_grad():
        for batch in loader:
            xs = gan_input_transform_plain(torch.from_numpy(batch["Xs"]).cuda())
            feats = bank[torch.from_numpy(np.asarray(batch["pid"])).cuda()]
            ps = batch_cords_to_map_plain(torch.from_numpy(batch["keypoints"]).cuda(),
                                          torch.from_numpy(batch["old_size"]).cuda(), gh, gw)
            fake = gan.synthesize_p(feats[:, :, None, None].expand(-1, -1, gh // 8, gw // 8),
                                    ps)
            rec[np.asarray(batch["index"])] = gan.get_L1_loss(fake, xs).cpu().numpy()
    return rec


def phase_gan_clusters(counts):
    """Two epochs of ``cli/train_gan_usl.run`` with ``--cluster-with-gan-features
    --warmup-epo 0`` on the ``[usl]`` set with keypoints: each epoch's
    extraction gives features (K1, K2) and pooled GAN features (K11), Infomap
    clusters the features, the bank gets a GAN half; epoch 1 first scores
    every pseudo-labelled image (K9, K10, the pose generator) for its
    confidence weight; 20 joint steps an epoch fold both banks in one K7
    launch; evals run the same extractor."""
    import copy
    import tempfile

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.config import Config
    from reid_gan_torch.utils import Timer

    t_phase = time.perf_counter()
    _check_test_all_batch()
    _check_gan_bank_step()
    dataset, imgs = _usl_set()
    cfg = Config()
    cfg.data.workers = 4
    cfg.train.epochs, cfg.train.iters, cfg.train.eval_step = 2, 20, 1
    cfg.cluster.cluster_backend, cfg.cluster.eps = "infomap", 0.5
    cfg.cluster.k1, cfg.cluster.k2 = 15, 4
    cfg.gan.model, cfg.gan.model_gen = "AE", "Pose"
    cfg.gan.cluster_with_gan_features, cfg.gan.warmup_epo = True, 0

    spans, banks, scored = [], [], {}
    cluster, rec_fn = train_gan_usl.cluster_epoch, train_gan_usl.reconstruction_losses
    conf_fn = train_gan_usl.compute_conf_weight

    def clustered(*args, **kwargs):            # each epoch's start: the spans so far
        spans.append(dict(Timer.spans))
        out = cluster(*args, **kwargs)
        banks.append((out[0], out[0].gan_features.clone()))
        return out

    def reconstructed(gan, pseudo, memory, cfg, pose_file=None, cache="default"):
        before = kernels.phase_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = rec_fn(gan, pseudo, memory, cfg, pose_file, cache)
        torch.cuda.synchronize()
        after = kernels.phase_launch_counts()
        scored.update(seconds=time.perf_counter() - t0, rec=rec, gan=gan, pseudo=pseudo,
                      bank=memory.features.clone(), args=(cfg, pose_file, cache),
                      G=copy.deepcopy(gan.net_G.state_dict()),
                      launches={k: after[k] - before[k] for k in after if after[k] > before[k]})
        return rec

    def weighed(*args, **kwargs):
        scored["conf"] = conf_fn(*args, **kwargs)
        return scored["conf"]

    with tempfile.TemporaryDirectory() as tmp:
        dataset.train_pose_dir = _write_pose_csv(dataset.train,
                                                 os.path.join(tmp, "poses.csv"), 13)
        cfg.train.logs_dir = os.path.join(tmp, "logs")
        cfg.gan.save_dir = os.path.join(tmp, "ckpt")
        print(f"[gan_clusters] run(): --cluster-with-gan-features --warmup-epo 0; data "
              f"{len(dataset.train)} train images of 751 ids with keypoints, "
              f"{len(dataset.query)} + {len(dataset.gallery)} eval; Infomap (eps 0.5, k1 "
              f"15); depth cut: 2 epochs of {cfg.train.iters} steps")
        train_gan_usl.cluster_epoch = clustered
        train_gan_usl.reconstruction_losses = reconstructed
        train_gan_usl.compute_conf_weight = weighed
        try:
            Timer.spans.clear()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best = train_gan_usl.run(cfg, dataset, device="cuda",
                                     image_cache=_in_memory_images(imgs, imgs[:, ::2, ::2]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            train_gan_usl.cluster_epoch = cluster
            train_gan_usl.reconstruction_losses = rec_fn
            train_gan_usl.compute_conf_weight = conf_fn
        launches, phases = kernels.launch_counts(), kernels.phase_launch_counts()
        spans.append(dict(Timer.spans))
        saved = sorted(os.listdir(cfg.train.logs_dir)) + sorted(
            os.listdir(os.path.join(cfg.gan.save_dir, "experiment")))
        counts.update(launches)
        print(f"[gan_clusters] run(): {wall:.2f} s, best mAP {best:.4f}; wrote {saved}")
        print(f"[gan_clusters] run() launches: {phases}")

        # launches: K11 once an extraction batch (two clusterings, three evals)
        # and once a step; K7 once a step; K9, K10 once a weights batch and a step
        steps, bs = cfg.train.epochs * cfg.train.iters, cfg.data.batch_size
        extract = cfg.train.epochs * -(-len(dataset.train) // bs) + 3 * -(
            -(len(dataset.query) + len(dataset.gallery)) // bs)
        n_scored = len(scored["pseudo"])
        weights_batches = -(-n_scored // bs)
        want = {"gan_feat_l2n.forward": extract + steps, "eval_transform.forward": extract,
                "gem_bn_l2n.forward": extract, "bank_fold.forward": steps,
                "gan_input.forward": weights_batches + steps,
                "pose_maps.forward": weights_batches + steps}
        for name, n in want.items():
            check(phases[name] == n, f"{name} launched {phases[name]} times, not {n}")
        check(scored["launches"] == {"gan_input.forward": weights_batches,
                                     "pose_maps.forward": weights_batches},
              f"the weights pass launched {scored['launches']}")
        check(np.isfinite(best) and {"checkpoint.pth.tar", "latest_net_G.pth",
                                     "iter.txt"} <= set(saved),
              "no finite mAP or a missing checkpoint")
        for epoch, (memory, start) in enumerate(banks):
            k = int(memory.num_valid)
            moved = int(((memory.gan_features[:k] - start[:k]).abs().amax(dim=1) > 0).sum())
            print(f"[gan_clusters] epoch {epoch}: bank {tuple(memory.features.shape)} and GAN "
                  f"bank {tuple(memory.gan_features.shape)}, {k} live rows; {moved} GAN rows "
                  f"moved in {cfg.train.iters} steps")
            check(memory.gan_features.shape == memory.features.shape and moved > 0
                  and not bool(memory.gan_features[k:].any()),
                  "the GAN bank is empty, did not move, or its padding moved")

        # the weights: rec against the plain composition on G as it scored
        # (the loader reads the keypoint CSV, still in ``tmp``)
        gan = scored["gan"]
        gan.net_G.load_state_dict(scored["G"])
        rec, conf = scored["rec"], scored["conf"]
        ref = _plain_reconstruction_losses(gan, scored["pseudo"], scored["bank"],
                                           *scored["args"])
        block = n_scored // cfg.data.num_instances
        ref_conf = np.ones(n_scored, np.float32)
        ref_conf[np.argsort(-ref)[:block]] = 0.0
        e_rec = float(np.abs(rec - ref).max())
        tol = 1e-4 * float(np.abs(ref).max())   # K9, K10 rounding through G's TF32 convolutions
        cut = float(np.sort(rec)[::-1][block - 1])
        differ = np.flatnonzero(conf != ref_conf)
        print(f"[gan_clusters] weights pass: {n_scored} images in {weights_batches} batches, "
              f"{scored['seconds']:.3f} s ({n_scored / scored['seconds']:.1f} img/s); rec "
              f"{rec.min():.4f}-{rec.max():.4f}, max_abs_err vs plain K9/K10 {e_rec:.3g} (tol "
              f"{tol:.3g}); {int((conf == 0).sum())} blocked (n // {cfg.data.num_instances} = "
              f"{block}), cut {cut:.6f}; {differ.size} samples blocked on one side only, "
              f"largest |rec - cut| among them "
              f"{float(np.abs(rec[differ] - cut).max()) if differ.size else 0.0:.3g}")
        check(e_rec <= tol, "the weights pass differs from the plain composition")
        check(int((conf == 0).sum()) == block and np.all(np.abs(rec[differ] - cut) <= tol),
              "the blocked set differs from the plain one away from the cut")
        for epoch in range(cfg.train.epochs):
            split = {k: v - spans[epoch].get(k, 0.0) for k, v in spans[epoch + 1].items()}
            print(f"[gan_clusters] epoch {epoch} split (s, host clock, Timer.spans): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    print(f"[gan_clusters] phase wall time {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# The VGG19 perceptual loss, the DPTN engine and the other generators
# ---------------------------------------------------------------------------

def _torchvision_vgg19_file(vgg, path):
    """Save ``vgg`` (the port's ``VGG19``) in torchvision's ``vgg19`` layout,
    ``features.{i}.weight/bias`` at each conv's index in ``features``, as a
    user's ``--vgg-weights`` file holds it."""
    from reid_gan_torch.models.dual_gan.external_function import _torch_layers

    convs = [i for i, v in enumerate(_torch_layers()) if v == "conv"]
    sd = {}
    for ci, li in enumerate(convs):
        conv = getattr(vgg, f"conv{ci}")
        sd[f"features.{li}.weight"] = conv.weight.detach().cpu()
        sd[f"features.{li}.bias"] = conv.bias.detach().cpu()
    torch.save(sd, path)
    return path


def _turns(label, fn, unit, n, sides=(False, True, True, False), what="VGG"):
    """``fn(side)`` (``n`` ``unit``s) for each side in turns, each timed on
    the host clock (synchronised) with its peak device memory; side True is
    the run with ``what``. Prints and returns ({side: [ms per unit]}, {side:
    peak GiB})."""
    ms, peak, order = {}, {}, []
    for side in sides:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(side)
        torch.cuda.synchronize()
        order.append((time.perf_counter() - t0) * 1e3 / n)
        ms.setdefault(side, []).append(order[-1])
        peak[side] = max(peak.get(side, 0.0), torch.cuda.max_memory_allocated() / 2**30)
    print(f"[{label}] {n} warm {unit}s a turn, without / with {what} in turns: "
          + ", ".join(f"{v:.2f}" for v in order)
          + f" ms per {unit}; means {np.mean(ms[False]):.2f} / {np.mean(ms[True]):.2f} "
          f"(with / without {np.mean(ms[True]) / np.mean(ms[False]):.4f}); peak device "
          f"memory {peak[False]:.2f} / {peak[True]:.2f} GiB")
    return ms, peak


def phase_vgg_joint(counts):
    """``--use-vgg`` on the joint main path: ``[joint]``'s step with the VGG19
    perceptual loss held against the plain versions (the VGG terms too),
    warm steps without and with VGG in turns, the peak memory, VGG's share
    of the step's device time (two profiles); then one epoch of
    ``cli/train_gan_usl.run --use-vgg`` at ``[joint] run()``'s configuration
    with random taps, and a short one with ``--vgg-weights`` pointing at a
    torchvision-layout file of those taps."""
    import tempfile

    t_phase = time.perf_counter()
    trainer, state, loader = _joint_trainer(iters=80, seed=5, use_vgg=True)
    gan = trainer.gan
    vgg = gan.vgg
    print(f"[vgg_joint] the [joint] step with --use-vgg: VGG19 (16 convs; random taps, "
          f"seed 0) on the 256 fakes and GAN images at 128x64, λ_style "
          f"{gan.cfg.lambda_style}, λ_content {gan.cfg.lambda_content}")
    _compare_joint_step(trainer, state, loader.next(), label="vgg_joint")
    for side in (True, False):                       # cuDNN warm on both sides
        gan.vgg = vgg if side else None
        state, errs = trainer.run_epoch(state, 0, loader, train_iters=2, print_freq=2,
                                        base_seed=5)
        check(all(np.isfinite(v) for v in errs.values()), f"losses not finite: {errs}")

    def steps(side):
        gan.vgg = vgg if side else None
        trainer.run_epoch(state, 1, loader, train_iters=5, print_freq=5, base_seed=5)

    ms, _ = _turns("vgg_joint", steps, "step", 5)
    print(f"[vgg_joint] warm: {256e3 / np.mean(ms[True]):.1f} img/s with VGG, "
          f"{256e3 / np.mean(ms[False]):.1f} without (batch 256, ResNet-50 at 256x128 + "
          f"pose G and D at 128x64, fp32 weights, TF32 convolutions)")
    busy = {}
    for side in (True, False):
        gan.vgg = vgg if side else None
        trainer.marks = []
        busy[side] = profile_device(f"vgg_joint (3 warm steps, use_vgg {side})",
                                    lambda: trainer.run_epoch(state, 2, loader,
                                                              train_iters=3, print_freq=3,
                                                              base_seed=5))
        marks, trainer.marks = trainer.marks, None
        print(f"[vgg_joint] device time by phase, use_vgg {side} (CUDA events, mean of 3 "
              f"steps, ms): " + _split_by_marks(marks, 3))
    gan.vgg = vgg
    if busy[True] and busy[False]:
        print(f"[vgg_joint] VGG's share of the step's device time (profiles, busy with / "
              f"without): {1 - busy[False] / busy[True]:.4f} ({busy[True] / 3:.3f} / "
              f"{busy[False] / 3:.3f} ms a step)")
    loader.close()

    run_counts, weights_counts = {}, {}
    phase_joint_run(run_counts, label="vgg_joint", vgg_weights="")
    with tempfile.TemporaryDirectory() as tmp:
        path = _torchvision_vgg19_file(gan.vgg.model, os.path.join(tmp, "vgg19.pth"))
        loaded = phase_joint_run(weights_counts, label="vgg_joint weights", iters=4,
                                 vgg_weights=path)
    same = all(torch.equal(a, b) for a, b in zip(loaded.vgg.model.state_dict().values(),
                                                 gan.vgg.model.state_dict().values()))
    print(f"[vgg_joint] --vgg-weights: the engine run() built holds the file's taps: {same}")
    check(same, "--vgg-weights did not load the file's taps")
    counts.update({k: run_counts[k] + weights_counts[k] for k in run_counts})
    print(f"[vgg_joint] phase wall time {time.perf_counter() - t_phase:.1f} s")


# The two joint modes past train_all: the phase, the mode, the encoder and
# the generator, and the kernels their run() epoch must not launch (the AE
# generator reads no pose maps; neither step pools the GAN map; the memory
# mode folds no bank)
MODE_PHASES = {
    "bip_joint": ("train_all_bip", "resnet_bip50", "AE", {"bipath": True},
                  ("pose_maps", "gan_feat_l2n") + JOINT_RUN_OFF),
    "memory_joint": ("train_all_with_memory", "resnet50", "Pose",
                     {"learnable_memory": True},
                     ("bank_fold", "gan_feat_l2n") + JOINT_RUN_OFF),
}

# Each mode's launches in one step
MODE_STEP_LAUNCHES = {
    "train_all_bip": {"train_augment.forward": 1, "gan_input.forward": 1,
                      "gem_pool.forward": 2, "gem_pool.backward": 2,
                      "infonce.forward": 2, "infonce.backward": 2,
                      "bank_fold.forward": 1, "pose_maps.forward": 0,
                      "gan_feat_l2n.forward": 0},
    "train_all_with_memory": {"train_augment.forward": 1, "gan_input.forward": 1,
                              "pose_maps.forward": 1, "gem_pool.forward": 1,
                              "gem_pool.backward": 1, "infonce.forward": 1,
                              "infonce.backward": 1, "bank_fold.forward": 0,
                              "gan_feat_l2n.forward": 0},
}


def _mode_step(trainer, state, gmem, batch, seed, cluster_lr=0.1):
    """One step of ``trainer.mode`` on a device batch. Returns (state, gmem,
    losses)."""
    if trainer.mode == "train_all_bip":
        state, errs = trainer.train_all_bip_step(state, batch, seed)
        return state, gmem, errs
    return trainer.train_all_with_memory_step(state, gmem, batch, seed, cluster_lr)


def _hold_mode_step(label, trainer, state, gmem, batch, cluster_lr=0.1):
    """One bip or learnable-memory step (``trainer.mode``) run twice from the
    same weights, optimiser states, bank or clusters and draws, with cuDNN's
    TF32 off: through the kernels, then with every kernel wrapper the step
    calls swapped for its plain version (K4, K9, K10, K5 in the heads, K6,
    K7). Held: each K6 call's mean loss, the G and D losses, the encoder's
    GeM p and head-BatchNorm gradients (K5's and K6's backward), a G and a D
    gradient, the bank after K7 (bip) or the clusters after their step
    (memory); the step's launches; for bip, K7 plain and ``--use-hard`` on
    the step's own ``feat + feat2`` rows against their plain versions; for
    memory, the clusters moved on the touched rows only, each by
    ``cluster_lr`` in norm. Everything is restored after."""
    import contextlib
    import copy
    from unittest import mock

    from reid_gan_torch import kernels
    from reid_gan_torch.engine import gan_trainers as gt
    from reid_gan_torch.ops import cluster_memory as cm
    from reid_gan_torch.ops.pose import batch_cords_to_map_plain
    from reid_gan_torch.ops.transforms import (
        gan_input_transform_plain,
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    model, gan, dev, mode = trainer.model, trainer.gan, trainer.device, trainer.mode
    h, w = trainer.height, trainer.width
    d = trainer._to_device(batch, mode)
    y = d["pid"]
    params = sample_augment_params(y.shape[0], h, w,
                                   torch.Generator(device=dev).manual_seed(99))
    nets = (model, gan.net_G, gan.net_D)
    opts = (state.optimizer, state.gan.opt_G, state.gan.opt_D)
    snap = [copy.deepcopy(m.state_dict()) for m in nets]
    osnap = [copy.deepcopy(o.state_dict()) for o in opts]
    ssnap = copy.deepcopy(state.scheduler.state_dict())
    bank0 = state.memory.features.clone()
    grad_names = [n for n, p in model.named_parameters() if p.requires_grad and (
        n.rsplit(".", 1)[-1] == "p" or n.startswith("feat_bn"))]
    g_name = [n for n, _ in gan.net_G.named_parameters()][-2]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    results = []
    try:
        for plain in (False, True):
            for m, sd in zip(nets, snap):
                m.load_state_dict(sd)
            for o, sd in zip(opts, osnap):
                o.load_state_dict(copy.deepcopy(sd))
            state.scheduler.load_state_dict(ssnap)
            state.memory.features.copy_(bank0)
            calls, folds = [], []
            loss_fn = cm.memory_loss_plain if plain else cm.memory_loss
            fold_fn = cm.update_memory_plain if plain else cm.update_memory

            def recorded_loss(*args, **kw):
                out = loss_fn(*args, **kw)
                calls.append(float(out[0].detach().double().mean()))
                return out

            def recorded_fold(mem, x, t, momentum=0.2, use_hard=False, gan_x=None,
                              group_size=None):
                folds.append((mem.features.clone(), x.detach().clone(), t, momentum))
                return fold_fn(mem, x, t, momentum, use_hard, gan_x)

            with contextlib.ExitStack() as stack:
                patch = lambda mod, name, fn: stack.enter_context(  # noqa: E731
                    mock.patch.object(mod, name, fn))
                if plain:
                    stack.enter_context(_plain_heads())
                    patch(gt, "gan_input_transform",
                          lambda img, hh, ww: gan_input_transform_plain(img))
                    patch(gt, "batch_cords_to_map", batch_cords_to_map_plain)
                    patch(trainer, "augment", lambda img, seed: train_augment_plain(
                        img, params))
                else:
                    patch(trainer, "augment", lambda img, seed: train_augment(
                        img, params, h, w))
                patch(gt, "memory_loss", recorded_loss)
                patch(cm, "memory_loss", recorded_loss)
                patch(gt, "update_memory", recorded_fold)
                kernels.reset_launch_counts()
                _, g2, errs = _mode_step(trainer, state, gmem, d, 0, cluster_lr)
                torch.cuda.synchronize()
                launches = kernels.phase_launch_counts()
            named = dict(model.named_parameters())
            results.append(dict(
                calls=calls, folds=folds, launches=launches,
                G=float(errs["G"]), D=float(errs["D"]),
                enc=torch.cat([named[n].grad.flatten() for n in grad_names]),
                g=dict(gan.net_G.named_parameters())[g_name].grad.clone(),
                d=gan.net_D.conv.conv.weight.grad.clone(),
                bank=state.memory.features.clone(),
                clusters=None if g2 is None else g2.clusters))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for m, sd in zip(nets, snap):
            m.load_state_dict(sd)
            m.zero_grad(set_to_none=True)
        for o, sd in zip(opts, osnap):
            o.load_state_dict(sd)
        state.scheduler.load_state_dict(ssnap)
        state.memory.features.copy_(bank0)
    k, p = results
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    want = MODE_STEP_LAUNCHES[mode]
    got = {n: k["launches"][n] for n in want}
    print(f"[{label}] one step's launches: {got}")
    check(got == want, f"the {mode} step launched {got}, not {want}")
    e_calls = max(abs(a - b) / abs(b) for a, b in zip(k["calls"], p["calls"]))
    e_loss = max(e_calls, abs(k["G"] - p["G"]) / abs(p["G"]),
                 abs(k["D"] - p["D"]) / abs(p["D"]))
    e_grad = max(rel(k["enc"], p["enc"]), rel(k["g"], p["g"]), rel(k["d"], p["d"]))
    e_bank = float((k["bank"] - p["bank"]).abs().max())
    tol_loss, tol_grad, tol_bank = 1e-3, 1e-3, 1e-4          # [joint]'s
    print(f"[{label}] one step, kernels vs plain versions (TF32 off): K6 mean losses "
          + ", ".join(f"{a:.6f} vs {b:.6f}" for a, b in zip(k["calls"], p["calls"]))
          + f", G {k['G']:.6f} vs {p['G']:.6f}, D {k['D']:.6f} vs {p['D']:.6f} (max rel "
          f"err {e_loss:.3g}, tol {tol_loss:.3g}); encoder GeM p / head BN ({len(grad_names)}"
          f" tensors), G {g_name}, D conv grads max rel err {rel(k['enc'], p['enc']):.3g} "
          f"/ {rel(k['g'], p['g']):.3g} / {rel(k['d'], p['d']):.3g} (tol {tol_grad:.3g}); "
          f"bank after the step max_abs_err {e_bank:.3g} (tol {tol_bank:.3g})")
    n_calls = 2 if mode == "train_all_bip" else 1
    check(len(k["calls"]) == len(p["calls"]) == n_calls and e_loss <= tol_loss
          and e_grad <= tol_grad and e_bank <= tol_bank,
          f"the {mode} step through the kernels differs from the plain versions")
    if mode == "train_all_bip":
        bank, x, t, momentum = k["folds"][0]
        errs = []
        for hard in (False, True):
            a = state.memory._replace(features=bank.clone())
            b = state.memory._replace(features=bank.clone())
            cm.update_memory(a, x, t, momentum, use_hard=hard)
            cm.update_memory_plain(b, x, t, momentum, use_hard=hard)
            errs.append(float((a.features - b.features).abs().max()))
        norms = x.norm(dim=1)
        print(f"[{label}] K7 on the step's own feat + feat2 rows (norms "
              f"{float(norms.min()):.4f}-{float(norms.max()):.4f}): plain fold max_abs_err "
              f"{errs[0]:.3g}, hard fold {errs[1]:.3g} (tol {tol_bank:.3g})")
        check(len(k["folds"]) == 1 and max(errs) <= tol_bank,
              "K7 on the bip step's rows differs from its plain version")
    else:
        c0, ck, cp = gmem.clusters, k["clusters"], p["clusters"]
        touched = torch.zeros(c0.shape[0], dtype=torch.bool, device=dev)
        touched[y.long()] = True
        moved = (ck - c0).norm(dim=1)
        e_moved = float((moved[touched] - cluster_lr).abs().max())
        e_clusters = float((ck - cp).abs().max())
        still = bool(torch.equal(ck[~touched], c0[~touched]))
        print(f"[{label}] clusters: {int(touched.sum())} touched rows moved by "
              f"cluster_lr {cluster_lr} in norm (max err {e_moved:.3g}, tol 1e-5), the "
              f"{int((~touched).sum())} others bit-equal: {still}; kernels vs plain "
              f"max_abs_err {e_clusters:.3g} (tol {tol_bank:.3g}); folds {len(k['folds'])}, "
              f"bank unchanged: {bool(torch.equal(k['bank'], bank0))}")
        check(e_moved <= 1e-5 and still and e_clusters <= tol_bank and not k["folds"]
              and torch.equal(k["bank"], bank0),
              "the learnable-memory step's clusters or bank are wrong")


def phase_mode_joint(counts, label, joint_ms=None):
    """``[bip_joint]`` or ``[memory_joint]`` (``MODE_PHASES``) at the
    recipe's width (256x128, batch 256 as 16 x 16, the bank of 700 rows
    padded to 768, G and D at 128x64): one step held against the plain
    versions (``_hold_mode_step``); the peak memory and 10 warm steps timed
    beside ``[joint]``'s ``train_all`` step (``joint_ms``, this call); 3
    steps traced through the port's ``utils/profiling.trace`` (the idle
    share, the device time by kernel group) and split by CUDA events; then
    one ``cli/train_gan_usl.run`` epoch of 10 steps with the mode's flag,
    whose launches go to ``counts``."""
    import tempfile

    from reid_gan_torch.ops.cluster_memory import init_gradient_memory
    from reid_gan_torch.utils import profiling

    t_phase = time.perf_counter()
    mode, arch, model_gen, flags, off = MODE_PHASES[label]
    trainer, state, loader = _joint_trainer(iters=80, seed=7, arch=arch,
                                            model_gen=model_gen)
    trainer.mode = mode
    memory = state.memory
    gmem = init_gradient_memory(memory.features, k_pad=memory.features.shape[0],
                                device=memory.features.device)._replace(
        num_valid=memory.num_valid) \
        if mode == "train_all_with_memory" else None
    print(f"[{label}] {mode}: {arch} at 256x128 and the {model_gen} generator with the "
          f"discriminator at 128x64, batch 256 (16 ids x 16), bank "
          f"{tuple(memory.features.shape)} ({int(memory.num_valid)} live)")
    _hold_mode_step(label, trainer, state, gmem, loader.next())

    def steps(n, epoch):
        nonlocal state, gmem
        out = trainer.run_epoch(state, epoch, loader, mode=mode, train_iters=n,
                                print_freq=n, base_seed=7, gmem=gmem)
        state, errs = (out[0], out[2]) if gmem is not None else out
        gmem = out[1] if gmem is not None else None
        check(all(np.isfinite(v) for v in errs.values()), f"losses not finite: {errs}")

    steps(2, 0)                                     # cuDNN warm
    torch.cuda.reset_peak_memory_stats()
    warm = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(warm, 1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / warm * 1e3
    vs = f"; [joint] train_all step {joint_ms:.2f} ms this call, ratio " \
        f"{ms / joint_ms:.3f}" if joint_ms else ""
    print(f"[{label}] warm: {ms:.2f} ms a step, {256e3 / ms:.1f} img/s (batch 256, fp32 "
          f"weights, TF32 convolutions){vs}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    trainer.marks = []
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            steps(3, 2)
        size = os.path.getsize(prof.trace_path)
    marks, trainer.marks = trainer.marks, None
    print(f"[{label}] utils/profiling.trace wrote a Chrome trace of {size} bytes")
    check(size > 0, "profiling.trace wrote no trace")
    busy = report_profile(f"{label} (3 warm steps, utils/profiling.trace)", prof)
    if busy:
        print(f"[{label}] device busy {busy / 3:.3f} ms a step")
    print(f"[{label}] device time by phase (CUDA events, mean of 3 steps, ms): "
          + _split_by_marks(marks, 3))
    loader.close()
    phase_joint_run(counts, label=label, iters=10,
                    flags={"arch": arch, "model_gen": model_gen, **flags}, off=off)
    print(f"[{label}] phase wall time {time.perf_counter() - t_phase:.1f} s")


DDP_RUN_OFF = ("diff_transform", "pose_peaks", "fd_augment")


def phase_ddp(counts):
    """``[ddp]``: the data mesh over ``min(4, cards)`` ranks (the phase list
    in the module's docstring). One card: one rank in this process, with a
    ``file://`` store. The launches of the ``run()`` epochs go to
    ``counts`` (rank 0's)."""
    import tempfile

    from reid_gan_torch.parallel import destroy_mesh, get_mesh, launch

    t_phase = time.perf_counter()
    world = min(4, torch.cuda.device_count())
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            mesh = get_mesh(1, 0, init_method=f"file://{tmp}/store")
            try:
                out = _ddp_rank(mesh)
            finally:
                destroy_mesh()
    else:
        out = launch(_ddp_rank, world)
    counts.update(out)
    print(f"[ddp] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _ddp_rank(mesh):
    """The ``[ddp]`` checks on one rank; only rank 0 prints. Returns rank
    0's launch counts of the ``run()`` epochs."""
    from reid_gan_torch.parallel.mesh import main_prints

    with main_prints(mesh):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        print(f"[ddp] world size {mesh.world_size}, backend {mesh.backend}, "
              f"rank 0 on {mesh.device}; {smi.stdout.strip().splitlines()[0]}")
        _ddp_global_bn(mesh)
        _ddp_global_bn_bf16(mesh)
        _ddp_step(mesh)
        _ddp_step(mesh, warm=3, dtype=torch.bfloat16)
        _ddp_gan_modes(mesh)
        _ddp_eval(mesh)
        _ddp_fd(mesh)
        _ddp_dsbn(mesh)
        return _ddp_runs(mesh)


def _ddp_global_bn(mesh, n=256, c=64, h=128, w=64):
    """``ops/norm.py``'s global BatchNorm (all-reduces of [Σx, n] and
    Σ(x − mean)², its gradient written out) against torch's
    ``SyncBatchNorm`` (its gathers on several ranks, cuDNN's BatchNorm on
    one) on the rank's share of a layer's channels_last map: output, running
    stats, input gradient."""
    from reid_gan_torch.ops.norm import GlobalBatchNorm
    from reid_gan_torch.parallel import shard_batch

    g = torch.Generator(device=mesh.device).manual_seed(3)
    x = shard_batch(mesh, torch.randn((n, c, h, w), device=mesh.device, generator=g)
                    * 2.0 + 1.5).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, device=mesh.device, generator=g)
    bn = GlobalBatchNorm(c).to(mesh.device).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0, 0.1, generator=g)
    ref = torch.nn.SyncBatchNorm(c).to(mesh.device).train()
    ref.load_state_dict(bn.state_dict())
    xs = x.clone().requires_grad_(True)
    ys = bn(xs)
    (ys * dy).sum().backward()
    xp = x.clone().requires_grad_(True)
    yp = ref(xp)
    (yp * dy).sum().backward()
    e_y = float((ys - yp).detach().abs().max())
    e_m = float((bn.running_mean - ref.running_mean).abs().max())
    e_v = float(((bn.running_var - ref.running_var).abs() / ref.running_var).max())
    e_g = float((xs.grad - xp.grad).abs().max() / xp.grad.abs().max())
    tol_y, tol_m, tol_v, tol_g = 1e-4, 1e-5, 1e-5, 1e-4
    print(f"[ddp] global BatchNorm on ({x.shape[0]} of {n}, {c}, {h}, {w}) a rank "
          f"against torch's SyncBatchNorm: output max_abs_err {e_y:.3g} (tol "
          f"{tol_y:.3g}), running mean {e_m:.3g} (tol {tol_m:.3g}), running var rel "
          f"{e_v:.3g} (tol {tol_v:.3g}), input grad rel {e_g:.3g} (tol {tol_g:.3g})")
    check(e_y <= tol_y and e_m <= tol_m and e_v <= tol_v and e_g <= tol_g,
          "the global BatchNorm and torch's SyncBatchNorm differ")


def _ddp_global_bn_bf16(mesh, n=256, c=64, h=128, w=64):
    """The ``--fp16`` path's BatchNorm: a ``precision.BatchNorm2d`` swapped by
    ``convert_global_bn`` on the rank's rows of a bf16 map, against the same
    module unconverted on the whole map (every rank makes it from one seed):
    the fp32 output, the running stats, and the input gradient, which the
    widening cast hands back to the convolution in bf16. Each image's mean
    steps with its row, so the statistics of a rank's rows alone are far
    off the whole batch's. The two compute in fp32 on the same bf16 inputs
    and differ only in algorithm: the output within 1e-4 (max abs), the
    running stats within 1e-5, the bf16 input gradient within one bf16 ulp
    (2^-8) as a relative 2-norm, as the roundings of a few elements flip."""
    import copy

    from reid_gan_torch.models import precision
    from reid_gan_torch.ops.norm import GlobalBatchNorm, convert_global_bn
    from reid_gan_torch.parallel import all_gather_rows, shard_batch

    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(4)
    shift = torch.linspace(-3.0, 3.0, n, device=dev).view(n, 1, 1, 1)
    x = (torch.randn((n, c, h, w), device=dev, generator=g) * 2.0 + shift).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, device=dev, generator=g)
    ref = precision.BatchNorm2d(c).to(dev).train()
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5, generator=g)
        ref.bias.normal_(0, 0.1, generator=g)
    bn = convert_global_bn(copy.deepcopy(ref), mesh)
    xr = x.clone().requires_grad_(True)
    yr = ref(xr)
    (yr * dy).sum().backward()
    xs = shard_batch(mesh, x).clone().requires_grad_(True)
    ys = bn(xs)
    (ys * shard_batch(mesh, dy)).sum().backward()
    gr = shard_batch(mesh, xr.grad)
    errs = torch.stack([
        (ys - shard_batch(mesh, yr)).detach().abs().max(),
        (bn.running_mean - ref.running_mean).abs().max(),
        ((bn.running_var - ref.running_var).abs() / ref.running_var).max(),
        (xs.grad.float() - gr.float()).norm() / gr.float().norm()])
    e_y, e_m, e_v, e_g = (float(e) for e in all_gather_rows(mesh, errs[None]).amax(0))
    kinds = (isinstance(bn, GlobalBatchNorm), ys.dtype, xs.grad.dtype)
    tol_y, tol_m, tol_v, tol_g = 1e-4, 1e-5, 1e-5, 2.0 ** -8
    print(f"[ddp] bf16 global BatchNorm on ({xs.shape[0]} of {n}, {c}, {h}, {w}) a rank "
          f"against precision.BatchNorm2d on the whole map, worst rank: output max_abs_err "
          f"{e_y:.3g} (tol {tol_y:.3g}), running mean {e_m:.3g} (tol {tol_m:.3g}), running "
          f"var rel {e_v:.3g} (tol {tol_v:.3g}), input grad rel 2-norm {e_g:.3g} (tol "
          f"{tol_g:.3g}); swapped, output and input-gradient dtypes: {kinds}")
    check(e_y <= tol_y and e_m <= tol_m and e_v <= tol_v and e_g <= tol_g
          and kinds == (True, torch.float32, torch.bfloat16),
          "the bf16 global BatchNorm and precision.BatchNorm2d on the whole map differ")


def _ddp_trainer(mesh, dtype=None):
    """Phase 4's ResNet-50 (with ``dtype`` its compute dtype, ``--fp16``),
    bank and trainer, under ``mesh`` or (None) on the rank's card alone."""
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.engine.usl import bank_rows
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.cluster_memory import init_memory

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((700, 2048), device=dev, generator=g), dim=1)
    torch.manual_seed(0)
    trainer = ClusterContrastTrainer(create("resnet50", norm=True, dtype=dtype), height=256,
                                     width=128, num_instances=16,
                                     device=None if mesh else dev, mesh=mesh)
    state = trainer.init_state(init_memory(centers, k_pad=bank_rows(700), device=dev))
    return trainer, state


def _ddp_step(mesh, warm=5, dtype=None):
    """One USL step under the mesh against the same step without it (rank
    0, the whole batch), TF32 off, and the gradient all-reduce of that step
    against the mean of the ranks' own gradients; then warm steps of both in
    turns. With ``dtype`` bf16, the ``--fp16`` step (the global BatchNorms
    widen their bf16 input, the averaged gradients stay fp32), held as the
    CPU tests hold a bf16 step: each gap to the bf16 step without the mesh
    within twice that step's own gap to the fp32 step (``_bf16_held``); the
    tight hold of the bf16 path under the mesh is ``_ddp_global_bn_bf16``."""
    from reid_gan_torch.engine import trainers as trainers_module
    from reid_gan_torch.engine.usl import make_train_loader

    items, imgs = _pseudo_set()
    shards = (mesh, None) if dtype is None else (mesh, None, None)
    loaders = [make_train_loader(items, 256, 128, 256, 16, workers=4, iters=20, seed=1,
                                 cache=_in_memory_images(imgs), shard=shard)
               for shard in shards]
    sides = [_ddp_trainer(mesh, dtype), _ddp_trainer(None, dtype) if mesh.rank == 0 else None]
    if dtype is not None:
        sides.append(_ddp_trainer(None) if mesh.rank == 0 else None)
    label = "USL" if dtype is None else "bf16 USL"

    def step(i, seed):
        trainer, state = sides[i]
        batch = loaders[i].next()
        img = torch.from_numpy(np.ascontiguousarray(batch["img"])).to(trainer.device)
        y = torch.from_numpy(batch["pid"].astype(np.int32)).to(trainer.device)
        state, loss = trainer.step(state, img, y, seed)
        sides[i] = (trainer, state)
        return loss

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _RecordedReduce(trainers_module) as rec:
            loss_m = float(step(0, 99))
        if mesh.rank == 0:
            loss_s = float(step(1, 99))
            loss_32 = float(step(2, 99)) if dtype is not None else None
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    e_reduce, leaves = rec.error(mesh)
    del rec
    if mesh.rank == 0 and dtype is not None:
        (tm, sm), (ts, ss), (t32, s32) = sides
        fp32_grads = all(q.grad.dtype == torch.float32 for q in tm.model.parameters()
                         if q.grad is not None)
        _bf16_held(label, mesh, (loss_m, loss_s, loss_32),
                   [m.model for m in (tm, ts, t32)],
                   [x.memory.features for x in (sm, ss, s32)], e_reduce, leaves, fp32_grads)
        sides.pop()
    elif mesh.rank == 0:
        (tm, sm), (ts, ss) = sides
        # the gradients Adam took (left in .grad by the step): under the mesh,
        # the ranks' mean after all_reduce_grads; each leaf's relative 2-norm,
        # held at 0.1: fp32 gradients of ResNet-50 at init move by 1-3% a
        # leaf between two BatchNorm algorithms (one rank too; the global
        # BatchNorm's own hold against fp64 is on the CPU), while a sum in
        # place of the mean is off by the mesh size less one
        pm, ps = dict(tm.model.named_parameters()), dict(ts.model.named_parameters())
        errs = {k: float((pm[k].grad - ps[k].grad).norm()
                         / ps[k].grad.norm().clamp_min(1e-30))
                for k in ps if ps[k].grad is not None}
        head = {k: v for k, v in errs.items()
                if k.startswith(("layer4.", "gap.", "feat.", "feat_bn."))}
        e_head, w_head = max((v, k) for k, v in head.items())
        e_grad, worst = max((v, k) for k, v in errs.items())
        bm, bs = dict(tm.model.named_buffers()), dict(ts.model.named_buffers())
        e_stats = max(float(((bm[k] - bs[k]).abs() / bs[k].abs().clamp_min(1e-3)).max())
                      for k in bs if "running" in k)
        e_bank = float((sm.memory.features - ss.memory.features).abs().max())
        e_loss = abs(loss_m - loss_s)
        tol_loss, tol_reduce, tol_grad, tol_bank, tol_stats = 1e-3, 1e-5, 0.1, 1e-4, 1e-3
        print(f"[ddp] one {label} step under the mesh vs without (TF32 off, batch 256, "
              f"{256 // mesh.world_size} a rank): loss {loss_m:.6f} vs {loss_s:.6f} (err "
              f"{e_loss:.3g}, tol {tol_loss:.3g}); the gradient all-reduce against the "
              f"fp64 mean of the ranks' own, {leaves} leaves: at most "
              f"{e_reduce:.3g} (tol {tol_reduce:.3g}); the mesh's gradients against the "
              f"step's without it, relative 2-norm a leaf: all at most {e_grad:.3g} "
              f"({worst}; tol {tol_grad:.3g}), median "
              f"{float(np.median(list(errs.values()))):.3g}, head ({len(head)} leaves) "
              f"at most {e_head:.3g} ({w_head}); bank max_abs_err {e_bank:.3g} (tol "
              f"{tol_bank:.3g}); running stats rel {e_stats:.3g} (tol {tol_stats:.3g})")
        check(e_loss <= tol_loss and e_reduce <= tol_reduce and e_grad <= tol_grad
              and e_bank <= tol_bank and e_stats <= tol_stats,
              f"the {label} step under the mesh differs from the step without it")

    _ddp_turns(label, mesh, step, warm)   # TF32 convolutions, as [train]
    for loader in loaders:
        loader.close()


def _tree_gap(a, b):
    """Relative L2 of two gradient trees (dicts of tensors) over every
    leaf, and of each leaf."""
    keys = [k for k in b if b[k] is not None]
    d = torch.cat([(a[k] - b[k]).double().flatten() for k in keys])
    r = torch.cat([b[k].double().flatten() for k in keys])
    return float(d.norm() / r.norm()), {
        k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in keys}


def _bf16_held(label, mesh, losses, models, banks, e_reduce, leaves, fp32_grads):
    """A bf16 step under the mesh (``models[0]``, losses and bank first)
    against the bf16 step without it (second) and the fp32 step without it
    (third), the same weights and batch. Held: the loss within twice the
    bf16 step's own gap to the fp32 step (or 2 bf16 ulps), as the CPU tests
    hold a bf16 loss (``tests/test_torch_port_fp16.py``); the gradient
    all-reduce against the fp64 mean of the ranks' own; every averaged
    gradient fp32. Printed, not held: the gradients (one tree, relative
    L2), the running stats (max relative, of the values above 1e-3) and the
    bank (max abs) against the bf16 step without the mesh, each beside that
    step's gap to fp32. At init the BatchNorm backward passes leave mostly
    rounding in a bf16 gradient, so these gaps are of the order of a
    gradient in another direction and separate nothing; the bf16 global
    BatchNorm is held where it is tight, in ``_ddp_global_bn_bf16``."""
    (lm, ls, l32), (mm, ms, m32), (bm, bs, b32) = losses, models, banks
    grads = [{k: p.grad for k, p in m.named_parameters()} for m in (mm, ms, m32)]
    g_ms, per_leaf = _tree_gap(grads[0], grads[1])
    g_s32, _ = _tree_gap(grads[1], grads[2])

    def stats_gap(a, b):
        ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
        return max(float(((ba[k] - v).abs() / v.abs().clamp_min(1e-3)).max())
                   for k, v in bb.items() if "running" in k)

    e_loss, tol_loss = abs(lm - ls), 2 * max(abs(ls - l32), 2 * 2.0 ** -8 * abs(l32))
    seen = {"gradient tree": (g_ms, g_s32),
            "running stats": (stats_gap(mm, ms), stats_gap(ms, m32)),
            "bank": (float((bm - bs).abs().max()), float((bs - b32).abs().max()))}
    print(f"[ddp] one {label} step under the mesh vs without (TF32 off, batch 256, "
          f"{256 // mesh.world_size} a rank): loss {lm:.6f} vs {ls:.6f} (fp32 {l32:.6f}; "
          f"err {e_loss:.3g}, tol {tol_loss:.3g}); the gradient all-reduce against the fp64 "
          f"mean of the ranks' own, {leaves} leaves: at most {e_reduce:.3g} (tol 1e-05); "
          f"every averaged gradient fp32: {fp32_grads}; not held, gap to the bf16 step "
          f"without the mesh [that step's own gap to fp32]: "
          + ", ".join(f"{k} {a:.3g} [{b:.3g}]" for k, (a, b) in seen.items())
          + f"; leaves, relative 2-norm: median "
          f"{float(np.median(list(per_leaf.values()))):.3g}, worst {max(per_leaf.values()):.3g}")
    check(e_loss <= tol_loss and e_reduce <= 1e-5 and fp32_grads,
          f"the {label} step under the mesh differs from the step without it")


DDP_MODES = {   # [ddp]'s modes: (trainer mode, encoder, generator, compute dtype)
    "hardmix": ("train", "resnet50", "AE", None),
    "bip": ("train_all_bip", "resnet_bip50", "AE", None),
    "memory": ("train_all_with_memory", "resnet50", "Pose", None),
    "bf16 train_all": ("train_all", "resnet50", "Pose", torch.bfloat16),
}


def _ddp_mode_trainer(mesh, arch, model_gen, dtype=None):
    """``[joint]``'s nets for one mode (a random ``arch`` at 256x128 and the
    ``model_gen`` generator with the discriminator at 128x64, seed 0, with
    ``dtype`` their compute dtype; the bank of 700 unit rows padded to 768,
    and trainable clusters from it for the pose generator's memory mode)
    under ``mesh`` or (None) on the rank's card alone. Returns (trainer,
    state, gmem)."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.engine.usl import bank_rows
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.ops.cluster_memory import init_gradient_memory, init_memory

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((700, 2048), device=dev, generator=g), dim=1)
    memory = init_memory(centers, k_pad=bank_rows(700), device=dev)
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="AE", model_gen=model_gen), gan_height=128,
                     gan_width=64, reid_feat_dim=2048, device=dev, dtype=dtype)
    trainer = ClusterContrastWithGANTrainer(create(arch, norm=True, dtype=dtype), gan,
                                            height=256,
                                            width=128, num_instances=16,
                                            device=None if mesh else dev, mesh=mesh)
    state = trainer.init_state(memory, gan.init_state())
    gmem = init_gradient_memory(memory.features, k_pad=memory.features.shape[0],
                                device=dev)._replace(num_valid=memory.num_valid) \
        if model_gen == "Pose" else None
    return trainer, state, gmem


def _ddp_mode_step(trainer, state, gmem, batch, mode, seed):
    """One step of ``mode`` on a host batch: the whole batch on the card, the
    rank's rows of it under a mesh (the whole batch's labels). Returns
    (state, gmem, losses)."""
    dev = trainer._to_device(batch, mode)
    dev = {k: v if k == "pid" else trainer.local(v) for k, v in dev.items()}
    if mode == "train":
        state, errs = trainer.train_step(state, dev, seed)
    elif mode == "train_all":
        state, errs = trainer.train_all_step(
            state, dev, seed, torch.ones(len(batch["pid"]), device=trainer.device))
    elif mode == "train_all_bip":
        state, errs = trainer.train_all_bip_step(state, dev, seed)
    else:
        state, gmem, errs = trainer.train_all_with_memory_step(state, gmem, dev, seed)
    return state, gmem, errs


class _RecordedReduce:
    """Patches ``module.all_reduce_grads`` for a block: each call's
    parameters and the rank's own gradients, as the step hands them to the
    all-reduce (before it). ``error(mesh)``: after the step, each reduced
    leaf against the fp64 mean of every rank's own, relative to the largest
    rank's 2-norm of the leaf (at most, over the calls)."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        self.real = self.module.all_reduce_grads

        def recorded(mesh, params):
            params = [p for p in params if p.grad is not None]
            self.calls.append((params, [p.grad.detach().clone() for p in params]))
            self.real(mesh, params)

        self.module.all_reduce_grads = recorded
        return self

    def __exit__(self, *exc):
        self.module.all_reduce_grads = self.real

    def error(self, mesh):
        from reid_gan_torch.parallel import all_gather_rows

        worst, leaves = 0.0, 0
        for params, own in self.calls:
            ranks = all_gather_rows(mesh, torch.cat([g.flatten() for g in own])[None]
                                    ).double()
            at = 0
            for p in params:
                part = ranks[:, at:at + p.numel()]
                at += p.numel()
                worst = max(worst, float((p.grad.flatten().double() - part.mean(0)).norm()
                                         / part.norm(dim=1).max().clamp_min(1e-30)))
            leaves += len(params)
        return worst, leaves


def _ddp_turns(label, mesh, step, warm):
    """Warm steps of ``step(side, seed)`` without (1) and with (0) the mesh
    in turns (without, with, with, without; the side without on rank 0
    alone), TF32 convolutions; prints their times."""
    ms = {0: [], 1: []}
    for i in (1, 0, 0, 1):
        if i == 1 and mesh.rank != 0:
            continue
        step(i, 100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(warm):
            step(i, 101 + k)
        torch.cuda.synchronize()
        ms[i].append((time.perf_counter() - t0) / warm * 1e3)
    if mesh.rank == 0:
        with_mesh, without = np.mean(ms[0]), np.mean(ms[1])
        print(f"[ddp] {label} warm step, this call (TF32 convolutions, batch 256): under "
              f"the mesh {with_mesh:.2f} ms ({ms[0][0]:.2f}, {ms[0][1]:.2f}), without "
              f"{without:.2f} ms ({ms[1][0]:.2f}, {ms[1][1]:.2f}); ratio "
              f"{with_mesh / without:.4f}")


def _ddp_gan_modes(mesh, warm=3):
    """The hard-mix, bip and learnable-memory steps (``DDP_MODES``) and the
    GAN warm-up's iteration under the mesh, each held against the same step
    without it on rank 0 (the whole batch, the same weights and draws, TF32
    off): the losses (the ranks' means), the gradient all-reduces against
    the fp64 mean of the ranks' own gradients, the clusters of the memory
    mode (against the step without the mesh, and bit-equal on every rank);
    then warm steps with and without the mesh in turns."""
    import tempfile

    from reid_gan_torch.engine import gan_trainers
    from reid_gan_torch.engine.usl import make_train_loader
    from reid_gan_torch.parallel import all_gather_rows

    items, imgs = _pseudo_set()
    with tempfile.TemporaryDirectory() as tmp:   # the loader reads the CSV at once
        loader = make_train_loader(
            items, 256, 128, 256, 16, workers=4, iters=2 + 4 * (warm + 1), seed=3,
            cache=_in_memory_images(imgs, imgs[:, ::2, ::2]), mode="with_gan",
            gan_height=128, gan_width=64, flip_all=True,
            pose_file=_write_pose_csv(items, os.path.join(tmp, "poses.csv"), 15))
    batches = [loader.next() for _ in range(2 + 4 * (warm + 1))]
    loader.close()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for label, (mode, arch, model_gen, dtype) in DDP_MODES.items():
        sides = [list(_ddp_mode_trainer(mesh, arch, model_gen, dtype)),
                 list(_ddp_mode_trainer(None, arch, model_gen, dtype))
                 if mesh.rank == 0 else None]
        if dtype is not None:   # the fp32 step the bf16 steps are held to
            sides.append(list(_ddp_mode_trainer(None, arch, model_gen))
                         if mesh.rank == 0 else None)
        c0 = None if sides[0][2] is None else sides[0][2].clusters.clone()

        def step(i, seed, batch=None):
            trainer, state, gmem = sides[i]
            b = batches[2 + (seed - 100) % (len(batches) - 2)] if batch is None else batch
            state, gmem, errs = _ddp_mode_step(trainer, state, gmem, b, mode, seed)
            sides[i] = [trainer, state, gmem]
            return errs

        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with _RecordedReduce(gan_trainers) as rec:
                errs_m = {k: float(v) for k, v in step(0, 99, batches[0]).items()}
            e_reduce, leaves = rec.error(mesh)
            errs_s = {k: float(v) for k, v in step(1, 99, batches[0]).items()} \
                if mesh.rank == 0 else None
            errs_32 = {k: float(v) for k, v in step(2, 99, batches[0]).items()} \
                if mesh.rank == 0 and dtype is not None else None
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        same_clusters, e_clusters = True, 0.0
        if c0 is not None:
            cm = sides[0][2].clusters
            every = all_gather_rows(mesh, cm[None])
            same_clusters = bool((every == cm[None]).all())
            if mesh.rank == 0:
                cs = sides[1][2].clusters
                e_clusters = float((cm - cs).norm() / (cs - c0).norm().clamp_min(1e-30))
        del rec
        if mesh.rank == 0:
            e_loss = max(abs(errs_m[k] - errs_s[k]) / max(abs(errs_s[k]), 1e-30)
                         for k in errs_s)
            tol_loss, tol_reduce, tol_clusters = 1e-3, 1e-5, 0.1
            if errs_32 is not None:
                # bf16, as _bf16_held: each loss's gap to the bf16 step without
                # the mesh within twice that step's gap to fp32 (or 2 ulps)
                e_loss = max(abs(errs_m[k] - errs_s[k]) / max(
                    abs(errs_s[k] - errs_32[k]), 2 * 2.0 ** -8 * abs(errs_32[k]), 1e-30)
                    for k in errs_s)
                tol_loss = 2.0
                sides.pop()
            extra = f"; clusters against the step without the mesh, relative to their " \
                f"move: {e_clusters:.3g} (tol {tol_clusters:.3g}), every rank's bit-equal: " \
                f"{same_clusters}" if c0 is not None else ""
            print(f"[ddp] {label} ({mode}: {arch}, the {model_gen} generator) one step under "
                  f"the mesh vs without (TF32 off, batch 256, {256 // mesh.world_size} a "
                  f"rank): " + ", ".join(f"{k} {errs_m[k]:.6f} vs {errs_s[k]:.6f}"
                                         for k in errs_s)
                  + (f" (fp32: " + ", ".join(f"{k} {v:.6f}" for k, v in errs_32.items())
                     + "; the largest gap as a multiple of the bf16 step's own gap to fp32"
                     if errs_32 is not None else " (max rel err")
                  + f" {e_loss:.3g}, tol {tol_loss:.3g}); the gradient "
                  f"all-reduces against the fp64 mean of the ranks' own, {leaves} leaves: "
                  f"at most {e_reduce:.3g} (tol {tol_reduce:.3g}){extra}")
            check(e_loss <= tol_loss and e_reduce <= tol_reduce
                  and e_clusters <= tol_clusters and same_clusters,
                  f"the {mode} step under the mesh differs from the step without it")
        else:
            check(same_clusters, "the ranks' clusters differ")
        _ddp_turns(label, mesh, step, warm)
        del sides, step
        torch.cuda.empty_cache()
    _ddp_warmup(mesh, imgs, warm)


def _ddp_warmup(mesh, imgs, warm):
    """The GAN warm-up's iteration (``GANTrainer.train_gan``: the AE
    generator and D at 128x64, batch 256) under the mesh against the same
    iteration without it on rank 0, TF32 off: G and D losses, the two
    gradient all-reduces; then warm iterations in turns."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import GANTrainer
    from reid_gan_torch.models.dual_gan import ae_model
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.parallel import shard_batch

    dev = torch.device("cuda", torch.cuda.current_device())
    xs = [imgs[k * 256:(k + 1) * 256, ::2, ::2] for k in range(warm + 1)]

    def side(m):
        torch.manual_seed(0)
        gan = create_gan(GANConfig(model="AE", model_gen="AE"), gan_height=128,
                         gan_width=64, device=dev)
        return [GANTrainer(gan, print_freq=1000, device=None if m else dev, mesh=m),
                gan.init_state()]

    sides = [side(mesh), side(None) if mesh.rank == 0 else None]

    class Batches:
        def __init__(self, i, seed):
            self.x = xs[seed % len(xs)]
            if i == 0:
                self.x = shard_batch(mesh, self.x)

        def next(self):
            return {"Xs": np.ascontiguousarray(self.x)}

    def step(i, seed):
        trainer, state = sides[i]
        state, errs = trainer.train_gan(state, 0, Batches(i, seed), train_iters=1,
                                        base_seed=seed)
        sides[i] = [trainer, state]
        return errs

    def iteration(i, seed):     # train_gan's work of an iteration, timed
        trainer, state = sides[i]
        x = torch.from_numpy(Batches(i, seed).next()["Xs"]).to(dev)
        sides[i][1] = trainer.gan.optimize_parameters(state, x, mesh=trainer.mesh)[0]

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _RecordedReduce(ae_model) as rec:
            errs_m = step(0, 99)
        e_reduce, leaves = rec.error(mesh)
        errs_s = step(1, 99) if mesh.rank == 0 else None
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    if mesh.rank == 0:
        e_loss = max(abs(errs_m[k] - errs_s[k]) / abs(errs_s[k]) for k in errs_s)
        tol_loss, tol_reduce = 1e-3, 1e-5
        print(f"[ddp] warm-up (GANTrainer.train_gan: the AE generator and D at 128x64) one "
              f"iteration under the mesh vs without (TF32 off, batch 256, "
              f"{256 // mesh.world_size} a rank): "
              + ", ".join(f"{k} {errs_m[k]:.6f} vs {errs_s[k]:.6f}" for k in errs_s)
              + f" (max rel err {e_loss:.3g}, tol {tol_loss:.3g}); the gradient "
              f"all-reduces (D's, then G's) against the fp64 mean of the ranks' own, "
              f"{leaves} leaves: at most {e_reduce:.3g} (tol {tol_reduce:.3g})")
        check(e_loss <= tol_loss and e_reduce <= tol_reduce,
              "the warm-up iteration under the mesh differs from the one without it")
    _ddp_turns("warm-up", mesh, iteration, warm)
    del sides
    torch.cuda.empty_cache()


def _ddp_eval(mesh):
    """A sharded ``Evaluator.evaluate`` of phase 3's eval set against the
    unsharded one on rank 0 (the same ResNet-50): CMC and mAP."""
    from reid_gan_torch.engine.evaluators import Evaluator, FeatureExtractor
    from reid_gan_torch.models import create
    from reid_gan_torch.parallel import pad_to_multiple, shard_batch

    torch.backends.cudnn.allow_tf32 = True   # as cli/test.py sets it
    batches, query, gallery = _eval_set()
    torch.manual_seed(0)
    model = create("resnet50")

    def local(b):
        img, _ = pad_to_multiple(b["img"], mesh.world_size)
        return dict(b, img=shard_batch(mesh, img))

    t0 = time.perf_counter()
    ext = FeatureExtractor(model, height=256, width=128, batch_size=256, mesh=mesh)
    cmc, mAP = Evaluator(ext).evaluate([local(b) for b in batches], query, gallery,
                                       cmc_flag=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not mesh.rank == 0:
        return
    ref = FeatureExtractor(model, height=256, width=128, batch_size=256,
                           device=mesh.device)
    cmc_1, map_1 = Evaluator(ref).evaluate(batches, query, gallery, cmc_flag=True)
    tol = 1e-6 if mesh.world_size == 1 else 1e-3
    e_cmc, e_map = float(np.abs(cmc - cmc_1).max()), abs(mAP - map_1)
    print(f"[ddp] sharded Evaluator.evaluate ({len(query)} + {len(gallery)} images, "
          f"{mesh.world_size} rank(s)): {wall:.2f} s; mAP {mAP:.6f} vs unsharded "
          f"{map_1:.6f}, top-1 {cmc[0]:.6f} vs {cmc_1[0]:.6f}; CMC max err {e_cmc:.3g}, "
          f"mAP err {e_map:.3g} (tol {tol:.3g})")
    check(e_cmc <= tol and e_map <= tol, "the sharded eval differs from the unsharded one")


def _stats_error(net_m, net_s):
    """The running stats' largest error, mesh against without, each buffer's
    relative L2 (G's channel means sit near zero at init)."""
    bm, bs = dict(net_m.named_buffers()), dict(net_s.named_buffers())
    return max([float((bm[k] - b).norm() / b.norm().clamp_min(1e-30))
                for k, b in bs.items() if "running" in k] or [0.0])


def _fd_held(label, mesh, rec, errs_m, errs_s, pairs, tol_loss=1e-3, tol_grad=0.1,
             tol_stats=1e-3):
    """Print and check one FD step under the mesh against the step without
    it (rank 0): ``pairs`` are (name, mesh net, net without), the losses the
    ranks' means. Each net's gradients are held as one tree (relative L2):
    at init a leaf whose gradient nearly cancels (the verifier's bias, at a
    loss of log 2) moves by tens of percent between two BatchNorm
    algorithms, while a sum in place of the ranks' mean moves the tree by
    the mesh size less one."""
    e_reduce, leaves = rec.error(mesh)
    if mesh.rank != 0:
        return
    e_loss = max(abs(errs_m[k] - errs_s[k]) / max(abs(errs_s[k]), 1e-30) for k in errs_s)
    grads, stats = {}, {}
    for name, net_m, net_s in pairs:
        gm = {k: p.grad for k, p in net_m.named_parameters()}
        gs = {k: p.grad for k, p in net_s.named_parameters()}
        if any(v is not None for v in gs.values()):
            tree, errs = _tree_gap(gm, gs)
            worst, k = max((v, k) for k, v in errs.items())
            grads[name] = (tree, worst, k, float(np.median(list(errs.values()))), len(errs))
        stats[name] = _stats_error(net_m, net_s)
    e_grad = max(v[0] for v in grads.values())
    e_stats = max(stats.values())
    print(f"[ddp] {label} one step under the mesh vs without (TF32 off, cuDNN "
          f"deterministic, 256 pairs, {256 // mesh.world_size} a rank): "
          + ", ".join(f"{k} {errs_m[k]:.6f} vs {errs_s[k]:.6f}" for k in errs_s)
          + f" (max rel err {e_loss:.3g}, tol {tol_loss:.3g}); the gradient all-reduces "
          f"against the fp64 mean of the ranks' own, {leaves} leaves: at most "
          f"{e_reduce:.3g} (tol 1e-05); gradients, relative 2-norm of each net's tree "
          f"(tol {tol_grad:.3g}) [its leaves: worst, leaf; median; count]: " + ", ".join(
              f"{n} {t:.3g} [{w:.3g}, {k}; {m:.3g}; {c}]"
              for n, (t, w, k, m, c) in grads.items())
          + "; running stats rel " + ", ".join(
              f"{n} {v:.3g}" for n, v in stats.items()) + f" (tol {tol_stats:.3g})")
    check(e_loss <= tol_loss and e_reduce <= 1e-5 and e_grad <= tol_grad
          and e_stats <= tol_stats,
          f"the {label} step under the mesh differs from the step without it")


def _ddp_fd(mesh, warm=1):
    """FD-GAN under the mesh: the stage-I Siamese step, then one
    ``FDGANModel`` step of stage II and of stage III, at full width (256
    pairs of a small FD set), each held against the same step without it on
    rank 0 (the same weights, batch and draws; TF32 off, cuDNN
    deterministic), then warm steps with and without the mesh in turns; the
    sharded ``CascadeEvaluator`` against the unsharded one on phase 3's eval
    set."""
    import tempfile

    from reid_gan_torch.cli.fdgan_baseline import make_cascade_evaluator
    from reid_gan_torch.config import Config, FDGANConfig
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.data.sampler import RandomPairSampler
    from reid_gan_torch.engine import fdgan as fdgan_engine
    from reid_gan_torch.engine.fdgan import SiameseTrainer
    from reid_gan_torch.models import siamese_baseline
    from reid_gan_torch.models.fdgan import model as fdgan_model
    from reid_gan_torch.models.fdgan.model import FDGANModel
    from reid_gan_torch.ops.transforms import sample_fd_augment_params
    from reid_gan_torch.parallel import all_reduce_mean, pad_to_multiple, shard_batch

    dev = torch.device("cuda", torch.cuda.current_device())
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)

    def exact():
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True

    def restore():
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags

    with tempfile.TemporaryDirectory() as tmp:
        ds, imgs = _fd_set(tmp, seed=9, n_ids=64, per_id=8, n_query=128, n_gallery=384)
        cache = _in_memory_images(imgs)

        def batches(mode, n, seed):
            kw = dict(pid_imgs=ds.pid_imgs, pose_root=ds.poses_dir) \
                if mode == "fdgan_pose" else {}
            loader = DataLoader(Preprocessor(ds.train, mode=mode, seed=seed, cache=cache,
                                             **kw),
                                sampler=RandomPairSampler(ds.train, seed=seed),
                                batch_size=256, drop_last=True)
            it = iter(loader)
            out = [next(it) for _ in range(n)]
            it.close()
            return out

        pair_batches = batches("pair", 3, 11)
        pose_batches = batches("fdgan_pose", 3, 12)

    # ---- stage I: SiameseTrainer
    def siamese(m):
        torch.manual_seed(0)
        return SiameseTrainer(siamese_baseline(50), lr=0.01, device=None if m else dev,
                              seed=0, mesh=m)

    sides = [siamese(mesh), siamese(None) if mesh.rank == 0 else None]
    g = torch.Generator(device=dev).manual_seed(5)
    draws = [(sample_fd_augment_params(256, 256, 128, g),
              sample_fd_augment_params(256, 256, 128, g)) for _ in pair_batches]

    def s_step(i, seed, k=None):
        trainer = sides[i]
        k = seed % len(pair_batches) if k is None else k
        b1, b2 = pair_batches[k]
        t = (b1["pid"] == b2["pid"]).astype(np.int64)
        arrays = (b1["img"], b2["img"], t) if i == 1 else shard_batch(
            mesh, (b1["img"], b2["img"], t))
        i1, i2, tg = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
        loss, _ = trainer.step(i1, i2, tg, *draws[k])
        return loss if i == 1 else all_reduce_mean(mesh, loss)

    exact()
    try:
        with _RecordedReduce(fdgan_engine) as rec:
            loss_m = float(s_step(0, 0, 0))
        loss_s = float(s_step(1, 0, 0)) if mesh.rank == 0 else None
    finally:
        restore()
    _fd_held("FD stage I (SiameseTrainer: ResNet-50, last stride 2)", mesh, rec,
             {"loss": loss_m}, {"loss": loss_s},
             [("siamese", sides[0].model, sides[1].model)] if mesh.rank == 0 else [])
    del rec
    _ddp_turns("FD stage I (256 pairs)", mesh, s_step, 3)

    # ---- the cascade evaluation: the mesh-side net, sharded and not
    torch.backends.cudnn.allow_tf32 = True
    eval_batches, query, gallery = _eval_set()

    def local(b):
        img, _ = pad_to_multiple(b["img"], mesh.world_size)
        return dict(b, img=shard_batch(mesh, img))

    model = sides[0].model
    cfg = Config()
    t0 = time.perf_counter()
    top1_m, map_m = make_cascade_evaluator(model, cfg, None, mesh).evaluate(
        [local(b) for b in eval_batches], query, gallery, rerank_topk=100,
        dataset="market1501")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mesh.rank == 0:
        top1_s, map_s = make_cascade_evaluator(model, cfg, dev).evaluate(
            eval_batches, query, gallery, rerank_topk=100, dataset="market1501")
        tol = 1e-6 if mesh.world_size == 1 else 1e-3
        print(f"[ddp] sharded CascadeEvaluator.evaluate ({len(query)} + {len(gallery)}, the "
              f"top 100 re-scored, {mesh.world_size} rank(s)): {wall:.2f} s; top-1 "
              f"{top1_m:.6f} vs unsharded {top1_s:.6f}, mAP {map_m:.6f} vs {map_s:.6f} (tol "
              f"{tol:.3g})")
        check(abs(top1_m - top1_s) <= tol and abs(map_m - map_s) <= tol,
              "the sharded cascade evaluation differs from the unsharded one")
    del sides, model
    torch.cuda.empty_cache()

    # ---- stages II and III: FDGANModel
    for stage, pose_aug in ((1, "gauss"), (2, "erase")):
        label = f"FD stage {'II' if stage == 1 else 'III'}"

        def build(m):
            torch.manual_seed(stage)
            cfg = FDGANConfig(stage=stage, pose_aug=pose_aug, lambda_veri=10.0,
                              lambda_sp=10.0)
            return FDGANModel(cfg, device=None if m else dev, seed=stage, mesh=m)

        models = [build(mesh), build(None) if mesh.rank == 0 else None]
        ref = models[0]
        fd_draws = [ref.sample_draws(256) for _ in pose_batches]

        def f_step(i, seed, k=None):
            model = models[i]
            k = seed % len(pose_batches) if k is None else k
            b1, b2 = pose_batches[k]
            if i == 0:      # the rank's rows of every field (``fname`` a list)
                s = 256 // mesh.world_size
                b1, b2 = ({f: v[mesh.rank * s:(mesh.rank + 1) * s] for f, v in b.items()}
                          for b in (b1, b2))
            errs, _ = model.optimize_step(b1, b2, fd_draws[k])
            return model.global_errors(errs)

        exact()
        try:
            with _RecordedReduce(fdgan_model) as rec:
                errs_m = {k: float(v) for k, v in f_step(0, 0, 0).items()}
            errs_s = {k: float(v) for k, v in f_step(1, 0, 0).items()} \
                if mesh.rank == 0 else None
        finally:
            restore()
        pairs = [(n, models[0].nets()[n], models[1].nets()[n])
                 for n in ("E", "G", "Di", "Dp")] if mesh.rank == 0 else []
        _fd_held(f"{label} (FDGANModel stage {stage}: E, Di ResNet-50, G, Dp at 256x128)",
                 mesh, rec, errs_m, errs_s, pairs, tol_loss=1e-2)
        del rec
        _ddp_turns(f"{label} (256 pairs)", mesh, f_step, warm)
        del models, ref, fd_draws, f_step
        torch.cuda.empty_cache()


def _ddp_dsbn(mesh):
    """``cli/test.run --dsbn`` under the mesh (every rank loads a DSBN
    msgpack checkpoint of a random ResNet-50 and folds the domain's
    BatchNorms) against the run without it on rank 0, on phase 3's eval
    set, for the target and the source domain; the target apart from the
    source."""
    import tempfile
    from types import SimpleNamespace

    from reid_gan_torch.cli import test as test_cli
    from reid_gan_torch.config import Config
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.models.dsbn import convert_dsbn, update_domain
    from reid_gan_torch.utils.serialization import save_msgpack_checkpoint

    batches, query, gallery = _eval_set()
    dataset = SimpleNamespace(query=query, gallery=gallery)
    cache = _in_memory_images(np.concatenate([b["img"] for b in batches]))
    torch.manual_seed(0)
    tree = flax_variables_from_model(create("resnet50"))
    rng = np.random.default_rng(6)
    target = {"params": tree["params"], "batch_stats": _map_tree(
        lambda a: (a * (1 + 0.2 * rng.random(a.shape)) + 0.05).astype(np.float32),
        tree["batch_stats"])}
    cfg = Config()
    cfg.data.workers = 4
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"dsbn_rank{mesh.rank}.msgpack")
        save_msgpack_checkpoint({"dsbn": update_domain(convert_dsbn(tree), 1, target),
                                 "epoch": np.asarray(1), "best_mAP": np.asarray(0.0)},
                                False, path)
        cfg.train.resume = path
        got = {}
        for name, source in (("target", False), ("source", True)):
            t0 = time.perf_counter()
            got[name] = test_cli.run(cfg, dataset, image_cache=cache, dsbn=True,
                                     test_source=source, mesh=mesh)
            wall = time.perf_counter() - t0
            if mesh.rank == 0:
                cmc_s, map_s = test_cli.run(cfg, dataset, device=mesh.device,
                                            image_cache=cache, dsbn=True, test_source=source)
                cmc_m, map_m = got[name]
                tol = 1e-6 if mesh.world_size == 1 else 1e-3
                e = max(float(np.abs(cmc_m - cmc_s).max()), abs(map_m - map_s))
                print(f"[ddp] cli/test.run --dsbn ({name} domain) under the mesh: {wall:.2f} "
                      f"s; mAP {map_m:.6f} vs without {map_s:.6f}, top-1 {cmc_m[0]:.6f} vs "
                      f"{cmc_s[0]:.6f}; max err {e:.3g} (tol {tol:.3g})")
                check(e <= tol, f"--dsbn ({name}) under the mesh differs from the run "
                                f"without it")
    if mesh.rank == 0:
        check(got["target"][1] != got["source"][1],
              "--dsbn: the target domain's BatchNorms did not change the evaluation")


# [ddp]'s run() epochs: (label, the flags on the joint config, kernels that
# must not launch); every other kernel must
DDP_RUNS = (
    ("train_all", {}, DDP_RUN_OFF),
    ("no_gan_train", {"model_gen": "AE", "gan_train": False},
     ("pose_maps", "gan_feat_l2n", "pose_peaks", "fd_augment")),
    ("bipath", {"arch": "resnet_bip50", "model_gen": "AE", "bipath": True},
     ("pose_maps", "gan_feat_l2n") + DDP_RUN_OFF),
    ("learnable_memory", {"learnable_memory": True},
     ("bank_fold", "gan_feat_l2n") + DDP_RUN_OFF),
)


def _ddp_runs(mesh):
    """Under the mesh, a 2-step ``cli/train_usl.run``, then 2-step epochs of
    ``cli/train_gan_usl.run`` in ``train_all``, the hard-mix ``train``
    (``--no-gan-train``), ``train_all_bip`` (``--bipath``) and
    ``train_all_with_memory`` (``--learnable-memory``), and 2 iterations of
    ``cli/train_gan_warmup.run``, each with the launch counts zeroed just
    before and read just after (rank 0's), each held to its kernels. Returns
    their sum."""
    import tempfile

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import train_gan_usl, train_gan_warmup, train_usl
    from reid_gan_torch.config import Config

    dataset, imgs = _usl_set(n_train=2048, ids=128, n_query=256, n_gallery=768,
                             eval_ids=64)
    cache = _in_memory_images(imgs, imgs[:, ::2, ::2])

    def config(logs):
        cfg = Config()
        cfg.data.workers = 4
        cfg.train.epochs, cfg.train.iters, cfg.train.eval_step = 1, 2, 1
        cfg.cluster.cluster_backend, cfg.cluster.eps = "infomap", 0.5
        cfg.cluster.k1, cfg.cluster.k2 = 15, 4
        cfg.train.logs_dir = logs
        return cfg

    total = {}

    def counted(label, off, run):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        print(f"[ddp] {label} under the mesh: {wall:.2f} s; launches (rank 0): "
              f"{kernels.phase_launch_counts()}")
        if mesh.rank == 0:
            check(all(v > 0 for k, v in launches.items() if k not in off)
                  and all(launches[k] == 0 for k in off),
                  f"{label}: all kernels but {', '.join(off)} must launch, those not: "
                  f"{launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out

    with tempfile.TemporaryDirectory() as tmp:
        dataset.train_pose_dir = _write_pose_csv(dataset.train,
                                                 os.path.join(tmp, "poses.csv"), 14)
        usl = config(os.path.join(tmp, "usl"))
        best_usl = counted("cli/train_usl.run", DDP_RUN_OFF + (
            "gan_input", "pose_maps", "gan_feat_l2n"), lambda: train_usl.run(
                usl, dataset, image_cache=_in_memory_images(imgs), mesh=mesh))
        print(f"[ddp] cli/train_usl.run: best mAP {best_usl:.4f}")
        saved, bests = [], {}
        for label, flags, off in DDP_RUNS:
            joint = config(os.path.join(tmp, label))
            joint.gan.model, joint.gan.model_gen = "AE", "Pose"
            joint.gan.save_dir = os.path.join(tmp, f"ckpt_{label}")
            for k, v in flags.items():
                setattr(joint.model if k == "arch" else joint.gan, k, v)
            bests[label] = counted(
                f"cli/train_gan_usl.run ({label})", off,
                lambda joint=joint: train_gan_usl.run(joint, dataset, mesh=mesh,
                                                      image_cache=cache))
            if mesh.rank == 0:
                files = set(os.listdir(joint.train.logs_dir))
                if joint.gan.gan_train:
                    files |= set(os.listdir(os.path.join(joint.gan.save_dir,
                                                          "experiment")))
                saved.append((label, sorted(files)))
                want = {"checkpoint.pth.tar", "model_best.pth.tar"} | (
                    {"latest_net_G.pth", "latest_net_D.pth", "iter.txt"}
                    if joint.gan.gan_train else set())
                check(np.isfinite(bests[label]) and want <= files,
                      f"{label}: no finite mAP or a missing file ({sorted(files)})")
        warmup = config(os.path.join(tmp, "warmup"))
        warmup.gan.model, warmup.gan.model_gen = "AE", "AE"
        warmup.gan.save_dir = os.path.join(tmp, "ckpt_warmup")
        small = types.SimpleNamespace(train=dataset.train[:512])   # 2 batches of 256
        state = counted("cli/train_gan_warmup.run (2 iterations)", tuple(
            k.name for k in kernels.KERNELS if k.name != "gan_input"),
            lambda: train_gan_warmup.run(warmup, small, image_cache=cache, mesh=mesh))
        if mesh.rank == 0:
            nets = sorted(os.listdir(os.path.join(warmup.gan.save_dir, "experiment")))
            saved.append(("warmup", nets))
            check(state.step == 2 and {"latest_net_G.pth", "latest_net_D.pth"} <= set(nets),
                  f"the warm-up took {state.step} steps, wrote {nets}")
        fd_best = _ddp_fd_chain(mesh, os.path.join(tmp, "fd"), counted)
    print(f"[ddp] cli/train_gan_usl.run best mAP: "
          + ", ".join(f"{k} {v:.4f}" for k, v in bests.items()) + f"; rank 0 wrote {saved}")
    if mesh.rank == 0:
        check(np.isfinite(best_usl), "cli/train_usl.run: no finite mAP")
        check(np.isfinite(fd_best), "cli/fdgan_baseline.run: no finite mAP")
    return total


def _ddp_fd_chain(mesh, root, counted):
    """Under the mesh, FD-GAN's chain through its CLIs' ``run`` at full width
    (ResNet-50 nets at 256x128, 256 pairs, 2 steps an epoch on 256 train
    images of 32 ids, 64 + 192 eval): ``cli/fdgan_baseline.run``, then
    ``cli/fdgan_train.run`` stage 1 from its checkpoint and stage 2 from the
    stage-1 nets, each through ``counted`` (its launches held to its
    kernels). Each rank writes its landmark files under its own ``root``;
    the logs and nets go under rank 0's, which every rank reads, as the
    CLIs' ranks share one file system. Returns the baseline's best mAP."""
    import copy

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import fdgan_baseline, fdgan_train
    from reid_gan_torch.config import Config
    from reid_gan_torch.parallel import broadcast_object

    ds, imgs = _fd_set(root, seed=13, n_ids=32, per_id=8, n_query=64, n_gallery=192)
    cache = _in_memory_images(imgs)
    root = broadcast_object(mesh, root)
    cfg = Config()
    cfg.data.workers, cfg.data.batch_size = 4, 256
    cfg.train.epochs, cfg.train.eval_step = 1, 1
    cfg.train.logs_dir = os.path.join(root, "base")
    cfg.fdgan.niter, cfg.fdgan.niter_decay, cfg.fdgan.eval_step = 1, 0, 1
    cfg.gan.save_dir = os.path.join(root, "ckpt")

    def off(*on):
        return tuple(k.name for k in kernels.KERNELS if k.name not in on)

    best = counted("cli/fdgan_baseline.run (2 steps)",
                   off("eval_transform", "rank_stats", "fd_augment"),
                   lambda: fdgan_baseline.run(cfg, ds, image_cache=cache, mesh=mesh))
    c1 = copy.deepcopy(cfg)
    c1.fdgan.stage, c1.fdgan.pose_aug = 1, "gauss"
    c1.fdgan.netE_pretrain = os.path.join(root, "base", "model_best.pth.tar")
    c1.train.logs_dir, c1.gan.name = os.path.join(root, "s1"), "s1"
    m1 = counted("cli/fdgan_train.run stage 1 (2 steps)", off("pose_peaks", "fd_augment"),
                 lambda: fdgan_train.run(c1, ds, image_cache=cache, mesh=mesh))
    s1 = os.path.join(root, "ckpt", "s1")
    c2 = copy.deepcopy(cfg)
    c2.fdgan.stage, c2.fdgan.pose_aug = 2, "erase"
    c2.fdgan.netE_pretrain, c2.fdgan.netG_pretrain, c2.fdgan.netDi_pretrain, \
        c2.fdgan.netDp_pretrain = (os.path.join(s1, f"latest_net_{n}.pth")
                                   for n in ("E", "G", "Di", "Dp"))
    c2.train.logs_dir, c2.gan.name = os.path.join(root, "s2"), "s2"
    m2 = counted("cli/fdgan_train.run stage 2 (2 steps)",
                 off("eval_transform", "rank_stats", "pose_peaks", "fd_augment"),
                 lambda: fdgan_train.run(c2, ds, image_cache=cache, mesh=mesh))
    if mesh.rank == 0:
        saved = sorted(os.listdir(os.path.join(root, "ckpt", "s2")))
        # G's Adam counts the steps each stage took
        steps = [int(next(iter(m.opt_G.state.values()))["step"]) for m in (m1, m2)]
        print(f"[ddp] FD chain under the mesh: baseline best mAP {best:.4f}; steps "
              f"{steps}; stage 2 wrote {saved}")
        check(steps == [2, 2] and {"best_net_E.pth", "latest_net_Dp.pth"}
              <= set(saved), "the FD chain under the mesh did not run or write its nets")
    return best


def phase_vgg_warmup():
    """``--use-vgg`` on the GAN warm-up's path: ``GANTrainer.train_gan`` with
    the AE generator and VGG19 at ``[warmup]``'s configuration (batch 256,
    128x64): 20 iterations (K9 once an iteration, nothing else), the peak
    memory, warm iterations without and with VGG in turns."""
    from reid_gan_torch import kernels
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.data import IterLoader
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.engine.gan_trainers import GANTrainer
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan

    t_phase = time.perf_counter()
    items, imgs = _pseudo_set()
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="AE", model_gen="AE", use_vgg=True), gan_height=128,
                     gan_width=64, device="cuda")
    pre = Preprocessor(items, mode="only_gan", gan_height=128, gan_width=64,
                       cache=_in_memory_images(imgs, imgs[:, ::2, ::2]))
    it = IterLoader(DataLoader(pre, batch_size=256, shuffle=True, num_workers=4,
                               drop_last=True, seed=2))
    it.new_epoch()
    trainer = GANTrainer(gan, print_freq=10, device="cuda")
    state = gan.init_state()
    iters = 20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, errs = trainer.train_gan(state, 0, it, train_iters=iters, base_seed=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[vgg_warmup] {iters} D->G iterations with VGG (1st): {wall:.2f} s; mean "
          + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()) + "; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[vgg_warmup] launches: {kernels.phase_launch_counts()}")
    check(launches["gan_input"] == iters and
          all(v == 0 for k, v in launches.items() if k != "gan_input"),
          f"the warm-up launched other than K9 once an iteration: {launches}")
    check(all(np.isfinite(v) for v in errs.values()), f"losses not finite: {errs}")
    vgg, gan.vgg = gan.vgg, None
    trainer.train_gan(state, 1, it, train_iters=2, base_seed=2)     # cuDNN warm

    def iterations(side):
        gan.vgg = vgg if side else None
        trainer.train_gan(state, 2, it, train_iters=5, base_seed=2)

    ms, _ = _turns("vgg_warmup", iterations, "iteration", 5)
    print(f"[vgg_warmup] warm: {256e3 / np.mean(ms[True]):.1f} img/s with VGG, "
          f"{256e3 / np.mean(ms[False]):.1f} without (batch 256, AE G and D at 128x64, "
          f"fp32 weights, TF32 convolutions)")
    it.close()
    print(f"[vgg_warmup] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _gan_batch(n, seed):
    """``n`` uint8 GAN images at 128x64 of phase 4's set on the card and
    their pose maps through K10 (keypoints from a seed in the 256x128
    frame, a fifth missing), (N, 18, 128, 64)."""
    from reid_gan_torch.ops.pose import batch_cords_to_map

    items, imgs = _pseudo_set()
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.permutation(len(items))[:n])
    old = np.tile(np.asarray([[256.0, 128.0]], np.float32), (n, 1))
    xs = torch.from_numpy(np.ascontiguousarray(imgs[idx, ::2, ::2])).cuda()
    cords = torch.from_numpy(_keypoints(rng, n, old)).cuda()
    old = torch.from_numpy(old).cuda()
    return xs, cords, old, batch_cords_to_map(cords, old, 128, 64)


def phase_dptn(batch=256):
    """The DPTN engine at full width (ngf 64, num_feats 256, 3 layers, 3
    blocks, 2 CABs and 2 TTBs, 128x64): source and target images through
    K9, their pose maps through K10; 3 steps, one more with VGG19, and
    ``synthesize_pair``."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.ops.transforms import gan_input_transform

    t_phase = time.perf_counter()
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="DPTN", use_vgg=True), gan_height=128, gan_width=64,
                     device="cuda")
    xs_u8, _, _, ps = _gan_batch(batch, 21)
    xt_u8, _, _, pt = _gan_batch(batch, 22)
    b = {"Xs": gan_input_transform(xs_u8, 128, 64), "Ps": ps,
         "Xt": gan_input_transform(xt_u8, 128, 64), "Pt": pt}
    state = gan.init_state()
    g = torch.Generator(device="cuda").manual_seed(0)
    vgg = gan.vgg
    print(f"[dptn] DPTNModel: G {sum(p.numel() for p in gan.net_G.parameters()):,} and D "
          f"{sum(p.numel() for p in gan.net_D.parameters()):,} parameters; batch {batch} "
          f"at 128x64 (K9), pose maps {tuple(ps.shape)} (K10)")
    torch.cuda.reset_peak_memory_stats()
    for i, use in enumerate((False, False, False, True)):
        gan.vgg = vgg if use else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, errs, fake = gan.optimize_parameters(state, b, g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = {k: float(v) for k, v in errs.items()}
        print(f"[dptn] step {i}{' with VGG' if use else ''}{' (cuDNN cold)' if i == 0 else ''}"
              f": {dt * 1e3:.1f} ms; G {losses['G']:.4f}, D {losses['D']:.4f}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(all(np.isfinite(v) for v in losses.values()) and fake.shape == (
            batch, 3, 128, 64), f"step {i}: losses not finite or a fake of the wrong shape")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    neg = gan.synthesize_pair(b["Xs"], b["Ps"], b["Pt"])
    torch.cuda.synchronize()
    print(f"[dptn] synthesize_pair {tuple(neg.shape)}: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; finite {bool(torch.isfinite(neg).all())}")
    check(bool(torch.isfinite(neg).all()) and not neg.requires_grad,
          "synthesize_pair not finite or not detached")
    print(f"[dptn] phase wall time {time.perf_counter() - t_phase:.1f} s")


def phase_generators(batch=256):
    """The other generators at full width on the card: ``DECGenerator1`` on
    a ResNet-50's GAN map (K1, K11), ``FDGenerator`` on 2048-wide vectors and
    512-wide noise, one standalone step of the ``PoseAE`` engine (K9, K10)
    held against the plain versions, and the pose generator with
    ``norm="instance"``."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.models.dual_gan.networks import define_G
    from reid_gan_torch.ops.transforms import eval_transform

    t_phase = time.perf_counter()
    xs_u8, cords, old, ps = _gan_batch(batch, 23)
    _, imgs = _pseudo_set()
    torch.manual_seed(0)
    model = create("resnet50", norm=True).to("cuda", memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        fmap = model(eval_transform(torch.from_numpy(imgs[:batch]).cuda(), 256, 128,
                                    torch.float32), test_all=True)["gan_feat"]
    fmap = fmap.clone()
    noise = torch.randn((batch, 512), device="cuda")
    runs = (("DECGenerator1 on the GAN map", define_G("DEC"), (fmap,)),
            ("FDGenerator (add) on pooled maps + noise", define_G("FD"),
             (fmap.mean(dim=(2, 3)), noise)),
            ("pose generator, norm instance", define_G("Pose", norm="instance"),
             (fmap, ps)))
    for name, net, args in runs:
        net = net.cuda().train()
        times = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = net(*args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        print(f"[generators] {name}: {tuple(args[0].shape)} -> {tuple(out.shape)}, train-mode "
              f"forward {times[0]:.1f} ms cold, {min(times[1:]):.2f} ms warm; finite "
              f"{bool(torch.isfinite(out).all())}")
        check(bool(torch.isfinite(out).all()) and out.shape[:2] == (batch, 3),
              f"{name}: not finite or the wrong shape")
        del net, out
    gan = create_gan(GANConfig(model="AE", model_gen="PoseAE"), gan_height=128,
                     gan_width=64, device="cuda")
    _hold_standalone_step("generators PoseAE", gan, xs_u8, cords, old)
    state = gan.init_state()
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, errs, _ = gan.optimize_parameters(state, xs_u8, pose=ps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
    print(f"[generators] PoseAE standalone step (batch {batch}, 128x64): {dt:.1f} ms warm; "
          f"G {float(errs['G']):.4f}, D {float(errs['D']):.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[generators] phase wall time {time.perf_counter() - t_phase:.1f} s")


def check_k3_variants(report):
    """K3's all-shots rows and separate camera set against the plain pass at
    Market-1501's eval shape, distinct and with exact ties."""
    from reid_gan_torch.engine.metrics import rank_stats, rank_stats_plain
    from reid_gan_torch.ops.distance import squared_euclidean

    g = torch.Generator(device="cuda").manual_seed(33)
    chunk, topk, tol = 1024, 100, 1e-5   # fp32 AP and row sums in another order
    worst, timed = 0.0, None
    for ties in (False, True):
        qf, gf, qid, qcam, gid, gcam = _market_block(g, ties)
        d = squared_euclidean(qf[:chunk], gf)
        if ties:
            n = gf.shape[0]
            d[:, 1::2] = d[:, 0::2][:, :n // 2]
        args = (d, qid[:chunk].contiguous(), qcam[:chunk].contiguous(), gid, gcam)
        for sep in (False, True):
            out, ref, err = _k3_held(args, tol, f"variant (sep {sep}, ties {ties})",
                                     separate_camera_set=sep, allshots_topk=topk)
            ap, fb, nm, hist = out
            e_ap = float((ap - ref[0]).abs().max())
            print(f"[K3] all-shots, separate camera set {sep}, "
                  f"{'exact ties' if ties else 'distinct'}: counts and first bins equal; "
                  f"AP max_abs_err {e_ap:.3g}, all-shots rows max_abs_err "
                  f"{float((hist - ref[3]).abs().max()):.3g} (tol {tol:.3g}); all-shots "
                  f"top-1 {float(hist[nm > 0, 0].mean()):.4f}; the same bits on a second "
                  f"launch; digest of the outputs and rows {_digest(*out)}")
            worst = max(worst, err)
        if not ties:
            timed = args
    ms = device_ms(lambda: rank_stats(*timed, separate_camera_set=True, allshots_topk=topk))
    plain = device_ms(lambda: rank_stats_plain(*timed, separate_camera_set=True,
                                               allshots_topk=topk), reps=3)
    q_, n_ = timed[0].shape
    b, by = _k3_bound(q_, n_, topk, 3)
    print(f"[K3] all-shots + separate cameras per {q_}-query chunk: ms {ms:.4f} plain_ms "
          f"{plain:.4f} bound_ms {b:.4f} ({by}, {100 * b / ms:.1f}%)")
    report["rank_stats"].update(variant_ms=ms, variant_plain_ms=plain, variant_bound_ms=b,
                                variant_max_abs_err=worst)


def check_k8_k_range(report):
    """K8 above the register lists (k 65, 128, 256, 300 at N 2,048, L2 and
    inner product, distinct and with exact ties) against the plain kNN, and
    k 128 timed at Market-1501's 12,936 rows."""
    from reid_gan_torch.ops.distance import knn_search_plain, knn_topk_cuda

    g = torch.Generator(device="cuda").manual_seed(81)
    n, tol = 2048, 2e-5
    f = _train_features(g, n)
    fq = _train_features(g, n, quantize=True)
    for k, metric in ((65, "l2"), (128, "ip"), (256, "l2"), (300, "ip")):
        vals, idx = (t.cpu().numpy() for t in knn_topk_cuda(f, k, metric))
        pv, pi = knn_search_plain(f, k, metric)
        err = float(np.abs(vals - pv).max())
        rows, gap = _swap_gap(f, idx, pv, pi, metric)
        tv, ti = (t.cpu().numpy() for t in knn_topk_cuda(fq, k, metric))
        qv, qi = knn_search_plain(fq, k, metric)
        ties = int((qv[:, 1:] == qv[:, :-1]).sum())
        same = bool(np.array_equal(ti, qi) and np.array_equal(tv, qv))
        print(f"[K8] k {k} {metric} N {n}: vals max_abs_err {err:.3g} (tol {tol:.3g}), "
              f"{rows.size} swapped entries, largest plain-side gap {gap:.3g}; exact ties: "
              f"{ties} tied pairs, indices and values identical: {same}")
        check(err <= tol and gap <= tol and ties > 0 and same,
              f"K8 k {k} {metric} differs from the plain version")
    fm = _train_features(g, 12936)
    ms = device_ms(lambda: knn_topk_cuda(fm, 128, "l2"), reps=3)
    plain = device_ms(lambda: knn_search_plain(fm, 128, "l2"), reps=3)
    vals, idx = (t.cpu().numpy() for t in knn_topk_cuda(fm, 128, "l2"))
    pv, pi = knn_search_plain(fm, 128, "l2")
    err = float(np.abs(vals - pv).max())
    check(err <= tol, f"K8 k 128 at N 12936: error {err}")
    b, by, b_fp32 = _k8_bound(12936, 2048, 128)
    print(f"[K8] k 128 L2 at N 12936: vals max_abs_err {err:.3g}; ms {ms:.4f} plain_ms "
          f"{plain:.4f} bound_ms {b:.4f} ({by}, 3xTF32; {b_fp32:.4f} as fp32 FMA); "
          f"scratch {_k8_scratch_bytes(12936, 128)} bytes, at N 32621 k 300 "
          f"{_k8_scratch_bytes(32621, 300)} bytes")
    report["knn_topk"].update(k128_ms=ms, k128_plain_ms=plain, k128_bound_ms=b)


def _landmarks(rng, n, h=256, w=128):
    """(n, 18, 2) landmarks in the 256x128 frame, a sixth missing in y, in x
    or in both, the first image's joints on the corners and edges."""
    lm = np.stack([rng.integers(0, h, (n, 18)), rng.integers(0, w, (n, 18))], -1)
    miss = rng.integers(0, 18, (n, 18))
    lm[miss == 0, 0] = -1
    lm[miss == 1, 1] = -1
    lm[miss == 2] = -1
    lm[0, :6] = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 2, 0), (0, w // 2)]
    return lm.astype(np.float32)


def check_k13(report):
    """K13 at the recipe's (512, 18, 256, 128): σ 4, 5 and 6, erased
    channels, missing and corner joints, flips."""
    from reid_gan_torch.ops.pose import render_pose_peaks, render_pose_peaks_plain

    n, k, h, w = 512, 18, 256, 128
    rng = np.random.default_rng(13)
    lm = torch.from_numpy(_landmarks(rng, n)).cuda()
    sigma = torch.tensor([4.0, 5.0, 6.0], device="cuda")[torch.arange(n, device="cuda") % 3]
    erase = torch.from_numpy(np.where(rng.random(n) < 0.5, rng.integers(0, k, n), -1)
                             .astype(np.int32)).cuda()
    flip = torch.from_numpy((rng.random(n) < 0.5).astype(np.int32)).cuda()
    args = (lm, sigma.contiguous(), erase, flip, h, w)
    out = render_pose_peaks(*args)
    ref = render_pose_peaks_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-6   # expf against torch.exp: an ulp or two of values <= 1
    corner = float(out[0, 0, 0, w - 1 if flip[0] else 0])
    print(f"[K13] pose_peaks ({n}, {k}, {h}, {w}), sigma 4/5/6, {int((erase >= 0).sum())} "
          f"erased channels, {int(((lm[..., 0] == -1) | (lm[..., 1] == -1)).sum())} missing "
          f"joints, {int(flip.sum())} flips: max_abs_err {err:.3g} (tol {tol:.3g}); corner "
          f"peak {corner}")
    check(err <= tol and corner == 1.0, f"K13 error {err} > {tol}")
    ms = device_ms(lambda: render_pose_peaks(*args))
    plain = device_ms(lambda: render_pose_peaks_plain(*args))
    b, by = bound_ms(4 * (out.numel() + lm.numel() + 3 * n), 8 * out.numel())
    print(f"[K13] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by})")
    report["pose_peaks"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                bound_by=by)


def check_k14(report):
    """K14 at 512 x 256x128 with the port's draws (about half erased, half
    flipped): against the plain version, the same bits on a second launch
    (and, through the digest, as a parent's run), then timed."""
    from reid_gan_torch.ops.transforms import (
        fd_augment,
        fd_augment_plain,
        sample_fd_augment_params,
    )

    n, h, w = 512, 256, 128
    g = torch.Generator(device="cuda").manual_seed(14)
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device="cuda", generator=g)
    params = sample_fd_augment_params(n, h, w, g)
    out = fd_augment(u8, params)
    ref = fd_augment_plain(u8, params)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.stride() == ref.contiguous(
        memory_format=torch.channels_last).stride(), "K14 layout is not channels_last")
    err = float((out - ref).abs().max())
    tol = 1e-6   # IEEE divisions and the same order in both
    same = _same_bits(lambda: fd_augment(u8, params), out)
    print(f"[K14] fd_augment {n}x{h}x{w}, {int(params[:, 0].sum())} erased, "
          f"{int(params[:, 5].sum())} flipped: max_abs_err {err:.3g} (tol {tol:.3g}); "
          f"digest {_digest(out)}; a second launch gives the same bits: {same}")
    check(err <= tol, f"K14 error {err} > {tol}")
    check(same, "K14 wrote other bits on a second launch")
    ms = device_ms(lambda: fd_augment(u8, params))
    plain = device_ms(lambda: fd_augment_plain(u8, params))
    b, by = bound_ms(u8.numel() * (1 + 4) + 4 * params.numel(), 3 * u8.numel())
    print(f"[K14] ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b:.4f} ({by}, {b / ms:.1%})")
    report["fd_augment"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                bound_by=by)


def _fd_set(root, seed=0, n_ids=128, per_id=8, n_query=256, n_gallery=768, h=256, w=128):
    """An FD-GAN set in memory (images) and on disk (landmark files under
    ``root/poses``): ``n_ids`` x ``per_id`` train images and an eval split
    of other ids, 6 cameras, two colour blocks an id plus noise, staged at
    256x128, landmarks from a seed in the 256x128 frame."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    n_train = n_ids * per_id
    n = n_train + n_query + n_gallery
    eval_ids = (n_query + n_gallery) // 4
    pids = np.concatenate([np.arange(n_train) // per_id,
                           n_ids + np.arange(n_query + n_gallery) % eval_ids])
    cams = rng.integers(0, 6, n)
    imgs = _two_colour_images(rng, pids, h, w)
    names = [f"{pids[i]:04d}_c{cams[i] + 1}_{i:06d}.jpg" for i in range(n)]
    items = [(names[i], int(pids[i]), int(cams[i])) for i in range(n)]
    poses = os.path.join(root, "poses")
    os.makedirs(poses, exist_ok=True)
    lm = _landmarks(rng, n_train, h, w).astype(int)
    for name, pts in zip(names[:n_train], lm):
        with open(os.path.join(poses, name[:-4] + ".txt"), "w") as f:
            f.write("".join(f"{y} {x}\n" for y, x in pts))
    pid_imgs = {}       # lists in the set's order, the same in every process
    for name, pid, _ in items[:n_train]:
        pid_imgs.setdefault(pid, []).append(name)
    return SimpleNamespace(train=items[:n_train], query=items[n_train:n_train + n_query],
                           gallery=items[n_train + n_query:], pid_imgs=pid_imgs,
                           poses_dir=poses), imgs


class _PlainFD:
    """Within the block, the FD-GAN step's K13 and K14 run as their plain
    versions (the names the engines call are rebound), with the augmented
    images multiplied by (1 + ``jitter`` noise) when ``jitter``."""

    def __init__(self, jitter=0.0):
        self.jitter = jitter

    def __enter__(self):
        from reid_gan_torch.engine import fdgan
        from reid_gan_torch.models.fdgan import model
        from reid_gan_torch.ops.pose import render_pose_peaks_plain
        from reid_gan_torch.ops.transforms import fd_augment_plain

        jitter = self.jitter

        def aug(img, params):
            x = fd_augment_plain(img, params).contiguous(memory_format=torch.channels_last)
            if jitter:
                x = x * (1 + jitter * torch.randn(
                    x.shape, device=x.device, generator=torch.Generator(
                        device=x.device).manual_seed(1)))
            return x.contiguous(memory_format=torch.channels_last)

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (fdgan, "fd_augment"), (model, "fd_augment"), (model, "render_pose_peaks"))]
        fdgan.fd_augment = model.fd_augment = aug
        model.render_pose_peaks = render_pose_peaks_plain
        return self

    def __exit__(self, *exc):
        for m, n, v in self.saved:
            setattr(m, n, v)
        return False


def _held_against_plain(label, nets, opts, run, grad_names, gated, tol_loss=1e-3,
                        tol_out=1e-4, late_losses=(), tol_late=1e-2, limits=None):
    """One step through the kernels and the same step through the plain
    versions (with ``gated`` limits also a plain repeat, the card's spread,
    and a plain step with the augmented inputs jittered by 1e-6), from the
    same weights, buffers and draws, TF32 off and cuDNN's
    deterministic algorithms on (its split weight-gradient sums otherwise
    move a GAN step's gradients by up to 1% between identical runs). ``run()``
    returns (losses dict, output tensor); ``grad_names``: (net, parameter)
    pairs whose gradients are read after the step. The losses and the output
    are held at ``tol_loss`` (relative; ``tol_late`` for the ``late_losses``,
    which follow a discriminator's update) and ``tol_out``; ``gated`` maps the
    index of a gradient to its limit (max relative error), which must lie
    between the plain repeat's spread and the jittered reading; ``limits``
    maps the index of a gradient to a limit alone; the other gradients are
    printed. Weights, buffers and optimiser states are restored after."""
    import copy

    snap = [copy.deepcopy(m.state_dict()) for m in nets.values()]
    tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    named = {n: dict(m.named_parameters()) for n, m in nets.items()}
    results = []
    try:
        # the repeat and the jittered step place the gated limits; without
        # gated limits only the kernels' and the plain step run
        runs = ((False, 0.0), (True, 0.0), (True, 0.0), (True, 1e-6))
        for plain, jitter in runs if gated else runs[:2]:
            for m, sd in zip(nets.values(), snap):
                m.load_state_dict(sd)
            for opt in opts:
                opt.state.clear()
            if plain:
                with _PlainFD(jitter):
                    losses, out = run()
            else:
                losses, out = run()
            grads = [named[n][p].grad.detach().clone() for n, p in grad_names]
            results.append(({k: float(v) for k, v in losses.items()}, out.detach().clone(),
                            grads))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
        for m, sd in zip(nets.values(), snap):
            m.load_state_dict(sd)
            m.zero_grad(set_to_none=True)
        for opt in opts:
            opt.state.clear()
    limits = limits or {}
    (lk, ok, gk), (lp, op, gp) = results[:2]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    e_l = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    e_loss = max([e_l[k] for k in lp if k not in late_losses] or [0.0])
    e_late = max([e_l[k] for k in late_losses] or [0.0])
    e_out = float((ok - op).abs().max())
    e_g = [rel(a, b) for a, b in zip(gk, gp)]
    if gated:
        (lr, _, g_rep), (_, _, g_jit) = results[2:]
        e_lr = max(abs(lr[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
        e_rep, e_jit = ([rel(a, b) for a, b in zip(g, gp)] for g in (g_rep, g_jit))
    print(f"[{label}] one step, kernels vs plain versions (TF32 off): losses "
          + ", ".join(f"{k} {lk[k]:.6f}/{lp[k]:.6f}" for k in lp)
          + f" (max rel err {e_loss:.3g}, tol {tol_loss:.3g}"
          + (f"; after the D updates, {', '.join(late_losses)}: {e_late:.3g}, tol "
             f"{tol_late:.3g}" if late_losses else "")
          + (f"; plain repeat {e_lr:.3g}" if gated else "")
          + f"); output max_abs_err {e_out:.3g} (tol {tol_out:.3g})")
    print(f"[{label}] parameter grads, max rel err kernels vs plain"
          + (" (plain repeat; plain with the input x(1 + 1e-6 noise))" if gated else "")
          + " [limit]: " + ", ".join(
              f"{'.'.join(n)} {e_g[i]:.3g}"
              + (f" ({e_rep[i]:.3g}; {e_jit[i]:.3g}) [{gated[i]:.3g}]" if i in gated else "")
              + (f" [{limits[i]:.3g}]" if i in limits else "")
              for i, n in enumerate(grad_names)))
    check(e_loss <= tol_loss and e_late <= tol_late and e_out <= tol_out
          and all(e_g[i] <= t for i, t in {**gated, **limits}.items()),
          f"the {label} step through the kernels differs from the plain versions")
    check(all(e_rep[i] < t < e_jit[i] for i, t in gated.items()),
          f"[{label}] a gradient's limit no longer lies between the plain repeat's "
          "spread and the 1e-6 input noise's reading")


def phase_fd_stage1(counts, fd_set, root, batch=256):
    """FD-GAN stage I at full width: ``SiameseTrainer`` (ResNet-50, last
    stride 2, average pool, the square-difference head) on ``pair`` batches
    of ``batch`` pairs from ``RandomPairSampler``; then the two-stage
    ``CascadeEvaluator`` on ``[main]``'s eval set, ``dataset=None``. The
    trained net goes to ``root/stage1.pth.tar``, which ``[fd_stage2]``
    starts from, as the recipe's stage II does."""
    from reid_gan_torch import kernels
    from reid_gan_torch.cli.fdgan_baseline import _limit, make_cascade_evaluator
    from reid_gan_torch.config import Config
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.data.sampler import RandomPairSampler
    from reid_gan_torch.engine.fdgan import SiameseTrainer
    from reid_gan_torch.models import siamese_baseline
    from reid_gan_torch.ops.transforms import sample_fd_augment_params
    from reid_gan_torch.utils.serialization import save_checkpoint

    torch.backends.cudnn.allow_tf32 = True
    ds, imgs = fd_set
    torch.manual_seed(0)
    model = siamese_baseline(50)
    trainer = SiameseTrainer(model, lr=0.01, step_size=40, device="cuda", seed=0)
    cache = _in_memory_images(imgs)

    def loader(epoch):
        pre = Preprocessor(ds.train, mode="pair", seed=epoch, cache=cache)
        return DataLoader(pre, sampler=RandomPairSampler(ds.train, seed=epoch),
                          batch_size=batch, num_workers=4, drop_last=True)

    b1, b2 = next(iter(loader(99)))
    i1, i2 = (torch.from_numpy(b["img"]).cuda() for b in (b1, b2))
    tgt = torch.from_numpy((b1["pid"] == b2["pid"]).astype(np.int64)).cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    p1, p2 = (sample_fd_augment_params(batch, 256, 128, g) for _ in range(2))

    def run():
        loss, logits = trainer.step(i1, i2, tgt, p1, p2)
        return {"loss": loss}, logits

    # at random init the Siamese gradients are ill-conditioned: 1e-6 noise on
    # the input moves layer4's by about 0.8% and the classifier's by 2.4e-4
    _held_against_plain("fd_stage1", {"siamese": model}, [trainer.optimizer], run,
                        [("siamese", "base_model.layer4.2.conv3.weight"),
                         ("siamese", "embed_model.classifier.weight"),
                         ("siamese", "base_model.conv1.weight")], gated={0: 6e-3, 1: 1.5e-4})

    steps = 20
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = 0
    for epoch in range(3):
        left = steps - batches
        if left <= 0:
            break
        trainer.train(epoch, _limit(loader(epoch), left), print_freq=10)
        batches += min(left, 2 * len(ds.train) // batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = kernels.phase_launch_counts()
    print(f"[fd_stage1] {steps} Siamese steps of {batch} pairs (1st, cuDNN cold): "
          f"{wall:.2f} s; launches: {phases}")
    check(phases["fd_augment.forward"] == 2 * steps,
          f"fd_augment launched {phases['fd_augment.forward']} times, not twice a step")
    check(sum(v for k, v in phases.items() if not k.startswith("fd_augment")) == 0,
          "a kernel other than K14 launched on the Siamese step")
    still = [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])]
    check(not still, f"Siamese parameters that did not move: {still[:5]}")
    print(f"[fd_stage1] peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    warm = 10
    it = _limit(loader(7), warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(7, it, print_freq=warm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[fd_stage1] warm: {warm / dt:.3f} steps/s, {warm * 2 * batch / dt:.1f} img/s "
          f"({batch} pairs, ResNet-50 at 256x128, fp32 weights, TF32 convolutions)")
    profile_device("fd_stage1 (3 warm steps)",
                   lambda: trainer.train(8, _limit(loader(8), 3), print_freq=3))

    batches_e, query, gallery = _eval_set()
    cfg = Config()
    evaluator = make_cascade_evaluator(model, cfg, "cuda")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top1 = evaluator.evaluate(batches_e, query, gallery, rerank_topk=100, dataset=None)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[fd_stage1] CascadeEvaluator.evaluate ({len(query)} + {len(gallery)}, top 100 "
          f"re-scored, dataset=None): {time.perf_counter() - t0:.2f} s, allshots top-1 "
          f"{top1:.4f}; launches {launches}")
    # per stage: the mAP pass, the allshots pass (all-shots rows), the
    # market1501 pass, one 1,024-query chunk each
    check(launches["eval_transform"] == len(batches_e) and launches["rank_stats"] == 6
          and 0.0 <= top1 <= 1.0, "the cascade evaluation did not run K1 and K3's variants")
    counts.update({k: v for k, v in launches.items() if v})
    save_checkpoint({"state_dict": model.state_dict()}, False,
                    os.path.join(root, "stage1.pth.tar"))


def _fd_pair_loader(ds, imgs, batch, seed):
    from reid_gan_torch.data import IterLoader
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.data.sampler import RandomPairSampler

    pre = Preprocessor(ds.train, mode="fdgan_pose", pid_imgs=ds.pid_imgs,
                       pose_root=ds.poses_dir, seed=seed, cache=_in_memory_images(imgs))
    it = IterLoader(DataLoader(pre, sampler=RandomPairSampler(ds.train, seed=seed),
                               batch_size=batch, num_workers=4, drop_last=True))
    it.new_epoch()
    return it


def phase_fd_gan(stage, fd_set, root, batch=256, steps=3, warm=2):
    """One FD-GAN stage at full width: ``FDGANModel`` (E and Di ResNet-50
    Siamese nets at 256x128, G with ngf 64, Dp with ndf 64) on ``fdgan_pose``
    batches of ``batch`` pairs. ``stage`` 1 is paper stage II, from
    ``[fd_stage1]``'s checkpoint (E, and Di from it); 2 is paper stage III,
    from the nets stage II wrote under ``root/s1``."""
    from reid_gan_torch import kernels
    from reid_gan_torch.config import FDGANConfig
    from reid_gan_torch.models.fdgan.model import FDGANModel
    from reid_gan_torch.utils.serialization import save_networks

    label = f"fd_stage{stage + 1}"
    torch.backends.cudnn.allow_tf32 = True
    ds, imgs = fd_set
    torch.manual_seed(stage)
    cfg = FDGANConfig(stage=stage, pose_aug="gauss" if stage == 1 else "erase",
                      lambda_veri=10.0, lambda_sp=10.0)
    if stage == 1:
        cfg.netE_pretrain = os.path.join(root, "stage1.pth.tar")
    else:
        cfg.netE_pretrain, cfg.netG_pretrain, cfg.netDi_pretrain, cfg.netDp_pretrain = (
            os.path.join(root, "s1", f"latest_net_{n}.pth") for n in ("E", "G", "Di", "Dp"))
    model = FDGANModel(cfg, device="cuda", seed=stage)
    it = _fd_pair_loader(ds, imgs, batch, seed=stage)
    b1, b2 = it.next()
    draws = model.sample_draws(batch)
    g_state = model.generator.get_state()

    def run():
        model.generator.set_state(g_state)     # the same dropout masks
        return model.optimize_step(b1, b2, draws)

    grads = [("G", "de_conv1_conv.weight"), ("Dp", "conv_out.weight"),
             ("Di", "base_model.layer4.2.conv3.weight"), ("Di", "embed_model.classifier.weight")]
    if stage == 2:
        grads.append(("E", "base_model.layer4.2.conv3.weight"))
    # K13 and K14 divide as their plain versions do (IEEE), so with cuDNN
    # deterministic the two steps should agree bit for bit. Each gradient
    # still has a limit: the readings of earlier chip runs, whose plain K14
    # divided by 255 through the reciprocal (an ulp off on most pixels),
    # which Di's update amplified into G's gradient (up to 4.7e-2) and less
    # elsewhere (Dp 7.8e-7, Di layer4 1.1e-3, classifier 1.1e-5, E 3.4e-4).
    limits = {0: 1e-1, 1: 1e-5, 2: 1e-2, 3: 1e-4, 4: 3e-3}
    _held_against_plain(label, model.nets(), [model.opt_G, model.opt_Di, model.opt_Dp], run,
                        grads, gated={}, tol_loss=1e-4,
                        late_losses=("G", "G_gan_Di", "G_gan_Dp"),
                        limits={i: t for i, t in limits.items() if i < len(grads)})

    nets = model.nets()
    before = {(k, n): p.detach().clone() for k, m in nets.items()
              for n, p in m.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        errs, fake = model.optimize_step(*it.next())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = kernels.phase_launch_counts()
    print(f"[{label}] {steps} steps of {batch} pairs (1st, cuDNN cold): {wall:.2f} s; "
          f"last losses " + ", ".join(f"{k} {float(v):.4f}" for k, v in errs.items()))
    print(f"[{label}] launches: {phases}")
    check(phases["pose_peaks.forward"] == steps and phases["fd_augment.forward"] == 2 * steps,
          "K13 must launch once a step and K14 twice")
    check(sum(v for k, v in phases.items()
              if not k.startswith(("pose_peaks", "fd_augment"))) == 0,
          "a kernel other than K13 and K14 launched on the GAN step")
    check(all(np.isfinite(float(v)) for v in errs.values()) and bool(torch.isfinite(fake).all())
          and fake.shape == (2 * batch, 3, 256, 128), "losses or the fake not finite")
    moved = {k: any(not torch.equal(p.detach(), before[(k, n)])
                    for n, p in m.named_parameters()) for k, m in nets.items()}
    print(f"[{label}] nets whose parameters moved: {moved}")
    check(moved == {"E": stage == 2, "G": True, "Di": True, "Dp": True},
          "the nets that train are not the stage's")
    print(f"[{label}] peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warm):
        model.optimize_step(*it.next())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[{label}] warm: {warm / dt:.3f} steps/s, {warm * 2 * batch / dt:.1f} img/s "
          f"({batch} pairs at 256x128)")
    model.marks = []
    profile_device(f"{label} (1 warm step)", lambda: model.optimize_step(*it.next()))
    marks, model.marks = model.marks, None
    print(f"[{label}] device time by phase (CUDA events, 1 step, ms): "
          + _split_by_marks(marks, 1))
    it.close()
    if stage == 1:
        save_networks(model.nets(), os.path.join(root, "s1"), "latest")


def phase_fd_chain(counts, root, batch=256):
    """FD-GAN's three stages through their CLIs' ``run``: ``cli/fdgan_baseline``
    → ``cli/fdgan_train --stage 1`` from its checkpoint → ``--stage 2`` from
    the stage-1 nets, one epoch each at full width, on a set with landmark
    files on disk and images in memory."""
    import copy

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import fdgan_baseline, fdgan_train
    from reid_gan_torch.config import Config

    t_phase = time.perf_counter()
    ds, imgs = _fd_set(root, seed=5, n_ids=64, per_id=8, n_query=128, n_gallery=384)
    cache = _in_memory_images(imgs)
    cfg = Config()
    cfg.data.workers, cfg.data.batch_size = 4, batch
    cfg.optim.lr, cfg.optim.step_size = 0.01, 40
    cfg.train.epochs, cfg.train.eval_step = 1, 1
    cfg.train.logs_dir = os.path.join(root, "base")
    cfg.fdgan.niter, cfg.fdgan.niter_decay, cfg.fdgan.eval_step = 1, 0, 1
    cfg.gan.save_dir = os.path.join(root, "ckpt")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = fdgan_baseline.run(cfg, ds, "cuda", image_cache=cache)
    t_base = time.perf_counter() - t0
    c1 = copy.deepcopy(cfg)
    c1.fdgan.stage, c1.fdgan.pose_aug = 1, "gauss"
    c1.fdgan.netE_pretrain = os.path.join(root, "base", "model_best.pth.tar")
    c1.train.logs_dir, c1.gan.name = os.path.join(root, "s1"), "s1"
    t0 = time.perf_counter()
    fdgan_train.run(c1, ds, "cuda", image_cache=cache)
    t_s1 = time.perf_counter() - t0
    s1 = os.path.join(root, "ckpt", "s1")
    c2 = copy.deepcopy(cfg)
    c2.fdgan.stage, c2.fdgan.pose_aug = 2, "erase"
    c2.fdgan.netE_pretrain, c2.fdgan.netG_pretrain, c2.fdgan.netDi_pretrain, \
        c2.fdgan.netDp_pretrain = (os.path.join(s1, f"latest_net_{n}.pth")
                                   for n in ("E", "G", "Di", "Dp"))
    c2.train.logs_dir, c2.gan.name = os.path.join(root, "s2"), "s2"
    t0 = time.perf_counter()
    m2 = fdgan_train.run(c2, ds, "cuda", image_cache=cache)
    t_s2 = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    counts.update(launches)
    saved = sorted(os.listdir(os.path.join(root, "ckpt", "s2")))
    print(f"[fd_chain] baseline {t_base:.2f} s (best mAP {best:.4f}), stage II "
          f"{t_s1:.2f} s, stage III {t_s2:.2f} s; {len(ds.train)} train images of "
          f"{len(ds.pid_imgs)} ids, {len(ds.query)} + {len(ds.gallery)} eval; stage III "
          f"wrote {saved}")
    print(f"[fd_chain] launches: {kernels.phase_launch_counts()}")
    check(all(launches[k] > 0 for k in ("eval_transform", "rank_stats", "pose_peaks",
                                         "fd_augment")),
          f"K1, K3, K13 and K14 must launch in the chain: {launches}")
    check(np.isfinite(best) and {"best_net_E.pth", "latest_net_Dp.pth"} <= set(saved)
          and m2.stage == 2, "the chain did not write its checkpoints")
    print(f"[fd_chain] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _validate_path(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        f"torch_validate_{name}.py")


def _validate_script(name):
    """``scripts/torch_validate_<name>.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(f"torch_validate_{name}",
                                                  _validate_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _msmt_alone():
    """``torch_validate_msmt_scale.py`` in a process of its own, as the JAX
    script runs (its RSS bound is of a process that runs the phase alone,
    not of one that ran the smoke's phases before): its output, and its
    results from its last line, the phase's launches among them."""
    proc = subprocess.run([sys.executable, _validate_path("msmt_scale"), "--device", "cuda"],
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    print(proc.stderr[-4000:], end="", file=sys.stderr)
    check(proc.returncode == 0, f"the MSMT-scale check failed (exit {proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _msmt_kernel_times(report, bank_k):
    """K8's inner-product kNN (k 15, Infomap's graph) on the MSMT check's
    32,621 features and K6 against a bank of ``bank_k`` rows padded as the
    CLIs pad it (the DBSCAN cluster count of the check), each held against
    its plain version at the tolerances of ``check_k8`` and ``check_k6``,
    then timed; the times join K8's and K6's entries of the kernels line."""
    from reid_gan_torch.engine.usl import bank_rows
    from reid_gan_torch.ops.cluster_memory import memory_loss, memory_loss_plain
    from reid_gan_torch.ops.distance import knn_search_plain, knn_topk_cuda

    f = torch.from_numpy(_validate_script("msmt_scale").make_feats(32621)).cuda()
    n, dim = f.shape
    vals, idx = (t.cpu().numpy() for t in knn_topk_cuda(f, 15, "ip"))
    pv, pi = knn_search_plain(f, 15, "ip")
    err = float(np.abs(vals - pv).max())
    rows, gap = _swap_gap(f, idx, pv, pi, "ip")
    print(f"[validate] K8 ip N {n} D {dim} k 15: vals max_abs_err {err:.3g} (tol 2e-05); "
          f"{rows.size} swapped entries, largest plain-side gap {gap:.3g} (tol 2e-05)")
    check(err <= 2e-5 and gap <= 2e-5, "K8 ip at N 32,621 differs from plain")
    ms = device_ms(lambda: knn_topk_cuda(f, 15, "ip"), reps=3)
    b, by, _ = _k8_bound(n, dim, 15)
    print(f"[validate] K8 ip k 15 at N {n}: ms {ms:.4f} bound_ms {b:.4f} ({by}, 3xTF32)")
    report.setdefault("knn_topk", {}).update(n32621_ip_ms=ms, n32621_ip_bound_ms=b)
    del f

    k_pad = bank_rows(bank_k)
    state, y, x0, _ = _k6_inputs(k_pad, bank_k, 21)

    def run(fn):
        x = x0.detach().requires_grad_(True)
        loss, logits = fn(x, y, state)
        loss.mean().backward()
        return loss, logits, x.grad

    (loss, logits, dx), (loss_r, logits_r, dx_r) = run(memory_loss), run(memory_loss_plain)
    e = (float((logits[:, :bank_k] - logits_r[:, :bank_k]).abs().max()),
         float((loss - loss_r).abs().max()), float((dx - dx_r).abs().max()))
    print(f"[validate] K6 K_pad {k_pad} num_valid {bank_k}: max_abs_err logits {e[0]:.3g}, "
          f"loss {e[1]:.3g} (tol 0.0001), dx {e[2]:.3g} (tol 1e-06)")
    check(e[0] <= 1e-4 and e[1] <= 1e-4 and e[2] <= 1e-6,
          "K6 at the MSMT bank differs from plain")
    t = _time_k6(f"K_pad {k_pad} (the MSMT bank)", state, y, x0)
    report.setdefault("infonce", {}).update({f"msmt_bank_{k}": v for k, v in t.items()})


def phase_validate(counts, root, report):
    """``[validate]``: the port's four learning and scale checks, each
    script's ``main`` at its own sizes on the card, under ``root``: the USL
    and joint loops on the synthetic set, the Jaccard build at 12,936 rows
    and the ``--fp16`` USL loop on the hard set of 500 ids x 26, the
    clustering phase and the bank step at MSMT17's 32,621 rows. A failed
    check raises. Launch counts are zeroed before each script and read after
    (summed into ``counts``; the MSMT check's come from its own process,
    ``_msmt_alone``): K6 and K8 must launch, and K8 inside the MSMT phase's
    Infomap. This process's RSS is printed before the phase. Then K8 and K6
    at the MSMT check's shapes, held and timed (``_msmt_kernel_times``)."""
    import resource

    from reid_gan_torch import kernels

    t_phase = time.perf_counter()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    with open("/proc/self/statm") as f:
        now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
    print(f"[validate] the process's RSS before the phase: {now:.1f} GB, its peak "
          f"so far {rss0:.1f} GB")
    runs = (("synthetic_usl", lambda: _validate_script("synthetic_usl").main(
                os.path.join(root, "usl"))),
            ("synthetic_joint", lambda: _validate_script("synthetic_joint").main(
                os.path.join(root, "joint"))),
            ("hard_synthetic", lambda: _validate_script("hard_synthetic").main(
                os.path.join(root, "hard"))),
            ("msmt_scale", _msmt_alone))
    results = {}
    for name, run in runs:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = out.pop("launches", None) or kernels.launch_counts()
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        results[name] = out
        shown = {k: (round(v, 4) if isinstance(v, float) else
                     [round(x, 4) for x in v] if isinstance(v, list) else v)
                 for k, v in out.items()}
        print(f"[validate] {name} passed in {seconds:.1f} s: {json.dumps(shown)}")
        print(f"[validate] {name} launches: K6 {launches['infonce']}, "
              f"K8 {launches['knn_topk']}; all {launches}")
    check(counts["infonce"] > 0 and counts["knn_topk"] > 0,
          f"K6 and K8 must launch in [validate]: {counts}")
    check(results["msmt_scale"]["infomap_knn_launches"] > 0,
          "K8 did not launch in the MSMT phase's Infomap")
    _msmt_kernel_times(report, results["msmt_scale"]["bank_k"])
    print(f"[validate] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _cuhk03_tree(root, seed=7, n_ids=1467, n_test=100, h=256, w=128):
    """CUHK03 in the open-reid layout at its split sizes, written to ``root``:
    ``meta.json`` (1,467 ids, 9 or 10 images an id over two cameras, listed
    by bare names), ``splits.json`` (the first 1,367 ids trainval, the last
    100 both query and gallery, as CUHK03's splits list them) and an empty
    ``images/``; the pixels stay in memory (two colour blocks an id plus
    noise, staged at 256x128) for ``_in_memory_images``, so a name's last field
    is its image's index."""
    rng = np.random.default_rng(seed)
    pids = np.repeat(np.arange(n_ids), rng.integers(9, 11, n_ids))
    identities = [[[], []] for _ in range(n_ids)]
    for i, pid in enumerate(pids):
        cam = int(i % 2)
        identities[pid][cam].append(f"{pid:08d}_{cam:02d}_{i:06d}.jpg")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"name": "cuhk03", "shot": "multiple", "num_cameras": 2,
                   "identities": identities}, f)
    test = list(range(n_ids - n_test, n_ids))
    with open(os.path.join(root, "splits.json"), "w") as f:
        json.dump([{"trainval": list(range(n_ids - n_test)), "query": test,
                    "gallery": test}], f)
    return _two_colour_images(rng, pids, h, w)


def phase_cuhk03(counts, root, batch=256, anchors=256):
    """``cli/fdgan_baseline.run`` on ``CUHK03(root)`` at full width: a
    ResNet-50 Siamese net, one epoch of ``anchors`` train images' pairs (2
    batches of 256), then the cascade eval of the 100 test ids under the
    cuhk03 protocol (K1; K3 for each stage's mAP; the single-gallery-shot
    CMC on the host) and the checkpoint."""
    from reid_gan_torch import kernels
    from reid_gan_torch.cli import fdgan_baseline
    from reid_gan_torch.config import Config
    from reid_gan_torch.data.datasets import CUHK03
    from reid_gan_torch.engine import fdgan

    t_phase = time.perf_counter()
    imgs = _cuhk03_tree(root)
    ds = CUHK03(root)
    n_train = len(ds.train)
    ds.train = ds.train[:anchors]
    cfg = Config()
    cfg.data.dataset, cfg.data.workers, cfg.data.batch_size = "cuhk03", 4, batch
    cfg.optim.lr, cfg.optim.step_size = 0.01, 40
    cfg.train.epochs, cfg.train.eval_step = 1, 1
    cfg.train.logs_dir = os.path.join(root, "logs")
    print(f"[cuhk03] CUHK03 tree: {len(imgs)} images of 1467 ids, {ds.num_trainval_ids} "
          f"trainval ids ({ds.num_train_ids} train, {ds.num_val_ids} val), "
          f"{len(ds.query)} query = gallery images of 100 ids, made in "
          f"{time.perf_counter() - t_phase:.1f} s; depth cut: 1 epoch on {anchors} of "
          f"{n_train} train images (2 batches of {batch} pairs)")
    results, evaluate_all = [], fdgan.fd_evaluate_all

    def recorded(*args, **kwargs):
        results.append(evaluate_all(*args, **kwargs))
        return results[-1]

    fdgan.fd_evaluate_all = recorded
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = fdgan_baseline.run(cfg, ds, "cuda", image_cache=_in_memory_images(imgs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fdgan.fd_evaluate_all = evaluate_all
    launches = kernels.launch_counts()
    counts.update(launches)
    saved = sorted(os.listdir(cfg.train.logs_dir))
    print(f"[cuhk03] run(): {wall:.2f} s, best mAP {best:.4f}; (cuhk03 top-1, mAP) of "
          f"the first and the second stage: "
          + ", ".join(f"({t:.4f}, {m:.4f})" for t, m in results) + f"; wrote {saved}")
    print(f"[cuhk03] launches: {kernels.phase_launch_counts()}")
    check(launches["eval_transform"] > 0 and launches["rank_stats"] > 0
          and launches["fd_augment"] == 4,
          f"K1 and K3 must launch, K14 twice a step: {launches}")
    check(len(results) == 2 and np.all(np.isfinite(results))
          and "checkpoint.pth.tar" in saved, "no finite cuhk03 metrics or no checkpoint")
    print(f"[cuhk03] phase wall time {time.perf_counter() - t_phase:.1f} s")


# ``--kernels``: each kernel's checks, by its name in PERF.md
KERNEL_CHECKS = {
    "K1": (check_k1,), "K2": (check_k2,), "K3": (check_k3, check_k3_variants),
    "K4": (check_k4,), "K5": (check_k5,), "K6": (check_k6,), "K7": (check_k7,),
    "K8": (check_k8, check_k8_k_range), "K9": (check_k9,), "K10": (check_k10,),
    "K11": (check_k11,), "K12": (check_k12,), "K13": (check_k13,), "K14": (check_k14,),
}


# the --fp16 profiles' extra group, matched ahead of PROFILE_GROUPS: the
# casts to bf16 run as bfloat16_copy kernels, those to fp32 (and any layout
# copy) as direct_copy kernels
FP16_GROUPS = (("casts and copies (bfloat16_copy, direct_copy)",
                ("bfloat16_copy_kernel", "direct_copy_kernel")),)


def _snapshot_loads(module, into):
    """Wrap ``module.load_networks`` so each call's nets are copied (state
    dicts on the CPU) into ``into`` right after they load; returns the
    wrapped original, for the caller to put back."""
    real = module.load_networks

    def wrapped(nets, save_dir, which_epoch):
        out = real(nets, save_dir, which_epoch)
        into.append({name: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                     for name, net in nets.items()})
        return out

    module.load_networks = wrapped
    return real


def phase_msgpack(counts, root):
    """The JAX package's flax msgpack checkpoints on the card: a full-width
    ResNet-50 written in flax's layout by the port's writer and inverse
    converter, and a DSBN checkpoint whose d0 and d1 BatchNorm stats
    differ; ``cli/test.run`` with ``--resume``, ``--dsbn`` and ``--dsbn
    --test-source`` on ``[main]``'s eval set (K1-K3), each held against the
    model in memory: features bit-equal and CMC/mAP equal, the source domain
    equal to the model, the target apart; the host seconds to write and read
    the file. Then ``cli/train_gan_usl.run --continue-train`` from per-net
    ``latest_net_{G,D}.msgpack`` files (the pose G and D at 128x64) for 2
    joint steps on a small keypoint set, the loaded nets bit-equal to the
    nets written."""
    from types import SimpleNamespace

    from reid_gan_torch import kernels
    from reid_gan_torch.cli import test as test_cli
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.config import Config
    from reid_gan_torch.engine.evaluators import Evaluator, FeatureExtractor, extract_features
    from reid_gan_torch.models import create
    from reid_gan_torch.models.convert import flax_variables_from_model
    from reid_gan_torch.models.dsbn import convert_dsbn, update_domain
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.utils.serialization import load_msgpack_checkpoint, save_msgpack_checkpoint

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True   # as cli/test.py sets it
    batches, query, gallery = _eval_set()
    dataset = SimpleNamespace(query=query, gallery=gallery)
    cache = _in_memory_images(np.concatenate([b["img"] for b in batches]))
    torch.manual_seed(0)
    src = create("resnet50")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        src.gap.p.fill_(3.0)
        for name, b in src.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    tree = flax_variables_from_model(src)
    path = os.path.join(root, "model_best.msgpack")
    t0 = time.perf_counter()
    save_msgpack_checkpoint(dict(tree, epoch=np.asarray(7), best_mAP=np.asarray(0.25)),
                            False, path)
    write_s = time.perf_counter() - t0
    reads = []
    for _ in range(3):
        t0 = time.perf_counter()
        load_msgpack_checkpoint(path)
        reads.append(time.perf_counter() - t0)
    rng = np.random.default_rng(4)
    target = {"params": tree["params"], "batch_stats": _map_tree(
        lambda a: (a * (1 + 0.2 * rng.random(a.shape)) + 0.05).astype(np.float32),
        tree["batch_stats"])}
    dsbn_path = os.path.join(root, "dsbn.msgpack")
    save_msgpack_checkpoint({"dsbn": update_domain(convert_dsbn(tree), 1, target),
                             "epoch": np.asarray(7), "best_mAP": np.asarray(0.25)},
                            False, dsbn_path)
    print(f"[msgpack] ResNet-50 in flax's layout: {os.path.getsize(path) / 2**20:.1f} MiB "
          f"written in {write_s:.3f} s, read in "
          + ", ".join(f"{r:.4f}" for r in reads) + " s (host clock, warm page cache); "
          f"the DSBN file {os.path.getsize(dsbn_path) / 2**20:.1f} MiB")

    ref_ex = FeatureExtractor(src, height=256, width=128, batch_size=256, device="cuda")
    ref_cmc, ref_map = Evaluator(ref_ex).evaluate(batches, query, gallery, cmc_flag=True)
    ref_feats = extract_features(ref_ex, batches[:1])[0]
    cfg = Config()
    cfg.data.workers = 4
    kernels.reset_launch_counts()
    got, made, create_model = {}, [], test_cli.create_model

    def creating(*args, **kwargs):       # keep the model run() loads into
        made.append(create_model(*args, **kwargs))
        return made[-1]

    for name, extra, fpath in (("resume", {}, path),
                               ("dsbn target", dict(dsbn=True), dsbn_path),
                               ("dsbn source", dict(dsbn=True, test_source=True), dsbn_path)):
        cfg.train.resume = fpath
        test_cli.create_model = creating
        try:
            cmc, mAP = test_cli.run(cfg, dataset, device="cuda", image_cache=cache, **extra)
        finally:
            test_cli.create_model = create_model
        feats = extract_features(
            FeatureExtractor(made[-1], height=256, width=128, batch_size=256, device="cuda"),
            batches[:1])[0]
        same = all(np.array_equal(feats[f], ref_feats[f]) for f in ref_feats)
        got[name] = (cmc, mAP, same)
        print(f"[msgpack] cli/test.run {name}: mAP {mAP:.6f} top-1 {cmc[0]:.6f} (in memory "
              f"{ref_map:.6f}, {ref_cmc[0]:.6f}); batch 0 features bit-equal to the model "
              f"in memory: {same}")
    launches = kernels.launch_counts()
    print(f"[msgpack] cli/test.run launches: {kernels.phase_launch_counts()}")
    for name in ("resume", "dsbn source"):
        cmc, mAP, same = got[name]
        check(same and np.array_equal(cmc, ref_cmc) and mAP == ref_map,
              f"{name}: the loaded model evaluates otherwise than the model in memory")
    cmc, mAP, same = got["dsbn target"]
    check(not same and (mAP != ref_map or not np.array_equal(cmc, ref_cmc)),
          "the target domain's BatchNorm stats did not change the evaluation")

    # per-net G/D files of the JAX layout → --continue-train, 2 joint steps
    dataset, imgs = _usl_set(n_train=2048, ids=128, n_query=256, n_gallery=768, eval_ids=64)
    cfg = Config()
    cfg.data.workers = 4
    cfg.train.epochs, cfg.train.iters, cfg.train.eval_step = 1, 2, 1
    cfg.cluster.cluster_backend, cfg.cluster.eps = "infomap", 0.5
    cfg.cluster.k1, cfg.cluster.k2 = 15, 4
    cfg.gan.model, cfg.gan.model_gen, cfg.gan.continue_train = "AE", "Pose", True
    cfg.gan.save_dir = os.path.join(root, "ckpt")
    cfg.train.logs_dir = os.path.join(root, "logs")
    nets_dir = os.path.join(cfg.gan.save_dir, cfg.gan.name)
    torch.manual_seed(5)
    written = create_gan(cfg.gan, gan_height=128, gan_width=64, reid_feat_dim=2048,
                         device="cpu", seed=5)
    for name, net in (("G", written.net_G), ("D", written.net_D)):
        save_msgpack_checkpoint(flax_variables_from_model(net), False,
                                os.path.join(nets_dir, f"latest_net_{name}.msgpack"))
    dataset.train_pose_dir = _write_pose_csv(dataset.train, os.path.join(root, "poses.csv"), 14)
    loaded = []
    real = _snapshot_loads(train_gan_usl, loaded)
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        best = train_gan_usl.run(cfg, dataset, device="cuda",
                                 image_cache=_in_memory_images(imgs, imgs[:, ::2, ::2]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_gan_usl.load_networks = real
    run_launches = kernels.launch_counts()
    for k, v in launches.items():
        counts[k] = v + run_launches[k]
    equal = {name: all(torch.equal(net.state_dict()[k].cpu(), loaded[0][name][k])
                       for k in net.state_dict() if not k.endswith("num_batches_tracked"))
             for name, net in (("G", written.net_G), ("D", written.net_D))}
    print(f"[msgpack] cli/train_gan_usl.run --continue-train from latest_net_{{G,D}}.msgpack: "
          f"{wall:.2f} s, {cfg.train.iters} joint steps on {len(dataset.train)} images, best "
          f"mAP {best:.4f}; loaded nets bit-equal to the written ones: {equal}")
    print(f"[msgpack] run() launches: {kernels.phase_launch_counts()}")
    check(all(equal.values()), "the per-net msgpack files did not load bit-equal")
    check(np.isfinite(best) and run_launches["gan_feat_l2n"] == cfg.train.iters
          and run_launches["pose_maps"] == cfg.train.iters,
          f"the continued joint epoch did not run its steps: {run_launches}")
    print(f"[msgpack] phase wall time {time.perf_counter() - t_phase:.1f} s")


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _hold_bf16_kernels(label, batch, mode, trainer=None, state=None, gan=None):
    """The kernels of one ``--fp16`` step against their plain versions on
    the step's own tensors: K4 on the uint8 batch (and K9, K10 in the joint
    and warm-up steps, on the GAN images and keypoints); then the encoder's
    bf16 backbone runs once on K4's image, and the train head (K5), InfoNCE
    (K6, through its gradient into the map and GeM's p) and the fold (K7),
    and K11 on the map, take that one map on both sides. A whole bf16 step
    cannot be held so: wherever an input moves by an fp32 ulp a bf16
    rounding may flip, and 50 layers carry the flip to the output (``[fp16]
    USL`` measured 0.11 of the feature gradient and 0.028 of the bank
    between the kernels' and the plain step of one batch). ``mode``:
    "usl" or "train_all" (``trainer`` and its ``state``), or "warmup"
    (``gan``, the engine)."""
    import copy

    from reid_gan_torch.models.resnet import ResNetBackbone, gan_feat, gan_feat_plain
    from reid_gan_torch.ops.cluster_memory import (
        memory_loss,
        memory_loss_plain,
        update_memory,
        update_memory_plain,
    )
    from reid_gan_torch.ops.pose import batch_cords_to_map, batch_cords_to_map_plain
    from reid_gan_torch.ops.transforms import (
        gan_input_transform,
        gan_input_transform_plain,
        sample_augment_params,
        train_augment,
        train_augment_plain,
    )

    errs, tols = {}, {}
    if mode == "train_all":
        gan = trainer.gan
    if mode == "warmup":
        xs = torch.from_numpy(np.ascontiguousarray(batch["Xs"])).cuda()
        errs["K9"] = float((gan_input_transform(xs, gan.h, gan.w)
                            - gan_input_transform_plain(xs)).abs().max())
        tols["K9"] = 1e-6   # as [K9]
    else:
        if mode == "train_all":
            d = trainer._to_device(batch, "train_all")
        else:
            d = {"img": torch.from_numpy(np.ascontiguousarray(batch["img"])).cuda(),
                 "pid": torch.from_numpy(np.asarray(batch["pid"], np.int32)).cuda()}
        model, h, w = trainer.model, trainer.height, trainer.width
        params = sample_augment_params(d["img"].shape[0], h, w,
                                       torch.Generator(device="cuda").manual_seed(99))
        x = train_augment(d["img"], params, h, w)
        errs["K4"] = float((x - train_augment_plain(d["img"], params)).abs().max())
        tols["K4"] = 1e-5   # as [K4]
        if mode == "train_all":
            xs, gh, gw = d["Xs"], gan.h, gan.w
            errs["K9"] = float((gan_input_transform(xs, gh, gw)
                                - gan_input_transform_plain(xs)).abs().max())
            errs["K10"] = float((batch_cords_to_map(d["keypoints"], d["old_size"], gh, gw)
                                 - batch_cords_to_map_plain(d["keypoints"], d["old_size"],
                                                            gh, gw)).abs().max())
            tols["K9"], tols["K10"] = 1e-6, 1e-6   # as [K9], [K10]
        snap = copy.deepcopy(model.state_dict())
        model.train()
        with torch.no_grad():
            fmap = ResNetBackbone.forward(model, x)
        if mode == "train_all":
            errs["K11"] = float((gan_feat(fmap) - gan_feat_plain(fmap)).abs().max())
            tols["K11"] = 1e-6   # as [K11]
        y, out = d["pid"], []
        try:
            for plain in (False, True):
                model.load_state_dict(snap)
                fm = fmap.clone().requires_grad_()
                mem = state.memory._replace(features=state.memory.features.clone(),
                                            gan_features=state.memory.gan_features.clone())
                if plain:
                    with _plain_heads():
                        feat = model._train_head(fm)
                else:
                    feat = model._train_head(fm)
                loss = (memory_loss_plain if plain else memory_loss)(feat, y, mem)[0].mean()
                model.zero_grad(set_to_none=True)
                loss.backward()
                (update_memory_plain if plain else update_memory)(
                    mem, feat.detach(), y, use_hard=trainer.use_hard)
                out.append((float(loss.detach()), fm.grad, model.gap.p.grad.clone(),
                            mem.features))
        finally:
            model.load_state_dict(snap)
            model.zero_grad(set_to_none=True)
        (lk, gk, pk, bk), (lp, gp, pp, bp) = out
        errs["K5-K6 loss"] = abs(lk - lp) / abs(lp)
        errs["K5-K6 map grad"] = float((gk - gp).abs().max() / gp.abs().max())
        errs["K5 p grad"] = float((pk - pp).norm() / pp.norm())
        errs["K7 bank"] = float((bk - bp).abs().max())
        # [train]'s step tolerances (fp32 heads on one map: K5's lg2/ex2,
        # K6's 3xTF32, sums in other orders, temperature 0.05)
        tols.update({"K5-K6 loss": 1e-3, "K5-K6 map grad": 1e-3, "K5 p grad": 1e-3,
                     "K7 bank": 1e-4})
    print(f"[{label}] the step's kernels against their plain versions on its own tensors "
          "(max abs err; heads relative): "
          + ", ".join(f"{k} {errs[k]:.3g} (tol {tols[k]:.3g})" for k in errs))
    check(all(errs[k] <= tols[k] for k in errs),
          f"a kernel of the --fp16 step differs from its plain version: {errs}")


def phase_fp16(counts):
    """``--fp16`` at the recipe's width: bf16 compute as the JAX package's
    ``dtype=jnp.bfloat16`` (``models/precision.py``: bf16 convolutions and
    dense layers, fp32 norms, heads, parameters and optimiser state). One
    USL step (ResNet-50 at 256x128, batch 256), one joint ``train_all`` step
    (with the pose G and D at 128x64) and one warm-up step (the AE G and D
    at 128x64), each step's kernels held against their plain versions on
    its own tensors (``_hold_bf16_kernels``) and launching once a step; warm steps in bf16 and fp32 in
    turns on the same weights (the compute dtype switched between turns)
    with their peaks; the device-time split of the bf16 USL step; then one
    ``cli/train_usl.run --fp16`` epoch of 20 steps (``[fp16_usl]``) and the
    bf16 extraction rate (``[fp16_main]``)."""
    from reid_gan_torch import kernels
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.data import IterLoader
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.engine.gan_trainers import GANTrainer
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.engine.usl import bank_rows, make_train_loader
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.models import create_model as create_gan
    from reid_gan_torch.models.precision import set_compute_dtype
    from reid_gan_torch.ops.cluster_memory import init_memory

    bf16 = torch.bfloat16
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True   # the fp32 side as the CLIs run it

    def fp32_params(*nets):
        return all(q.dtype == torch.float32 and (q.grad is None or q.grad.dtype == torch.float32)
                   for net in nets for q in net.parameters())

    # ---- the USL step
    items, imgs = _pseudo_set()
    n_ids = 700
    g = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.nn.functional.normalize(
        torch.randn((n_ids, 2048), device="cuda", generator=g), dim=1)
    torch.manual_seed(0)
    model = create("resnet50", norm=True, dtype=bf16)
    trainer = ClusterContrastTrainer(model, height=256, width=128, num_instances=16,
                                     device="cuda")
    state = trainer.init_state(init_memory(centers, k_pad=bank_rows(n_ids), device="cuda"))
    loader = make_train_loader(items, 256, 128, 256, 16, workers=4, iters=400, seed=1,
                               cache=_in_memory_images(imgs))
    steps = 10
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = trainer.train(state, 0, loader, train_iters=steps, print_freq=steps,
                                base_seed=1)
    torch.cuda.synchronize()
    phases = kernels.phase_launch_counts()
    print(f"[fp16] USL: {steps} bf16 steps (1st, cuDNN cold): "
          f"{time.perf_counter() - t0:.2f} s, mean loss {loss:.4f}; launches {phases}")
    for name in ("train_augment.forward", "gem_pool.forward", "gem_pool.backward",
                 "infonce.forward", "infonce.backward", "bank_fold.forward"):
        check(phases[name] == steps, f"{name} launched {phases[name]} times, not once a step")
    check(np.isfinite(loss) and fp32_params(model), "bf16 USL steps: loss or dtypes")
    _hold_bf16_kernels("fp16 USL", loader.next(), "usl", trainer, state)

    def usl(side):
        set_compute_dtype(model, bf16 if side else None)
        trainer.train(state, 1, loader, train_iters=5, print_freq=5, base_seed=1)

    usl(False)                                # fp32's cuDNN algorithms, warm
    ms, peak = _turns("fp16 USL", usl, "step", 5, what="bf16 compute")
    print(f"[fp16] USL warm img/s (batch 256, ResNet-50 at 256x128): fp32 (TF32) "
          f"{256e3 / np.mean(ms[False]):.1f}, bf16 {256e3 / np.mean(ms[True]):.1f}; bf16 / "
          f"fp32 step time {np.mean(ms[True]) / np.mean(ms[False]):.4f}, peak "
          f"{peak[True] / peak[False]:.4f}")
    set_compute_dtype(model, bf16)
    profile_device("fp16 USL (3 warm bf16 steps)", lambda: trainer.train(
        state, 2, loader, train_iters=3, print_freq=3, base_seed=1), groups=FP16_GROUPS)
    set_compute_dtype(model, None)
    profile_device("fp16 USL (3 warm fp32 steps, the same call)", lambda: trainer.train(
        state, 3, loader, train_iters=3, print_freq=3, base_seed=1), groups=FP16_GROUPS)
    loader.close()
    del trainer, state, model, loader
    torch.cuda.empty_cache()

    # ---- the joint train_all step
    trainer, state, loader = _joint_trainer(dtype=bf16)
    nets = (trainer.model, trainer.gan.net_G, trainer.gan.net_D)
    _hold_bf16_kernels("fp16 joint", loader.next(), "train_all", trainer, state)
    kernels.reset_launch_counts()
    state, errs = trainer.run_epoch(state, 0, loader, mode="train_all", train_iters=steps,
                                    print_freq=steps, base_seed=1)
    phases = kernels.phase_launch_counts()
    print(f"[fp16] joint: {steps} bf16 train_all steps; mean "
          + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()) + f"; launches {phases}")
    for name in ("train_augment.forward", "gem_pool.forward", "infonce.forward",
                 "bank_fold.forward", "gan_input.forward", "pose_maps.forward",
                 "gan_feat_l2n.forward"):
        check(phases[name] == steps, f"{name} launched {phases[name]} times, not once a step")
    check(all(np.isfinite(v) for v in errs.values()) and fp32_params(*nets),
          f"bf16 joint steps: losses {errs} or dtypes")

    def joint(side):
        for net in nets:
            set_compute_dtype(net, bf16 if side else None)
        trainer.run_epoch(state, 1, loader, mode="train_all", train_iters=3, print_freq=3,
                          base_seed=1)

    joint(False)
    ms, peak = _turns("fp16 joint", joint, "step", 3, what="bf16 compute")
    print(f"[fp16] joint warm img/s (batch 256, ResNet-50 at 256x128 + pose G and D at "
          f"128x64): fp32 (TF32) {256e3 / np.mean(ms[False]):.1f}, bf16 "
          f"{256e3 / np.mean(ms[True]):.1f}; bf16 / fp32 step time "
          f"{np.mean(ms[True]) / np.mean(ms[False]):.4f}, peak {peak[True] / peak[False]:.4f}")
    loader.close()
    del trainer, state, loader, nets
    torch.cuda.empty_cache()

    # ---- the warm-up step
    torch.manual_seed(0)
    gan = create_gan(GANConfig(model="AE", model_gen="AE"), gan_height=128, gan_width=64,
                     device="cuda", dtype=bf16)
    pre = Preprocessor(items, mode="only_gan", gan_height=128, gan_width=64,
                       cache=_in_memory_images(imgs, imgs[:, ::2, ::2]))
    it = IterLoader(DataLoader(pre, batch_size=256, shuffle=True, num_workers=4,
                               drop_last=True, seed=1))
    it.new_epoch()
    _hold_bf16_kernels("fp16 warmup", it.next(), "warmup", gan=gan)
    gtrainer = GANTrainer(gan, print_freq=steps, device="cuda")
    gstate = gan.init_state()
    kernels.reset_launch_counts()
    gstate, errs = gtrainer.train_gan(gstate, 0, it, train_iters=steps, base_seed=1)
    launches = kernels.launch_counts()
    print(f"[fp16] warm-up: {steps} bf16 D->G iterations; mean "
          + ", ".join(f"{k} {v:.4f}" for k, v in errs.items()) + f"; launches {launches}")
    check(launches["gan_input"] == steps
          and all(v == 0 for k, v in launches.items() if k != "gan_input")
          and all(np.isfinite(v) for v in errs.values())
          and fp32_params(gan.net_G, gan.net_D), "bf16 warm-up iterations")

    def warmup(side):
        for net in (gan.net_G, gan.net_D):
            set_compute_dtype(net, bf16 if side else None)
        gtrainer.train_gan(gstate, 1, it, train_iters=5, base_seed=1)

    warmup(False)
    ms, peak = _turns("fp16 warmup", warmup, "iteration", 5, what="bf16 compute")
    print(f"[fp16] warm-up warm img/s (batch 256, AE G and D at 128x64): fp32 (TF32) "
          f"{256e3 / np.mean(ms[False]):.1f}, bf16 {256e3 / np.mean(ms[True]):.1f}; bf16 / "
          f"fp32 {np.mean(ms[True]) / np.mean(ms[False]):.4f}, peak "
          f"{peak[True] / peak[False]:.4f}")
    it.close()
    del gan, gtrainer, gstate, it
    torch.cuda.empty_cache()
    print(f"[fp16] steps phase wall time {time.perf_counter() - t_phase:.1f} s")

    phase_usl(counts, label="fp16_usl", fp16=True)
    torch.cuda.synchronize()
    rate = phase_main_path({}, label="fp16_main", dtype=bf16)
    print(f"[fp16_main] warm bf16 extraction: {rate:.1f} img/s")


def time_kernels(names, root):
    """``--kernels K4,K14 ROOT``: phases 1 and 2 for the named kernels only
    (their checks against the plain versions and their times), on the
    ``reid_gan_torch`` package under ROOT, built from its sources. ROOT may
    hold another commit (``git archive``), so that two commits run in turns
    on one card, each in its own process, and are timed alike through their
    public wrappers. Prints one JSON line of the kernels' entries; no result
    line."""
    unknown = [k for k in names if k not in KERNEL_CHECKS]
    check(names and not unknown, f"--kernels takes names among {', '.join(KERNEL_CHECKS)}; "
          f"got {','.join(names)}")
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import reid_gan_torch

    check(os.path.abspath(reid_gan_torch.__file__).startswith(root + os.sep),
          f"imported {reid_gan_torch.__file__}, not the package under {root}")
    phase_device()
    report = {}
    for name in names:
        for fn in KERNEL_CHECKS[name]:
            fn(report)
    print(json.dumps({"root": root, **report}))
    return 0


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs=2, metavar=("NAMES", "ROOT"),
                    help="only check and time the named kernels (e.g. K4,K14) of the "
                         "package under ROOT")
    ap.add_argument("--k5-k6", metavar="ROOT", help="the same as --kernels K5,K6 ROOT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if args.k5_k6:
        args.kernels = ("K5,K6", args.k5_k6)
    if args.kernels:
        return time_kernels(args.kernels[0].split(","), args.kernels[1])
    from reid_gan_torch import kernels

    t_start = time.perf_counter()
    phase_device()
    report = {}
    check_k1(report)
    check_k2(report)
    check_k3(report)
    check_k4(report)
    check_k5(report)
    check_k6(report)
    check_k7(report)
    check(report["bank_fold"]["joint_launches"] == 1,
          "K7 did not fold both banks in one launch")
    check_k8(report)
    check_k9(report)
    check_k10(report)
    check_k11(report)
    check_k12(report)
    check_k3_variants(report)
    check_k8_k_range(report)
    check_k13(report)
    check_k14(report)
    torch.cuda.synchronize()
    counts = {}
    r50_rate = phase_main_path(counts)
    torch.cuda.synchronize()
    phase_train(counts)
    torch.cuda.synchronize()
    phase_usl(counts)
    torch.cuda.synchronize()
    ibn_rate = phase_main_path({}, arch="resnet_ibn50a", label="ibn_main")
    print(f"[ibn_main] warm extraction, this call: resnet_ibn50a {ibn_rate:.1f} img/s "
          f"against resnet50 {r50_rate:.1f} img/s ({ibn_rate / r50_rate:.3f})")
    torch.cuda.synchronize()
    phase_train({}, arch="resnet_ibn50a", use_hard=True, label="ibn_train")
    torch.cuda.synchronize()
    ibn_counts = {}                     # the headline recipe's loop: its counts
    phase_usl(ibn_counts, arch="resnet_ibn50a", use_hard=True, label="ibn_usl")
    torch.cuda.synchronize()            # join the line's launches
    phase_variants()
    torch.cuda.synchronize()
    joint_ms = phase_joint(counts)
    torch.cuda.synchronize()
    phase_hardmix()
    torch.cuda.synchronize()
    phase_warmup()
    torch.cuda.synchronize()
    joint_counts, hardmix_counts = {}, {}
    phase_joint_run(joint_counts)       # the two whole joint loops: their
    torch.cuda.synchronize()            # counts, summed, are the line's launches
    phase_hardmix_run(hardmix_counts)
    torch.cuda.synchronize()
    gan_clusters_counts = {}
    phase_gan_clusters(gan_clusters_counts)
    torch.cuda.synchronize()
    vgg_joint_counts = {}
    phase_vgg_joint(vgg_joint_counts)
    torch.cuda.synchronize()
    bip_counts, memory_counts = {}, {}
    phase_mode_joint(bip_counts, "bip_joint", joint_ms)
    torch.cuda.synchronize()
    phase_mode_joint(memory_counts, "memory_joint", joint_ms)
    torch.cuda.synchronize()
    ddp_counts = {}
    phase_ddp(ddp_counts)
    torch.cuda.synchronize()
    phase_vgg_warmup()
    torch.cuda.synchronize()
    phase_dptn()
    torch.cuda.synchronize()
    phase_generators()
    torch.cuda.synchronize()
    import tempfile

    fp16_counts, msgpack_counts = {}, {}
    phase_fp16(fp16_counts)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        phase_msgpack(msgpack_counts, tmp)
    torch.cuda.synchronize()

    fd_counts, chain_counts, cuhk03_counts = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        fd_set = _fd_set(os.path.join(tmp, "set"))
        phase_fd_stage1(fd_counts, fd_set, tmp)
        torch.cuda.synchronize()
        phase_fd_gan(1, fd_set, tmp)
        torch.cuda.synchronize()
        phase_fd_gan(2, fd_set, tmp)
        torch.cuda.synchronize()
        phase_fd_chain(chain_counts, os.path.join(tmp, "chain"))
        torch.cuda.synchronize()
        phase_cuhk03(cuhk03_counts, os.path.join(tmp, "cuhk03"))
        torch.cuda.synchronize()
    validate_counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        phase_validate(validate_counts, tmp, report)
        torch.cuda.synchronize()
    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(c[k.name] for c in (joint_counts, hardmix_counts, chain_counts,
                                             ibn_counts, gan_clusters_counts,
                                             vgg_joint_counts, bip_counts,
                                             memory_counts, ddp_counts,
                                             cuhk03_counts, fp16_counts,
                                             msgpack_counts, validate_counts)),
         "library_ms": None, **report[k.name]}
        for k in kernels.KERNELS]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
