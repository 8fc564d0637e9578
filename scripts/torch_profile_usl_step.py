"""Decompose the USL train step of the PyTorch/CUDA port (the port's copy of
``scripts/profile_usl_step.py``).

The step (``engine/trainers.py::ClusterContrastTrainer.step``): the train
augmentation (kernel K4) → ResNet-50 forward and backward, computing in
bf16 as JAX's ``dtype=jnp.bfloat16`` (``models/precision.py``; GeM kernel
K5) → InfoNCE against a bank of K = 1,024 rows (kernel K6) → Adam with
coupled weight decay → the ``use_hard`` bank fold (kernel K7), at batch 256
and 256x128. This times each piece alone at the same shapes, with its
FLOPs, then the whole step, so that the step's time has owners.

FLOPs are torch's count (``utils/profiling.flops_of``: matmuls and
convolutions), not XLA's cost analysis: about 5% under it for ResNet-50's
forward and backward, equal within 1% for the eval forward.

    python scripts/torch_profile_usl_step.py [--device cpu]

The times are wall-clock ms a call after warm-up (``utils/profiling.
timeit``). The last line is the results as JSON.
"""

import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

BATCH, H, W, K, D = 256, 256, 128, 1024, 2048
INSTANCES = 16            # the P×K batch's instances an id (the hard fold's group)


def print_table(rows, full_ms, full_gf, batch):
    """The JAX script's table: each piece's ms, GFLOP and TFLOP/s, then the
    whole step's and its images a second."""
    print(f"{'piece':45s} {'ms':>8s} {'GFLOP':>9s} {'TFLOP/s':>9s}")
    for name, ms, gf in rows:
        tf = gf / ms if ms > 0 else 0.0
        print(f"{name:45s} {ms:8.2f} {gf:9.1f} {tf:9.1f}")
    print(f"{'FULL fused step (aug+fwd/bwd+Adam+fold)':45s} {full_ms:8.2f} "
          f"{full_gf:9.1f} {full_gf / full_ms:9.1f}")
    print(f"imgs/s: {batch / full_ms * 1e3:.0f}")


def main(device="cuda", batch=BATCH, height=H, width=W, k=K, dim=D,
         instances=INSTANCES, iters=30, warmup=3, steps=30):
    """The pieces and the whole step on ``device``; returns the rows
    (label, ms, GFLOP), the step's ms, GFLOP and images a second, and its
    last loss."""
    import numpy as np
    import torch

    from reid_gan_torch.device import resolve_device
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models import create
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss, update_memory
    from reid_gan_torch.utils.profiling import flops_of, timeit

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    model = create("resnet50", norm=True, dtype=torch.bfloat16)
    trainer = ClusterContrastTrainer(model, height=height, width=width, use_hard=True,
                                     iters_per_epoch=400, num_instances=instances,
                                     device=device)
    model = trainer.model                  # on the device, channels_last
    centers = rng.randn(k, dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    memory = init_memory(centers, device=device)
    img = torch.from_numpy(rng.randint(0, 256, (batch, height, width, 3),
                                       dtype=np.uint8)).to(device)
    targets = torch.from_numpy(np.repeat(
        rng.choice(k, batch // instances, replace=False), instances).astype(np.int32)).to(device)
    params = [p for p in model.parameters() if p.requires_grad]

    # -- pieces ------------------------------------------------------------
    def aug():
        return trainer.augment(img, 0)

    x = aug()

    def fwd_eval():
        model.eval()
        with torch.no_grad():
            return model(x)

    def fwd_train():
        model.train()
        with torch.no_grad():
            return model(x, with_gan_feat=False)["feat"]

    def fwd_bwd():
        model.train()
        losses, _ = memory_loss(model(x, with_gan_feat=False)["feat"], targets, memory)
        loss = losses.mean()
        return loss, torch.autograd.grad(loss, params)

    feats = fwd_train()

    def bank_fold():
        return update_memory(memory, feats, targets, momentum=0.2, use_hard=True,
                             group_size=instances)

    pieces = (("aug (resize+crop+flip+erase+norm)", aug),
              ("encoder fwd eval-mode", fwd_eval),
              ("encoder fwd train-mode (BN stats)", fwd_train),
              ("fwd+bwd incl. InfoNCE", fwd_bwd),
              (f"bank fold (K={k}, use_hard)", bank_fold))
    rows = [(name, timeit(fn, iters=iters, warmup=warmup), flops_of(fn))
            for name, fn in pieces]

    # the whole step last: it trains the model the pieces ran
    state = trainer.init_state(init_memory(centers, device=device))
    state, loss = trainer.step(state, img, targets, 0)
    loss.item()
    t0 = time.perf_counter()
    for i in range(steps):
        state, loss = trainer.step(state, img, targets, i)
    last_loss = loss.item()
    full_ms = (time.perf_counter() - t0) / steps * 1e3
    full_gf = flops_of(lambda: trainer.step(state, img, targets, 0))
    print_table(rows, full_ms, full_gf, batch)
    return {"rows": rows, "full_ms": full_ms, "full_gflop": full_gf,
            "img_s": batch / full_ms * 1e3, "loss": last_loss}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(main(ap.parse_args().device)))
