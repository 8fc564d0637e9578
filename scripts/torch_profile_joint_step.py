"""Decompose the joint ``train_all`` step of the PyTorch/CUDA port (the
port's copy of ``scripts/profile_joint_step.py``).

The step (``engine/gan_trainers.py::ClusterContrastWithGANTrainer.
train_all_step``) at batch 64: ResNet-50 at 256x128 and the AE engine's
pose generator and discriminator at 128x64, all computing in bf16 as the
JAX script's ``dtype=jnp.bfloat16`` (``models/precision.py``), against a
bank of K = 256 rows. This times the whole step with its FLOPs, then each
piece alone at the same shapes: the encoder forward, forward and backward,
the generator forward, forward and backward, D's loss forward and
backward, the G loss through D, the memory loss forward and backward
(kernel K6) and the train augmentation (kernel K4). Each line keeps the
JAX script's label; ``loss_G`` is the port's ``get_loss_G_train``.

FLOPs are torch's count (``utils/profiling.flops_of``: matmuls and
convolutions), not XLA's cost analysis.

    python scripts/torch_profile_joint_step.py [--device cpu]

The times are wall-clock ms a call after warm-up (``utils/profiling.
timeit``). The last line is the results as JSON.
"""

import json
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

BATCH, H, W, GH, GW, K = 64, 256, 128, 128, 64, 256


def main(device="cuda", batch=BATCH, height=H, width=W, gan_height=GH, gan_width=GW,
         k=K, iters=20, warmup=3):
    """The whole step and its pieces on ``device``; returns the step's ms,
    images a second, GFLOP and losses, and each piece's ms by its label."""
    import numpy as np
    import torch

    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.device import resolve_device
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models import create
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.ops.cluster_memory import init_memory, memory_loss
    from reid_gan_torch.ops.transforms import gan_input_transform
    from reid_gan_torch.utils.profiling import flops_of, timeit

    device = resolve_device(device)
    rng = np.random.RandomState(1)
    torch.manual_seed(0)
    encoder = create("resnet50", norm=True, dtype=torch.bfloat16)
    gan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=gan_height,
                  gan_width=gan_width, reid_feat_dim=2048, device=device,
                  dtype=torch.bfloat16)
    centers = rng.randn(k, 2048).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    trainer = ClusterContrastWithGANTrainer(encoder, gan, height=height, width=width,
                                            iters_per_epoch=400, num_instances=4,
                                            device=device)
    encoder = trainer.model                # on the device, channels_last
    state = trainer.init_state(init_memory(centers, device=device), gan.init_state())

    def dev(a, dtype=None):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    img = dev(rng.randint(0, 256, (batch, height, width, 3), dtype=np.uint8))
    pid = dev(np.repeat(rng.randint(0, k, batch // 4), 4), np.int32)
    xs_u8 = dev(rng.randint(0, 256, (batch, gan_height, gan_width, 3), dtype=np.uint8))
    kp = dev(rng.randint(0, 60, (batch, 18, 2)), np.float32)
    osz = torch.full((batch, 2), 64.0, device=device)
    batch_in = {"img": img, "pid": pid, "Xs": xs_u8, "keypoints": kp, "old_size": osz}
    conf = torch.ones(batch, device=device)

    # ---- the whole step
    losses = {}

    def step():
        _, out = trainer.train_all_step(state, batch_in, 3, conf)
        losses.update(out)
        return out["loss"]

    full = timeit(step, iters=iters, warmup=warmup)
    print(f"full train_all step: {full:8.2f} ms  ({batch / full * 1e3:,.0f} img/s)")
    gflop = flops_of(step)
    print(f"  torch FLOP count: {gflop:.1f} GFLOP/step -> "
          f"{gflop / full:.1f} TFLOP/s achieved")
    result = {"full_ms": full, "img_s": batch / full * 1e3, "gflop": gflop,
              "losses": {name: float(v) for name, v in losses.items()}, "ms": {}}

    def row(label, fn):
        result["ms"][label] = t = timeit(fn, iters=iters, warmup=warmup)
        print(f"{label + ':':20s} {t:8.2f} ms", flush=True)

    # ---- pieces, steady state
    enc_dtype = next(encoder.parameters()).dtype
    gan_dtype = next(gan.net_G.parameters()).dtype
    x = trainer.augment(img, 0).to(enc_dtype)
    xs = gan_input_transform(xs_u8, gan_height, gan_width).to(gan_dtype)
    enc_params = [p for p in encoder.parameters() if p.requires_grad]
    g_params = list(gan.net_G.parameters())
    d_params = list(gan.net_D.parameters())

    def enc_fwd():
        encoder.train()
        with torch.no_grad():
            return encoder(x, with_gan_feat=True)["feat"]

    row("encoder fwd (train)", enc_fwd)

    def enc_grad():
        encoder.train()
        out = encoder(x, with_gan_feat=True)
        loss = out["feat"].float().sum() + out["gan_feat"].float().sum()
        return torch.autograd.grad(loss, enc_params)

    row("encoder fwd+bwd", enc_grad)

    # the encoder's GAN map is 1/8 of the generator's image
    f_gan0 = torch.zeros((batch, 2048, gan_height // 8, gan_width // 8), dtype=gan_dtype,
                         device=device)
    ps = torch.zeros((batch, 18, gan_height, gan_width), dtype=gan_dtype, device=device)

    def g_fwd():
        with torch.no_grad():
            return gan.synthesize_p(f_gan0, ps)

    row("generator fwd", g_fwd)
    row("generator fwd+bwd", lambda: torch.autograd.grad(
        gan.synthesize_p(f_gan0, ps).float().sum(), g_params))
    fake0 = torch.zeros((batch, 3, gan_height, gan_width), dtype=gan_dtype, device=device)

    def d_grad():
        loss = gan.d_loss(xs, fake0)
        return loss, torch.autograd.grad(loss, d_params)

    row("D fwd+bwd", d_grad)
    fk = fake0.clone().requires_grad_(True)
    row("loss_G fwd+bwd(D)", lambda: torch.autograd.grad(gan.get_loss_G_train(fk, xs), fk))
    mem = init_memory(centers, device=device)
    f_out0 = torch.zeros((batch, 2048), device=device, requires_grad=True)
    row("memory loss f+b", lambda: torch.autograd.grad(
        memory_loss(f_out0, pid, mem, temp=0.05)[0].mean(), f_out0))
    row("reid_augment", lambda: trainer.augment(img, 1))
    return result


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(main(ap.parse_args().device)))
