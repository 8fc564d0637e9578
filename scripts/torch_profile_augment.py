"""Micro-profile of the train augmentation of the PyTorch/CUDA port (the
port's copy of ``scripts/profile_augment.py``).

Times the whole train augmentation at batch 64 at the staging shape, as a
step runs it (the draws, then kernel K4, ``ops/transforms.py::
train_augment``), K4 alone, its plain version, and the plain version's
four stages one by one (JAX's ``random_hflip``, ``random_sized_rect_crop``,
``random_erasing``, ``normalize``), each with the same draws; then the JAX
script's candidate for the crop, a separable resampling as two batched
matmuls (``torch.einsum``, fp32 and bf16; a probe, not a kernel), and its
largest difference from the stage crop on the same rectangles.

    python scripts/torch_profile_augment.py [--device cpu]

The times are wall-clock ms a call after warm-up (``utils/profiling.
timeit``). The last line is the results as JSON.
"""

import json
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

N, H, W = 64, 256, 128


def crop_mat(starts, crops, in_dim, out_dim, dtype):
    """(N, out_dim, in_dim) bilinear resampling weights of the continuous
    rectangle [start, start + crop) onto ``out_dim`` samples, each row
    normalised (profile_augment.py:54-63)."""
    import torch

    o = torch.arange(out_dim, dtype=torch.float32, device=starts.device)
    src = starts[:, None] + (o[None, :] + 0.5) * (crops[:, None] / out_dim) - 0.5
    i = torch.arange(in_dim, dtype=torch.float32, device=starts.device)
    d = torch.abs(src[:, :, None] - i[None, None, :])
    wmat = torch.clamp(1.0 - d, 0.0, 1.0)
    wmat = wmat / torch.clamp_min(wmat.sum(-1, keepdim=True), 1e-8)
    return wmat.to(dtype)


def crop_mm2(x, params, out_h, out_w, dtype):
    """The crop of an NHWC batch as two batched matmuls over the rectangles
    of ``params`` (profile_augment.py:65-79, the draws given)."""
    import torch

    from reid_gan_torch.ops.transforms import CROP_H, CROP_LEFT, CROP_TOP, CROP_W

    _, h, w, _ = x.shape
    wy = crop_mat(params[:, CROP_TOP], params[:, CROP_H], h, out_h, dtype)
    wx = crop_mat(params[:, CROP_LEFT], params[:, CROP_W], w, out_w, dtype)
    xb = x.to(dtype)
    y = torch.einsum("noh,nhwc->nowc", wy, xb)             # rows
    return torch.einsum("npw,nowc->nopc", wx, y)           # cols


def main(device="cuda", n=N, height=H, width=W, iters=50, warmup=5):
    """The table at batch ``n`` and (height, width) on ``device``; returns
    its rows (label → ms) and the candidate's largest difference."""
    import numpy as np
    import torch

    from reid_gan_torch.device import resolve_device
    from reid_gan_torch.ops import transforms as T
    from reid_gan_torch.utils.profiling import timeit

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 256, (n, height, width, 3), dtype=np.uint8)).to(device)
    x = T.to_float(img)
    gen = torch.Generator(device=device)

    def draws(seed=0):
        gen.manual_seed(seed)
        return T.sample_augment_params(n, height, width, gen)

    params = draws()
    rows = {}

    def row(label, fn, *args):
        rows[label] = timeit(fn, *args, iters=iters, warmup=warmup)
        print(f"{label + ':':34s} {rows[label]:7.2f} ms", flush=True)

    row("full reid_augment (draws + K4)",
        lambda: T.train_augment(img, draws(), height, width))
    row("K4 alone (draws given)", lambda: T.train_augment(img, params, height, width))
    row("plain version (draws given)", lambda: T.train_augment_plain(img, params))
    row("random_hflip", T.random_hflip, x, params)
    row("random_sized_rect_crop", T.random_sized_rect_crop, x, params, height, width)
    row("random_erasing", T.random_erasing, x, params)
    row("normalize", lambda: T.normalize(x, dim=-1))
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        row(f"crop as batched matmul {name}", crop_mm2, x, params, height, width, dt)

    # the candidate against the stage crop on the same rectangles
    a = crop_mm2(x, params, height, width, torch.float32)
    b = T.random_sized_rect_crop(x, params, height, width)
    delta = float((a - b).abs().max())
    print("max |mm - s&t|:", delta)
    return {"ms": rows, "max_abs_mm_vs_crop": delta}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(main(ap.parse_args().device)))
