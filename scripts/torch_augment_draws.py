"""Times K14 (``fd_augment``) and K4 (``train_augment``) of the
``reid_gan_torch`` package under ROOT on the card, with their draws as
sampled and with one draw forced for every image: K14 at 512 x 256x128 with
no flip, every image flipped and no erase; K4 at 256 x 256x128 with no flip,
no erase and every image erased. It shows what each branch of a kernel
costs. Device time from CUDA events (``chip_smoke.device_ms``, 20 calls);
no check against the plain versions (``chip_smoke.py --kernels`` makes
those). Run from the repository root on a machine with the card:

    python scripts/torch_augment_draws.py ROOT
"""

import os
import sys

import torch


def main(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from reid_gan_torch.ops import transforms as T

    if not os.path.abspath(T.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {T.__file__}, not the package under {root}")

    def forced(params, col, value):
        p = params.clone()
        p[:, col] = value
        return p

    g = torch.Generator(device="cuda").manual_seed(14)
    u8 = torch.randint(0, 256, (512, 256, 128, 3), dtype=torch.uint8, device="cuda", generator=g)
    fd = T.sample_fd_augment_params(512, 256, 128, g)
    times = {}
    for name, p in [("drawn", fd), ("no_flip", forced(fd, T.FD_FLIP, 0.0)),
                    ("all_flip", forced(fd, T.FD_FLIP, 1.0)),
                    ("no_erase", forced(fd, T.FD_ERASE, 0.0))]:
        times[f"K14 {name}"] = chip_smoke.device_ms(lambda p=p: T.fd_augment(u8, p), reps=20)
    u4 = u8[:256].contiguous()
    tr = T.sample_augment_params(256, 256, 128, g)
    for name, p in [("drawn", tr), ("no_flip", forced(tr, T.FLIP, 0.0)),
                    ("no_erase", forced(tr, T.ERASE, 0.0)),
                    ("all_erase", forced(tr, T.ERASE, 1.0))]:
        times[f"K4 {name}"] = chip_smoke.device_ms(
            lambda p=p: T.train_augment(u4, p, 256, 128), reps=20)
    print(root, " ".join(f"{k}={v:.4f}" for k, v in times.items()))


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit("usage: python scripts/torch_augment_draws.py ROOT (needs a CUDA card)")
    main(sys.argv[1])
