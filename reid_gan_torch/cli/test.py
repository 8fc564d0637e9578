"""Eval-only CLI (port of ``reid_gan_tpu/cli/test.py``; parity:
CC/examples/test.py:57-89): load a checkpoint → mAP/CMC.

    python -m reid_gan_torch.cli.test --dataset market1501 --data-dir ./data \
        --resume-torch logs/model_best.pth.tar [--rerank] [--device cuda]

Runs on the card unless ``--device cpu`` is given. ``--resume-torch`` reads
``cli/train_usl``'s checkpoints. Not ported yet: ``--resume`` of a flax
msgpack checkpoint (ROADMAP A: msgpack checkpoints) and ``--dsbn`` (ROADMAP A: `--dsbn`).
"""

import argparse
import sys

import torch

from ..config import parse_config
from ..data.datasets import create as create_dataset
from ..data.loader import DataLoader, Preprocessor
from ..device import resolve_device
from ..engine.evaluators import Evaluator, FeatureExtractor
from ..models import create as create_model
from ..models.convert import normalize_reference_state_dict


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    # allow_abbrev=False: parse_known_args must not prefix-match flags meant
    # for the main config parser (e.g. --resume would bind to --resume-torch)
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--rerank", action="store_true")
    extra.add_argument("--resume-torch", default="",
                       help="reference-format torch .pth checkpoint "
                            "(CC save_checkpoint layout, or a state_dict of "
                            "this package's ReIDResNet)")
    extra.add_argument("--dsbn", action="store_true",
                       help="checkpoint carries domain-specific BNs (not "
                            "ported yet)")
    extra.add_argument("--test-source", action="store_true",
                       help="evaluate with the SOURCE domain BN stats "
                            "(with --dsbn)")
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=("data", "model", "cluster", "train"))
    device = resolve_device(ns.device)
    if ns.dsbn:
        raise NotImplementedError(
            "--dsbn is not ported yet: domain-specific BN checkpoints wait "
            "for models/dsbn.py (ROADMAP A: `--dsbn`)")
    if cfg.train.resume:
        raise NotImplementedError(
            "--resume (flax msgpack checkpoint) is not ported yet: it waits "
            "for utils/serialization.py (ROADMAP A: msgpack checkpoints); use "
            "--resume-torch")

    # Convolutions run in TF32 on the card (cudnn.allow_tf32 = True): the
    # input is already rounded to bf16, and the JAX package's convolutions
    # at default precision run on the TPU's bf16 matrix unit, so TF32 keeps
    # more precision than the reference path it replaces. The distance
    # product that orders the ranking stays full fp32
    # (ops/distance.py::squared_euclidean).
    torch.backends.cudnn.allow_tf32 = True

    dataset = create_dataset(cfg.data.dataset, cfg.data.data_dir, verbose=True)
    torch.manual_seed(0)
    model = create_model(cfg.model.arch, num_features=cfg.model.features,
                         norm=cfg.model.norm, pooling_type=cfg.model.pooling_type)
    if ns.resume_torch:
        load_torch_reference_checkpoint(ns.resume_torch, model)

    extractor = FeatureExtractor(model, height=cfg.data.height,
                                 width=cfg.data.width,
                                 batch_size=cfg.data.batch_size, device=device)
    pre = Preprocessor(list(dataset.query) + list(dataset.gallery), mode="reid",
                       height=cfg.data.height, width=cfg.data.width)
    loader = DataLoader(pre, batch_size=cfg.data.batch_size, drop_last=False,
                        num_workers=cfg.data.workers)
    return Evaluator(extractor).evaluate(loader, dataset.query, dataset.gallery,
                                         cmc_flag=True, rerank=ns.rerank)


def load_torch_reference_checkpoint(fpath, model):
    """Load a reference-format torch ``.pth`` into ``model`` in place.

    Mirrors ``load_checkpoint`` + ``copy_state_dict(strip='module.')``
    (CC/examples/test.py:69-77): unwrap the ``state_dict`` key of the CC
    checkpoint dict, strip ``module.``, translate the ``base.N`` sequential
    layout; the trainable GeM power ``gap.p`` is restored when present.
    """
    raw = torch.load(fpath, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    sd, gem_p = normalize_reference_state_dict(sd)
    if gem_p is not None:
        sd["gap.p"] = torch.as_tensor(gem_p, dtype=torch.float32).reshape(-1)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    skipped = list(unexpected) + [f"(missing) {k}" for k in missing]
    if skipped:
        print(f"=> resume-torch: skipped {len(skipped)} keys: "
              f"{skipped[:8]}{'...' if len(skipped) > 8 else ''}")
    print(f"=> Loaded reference torch checkpoint '{fpath}'")
    return model


if __name__ == "__main__":
    main()
