"""Eval-only CLI (port of ``reid_gan_tpu/cli/test.py``; parity:
CC/examples/test.py:57-89): load a checkpoint → mAP/CMC.

    python -m reid_gan_torch.cli.test --dataset market1501 --data-dir ./data \
        --resume-torch logs/model_best.pth.tar [--rerank] [--device cuda]
    python -m reid_gan_torch.cli.test ... --resume logs/model_best.msgpack \
        [--dsbn [--test-source]]

Runs on the card unless ``--device cpu`` is given. ``--resume-torch`` reads
``cli/train_usl``'s checkpoints (or a CC reference checkpoint);
``--resume`` reads a whole checkpoint strictly: the port's ``.pth.tar`` or
the JAX package's flax ``.msgpack`` (test.py:62-67). With ``--dsbn`` the
msgpack checkpoint holds domain-specific BatchNorms (``{"dsbn": {"domains":
{"d0", "d1"}}}``) and the eval runs with the target domain's, or with
``--test-source`` the source domain's (test.py:48-61;
CC/examples/test.py:71-81).

Several cards (test.py:71-80): with more than one card visible and no
``--device cpu``, ``main`` runs one process a card over all of them; each
rank extracts its slice of each batch and ranks its share of the query
chunks (``engine/evaluators.py``), and only rank 0 prints. ``main(argv,
mesh=False)`` keeps one card. With ``--dsbn`` every rank loads the
checkpoint and folds the chosen domain's BatchNorms before the sharded
eval.
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
from ..models.dsbn import convert_bn
from ..parallel.mesh import (
    is_main,
    launch,
    local_device_count,
    main_first,
    main_prints,
    mesh_device,
    replicate,
    wants_mesh,
)
from ..utils.serialization import load_flax_state, load_msgpack_checkpoint, resume_checkpoint


def main(argv=None, mesh=None):
    """Parse the flags, load the dataset and evaluate. Returns (CMC, mAP).
    ``mesh``: None spans every card when more than one is visible, False
    keeps one, a ``Mesh`` is this rank's."""
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
                       help="checkpoint carries domain-specific BNs "
                            "(UDA; reference CC/examples/test.py:71-81)")
    extra.add_argument("--test-source", action="store_true",
                       help="evaluate with the SOURCE domain BN stats "
                            "(with --dsbn)")
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=("data", "model", "cluster", "train"))
    device = resolve_device(ns.device)
    if ns.dsbn and not cfg.train.resume.endswith(".msgpack"):
        raise ValueError("--dsbn reads a domain-specific BN checkpoint of the "
                         "JAX package: give it with --resume <file>.msgpack")
    if wants_mesh(device, mesh):
        return launch(_main_on_rank, local_device_count(), args=(argv,))
    mesh = mesh or None
    with main_prints(mesh):
        dataset = main_first(mesh, lambda: create_dataset(
            cfg.data.dataset, cfg.data.data_dir, verbose=is_main(mesh)))
    return run(cfg, dataset, None if mesh else device, resume_torch=ns.resume_torch,
               dsbn=ns.dsbn, test_source=ns.test_source, rerank=ns.rerank, mesh=mesh)


def _main_on_rank(mesh, argv):
    return main(argv, mesh=mesh)


def run(cfg, dataset, device=None, image_cache=None, resume_torch="", dsbn=False,
        test_source=False, rerank=False, mesh=None):
    """The evaluation (test.py:62-88) of ``cfg.model.arch`` on ``dataset``
    (``.query`` and ``.gallery`` lists of ``(fname, pid, camid)``), on
    ``device`` (default: the card), with the weights of ``cfg.train.resume``
    (with ``dsbn``, the target or with ``test_source`` the source domain's),
    or of ``resume_torch``. ``image_cache`` goes to the ``Preprocessor``
    (default: the shared decode cache). With ``mesh`` (a ready ``Mesh``, on
    every rank) the eval is sharded over it and only rank 0 prints. Returns
    (CMC, mAP)."""
    with main_prints(mesh):
        return _run(cfg, dataset, mesh_device(mesh, device), image_cache, resume_torch,
                    dsbn, test_source, rerank, mesh)


def _run(cfg, dataset, device, image_cache, resume_torch, dsbn, test_source, rerank,
         mesh):
    # Convolutions run in TF32 on the card (cudnn.allow_tf32 = True): the
    # input is already rounded to bf16, and the JAX package's convolutions
    # at default precision run on the TPU's bf16 matrix unit, so TF32 keeps
    # more precision than the reference path it replaces. The distance
    # product that orders the ranking stays full fp32
    # (ops/distance.py::squared_euclidean).
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(0)
    model = create_model(cfg.model.arch, num_features=cfg.model.features,
                         norm=cfg.model.norm, pooling_type=cfg.model.pooling_type)
    if cfg.train.resume and dsbn:
        print("==> Load the model with domain-specific BNs")
        ckpt = load_msgpack_checkpoint(cfg.train.resume)
        print("==> Test with {}-domain BNs".format("source" if test_source else "target"))
        load_flax_state(model, convert_bn(ckpt["dsbn"], use_target=not test_source),
                        f"'{cfg.train.resume}'")
    elif cfg.train.resume:
        resume_checkpoint(cfg.train.resume, model)
    elif resume_torch:
        load_torch_reference_checkpoint(resume_torch, model)

    extractor = FeatureExtractor(model, height=cfg.data.height,
                                 width=cfg.data.width,
                                 batch_size=cfg.data.batch_size, device=device,
                                 mesh=mesh)
    replicate(mesh, model)           # rank 0's weights, on the rank's card
    pre = Preprocessor(list(dataset.query) + list(dataset.gallery), mode="reid",
                       height=cfg.data.height, width=cfg.data.width,
                       cache="default" if image_cache is None else image_cache)
    loader = DataLoader(pre, batch_size=cfg.data.batch_size, drop_last=False,
                        num_workers=cfg.data.workers, shard=mesh)
    return Evaluator(extractor).evaluate(loader, dataset.query, dataset.gallery,
                                         cmc_flag=True, rerank=rerank)


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
