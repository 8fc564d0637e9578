"""Rank functions for the port's data-mesh tests, and ``spawn``, which runs
one of them on a gloo mesh of CPU processes.

Each rank is a spawned process that imports this module by name, so nothing
here imports JAX or the JAX package: the tests compute the JAX side in their
own process and pass numpy arrays in. Every group rendezvouses through a
``file://`` store under the test's ``tmp_path`` (parallel test workers never
race for a port), has a timeout, and each rank runs one intra-op thread."""

import datetime
import itertools
import os
import os.path as osp

import torch

_STORES = itertools.count()
TIMEOUT = datetime.timedelta(seconds=120)


def spawn(fn, world, tmp_path, *args, timeout=TIMEOUT):
    """``fn(mesh, *args)`` on ``world`` gloo ranks; rank 0's result."""
    from reid_gan_torch.parallel import launch

    store = osp.join(str(tmp_path), f"store{os.getpid()}_{next(_STORES)}")
    return launch(fn, world, args=args, device_type="cpu",
                  init_method=f"file://{store}", threads=1, timeout=timeout)


def gathers_and_reductions(mesh, batch, n):
    """``shard_batch``, ``pad_to_multiple`` and ``all_gather_rows`` round
    trips of ``batch`` (rows beyond ``n`` are padding), and the other
    collectives on rank-dependent values."""
    from reid_gan_torch.parallel import mesh as M

    padded, n0 = M.pad_to_multiple(batch[:n], mesh.world_size)
    local = M.shard_batch(mesh, torch.from_numpy(padded))
    rows = M.all_gather_rows(mesh, local, n0).numpy()
    r = mesh.rank
    grads = [torch.nn.Parameter(torch.zeros(3, dtype=torch.float64)),
             torch.nn.Parameter(torch.zeros(2, 2)), torch.nn.Parameter(torch.zeros(1))]
    grads[0].grad = torch.full((3,), float(r), dtype=torch.float64)
    grads[1].grad = torch.arange(4.0).reshape(2, 2) * (r + 1)
    M.all_reduce_grads(mesh, grads)
    net = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        net.weight.fill_(r + 1.0)
        net.running_mean.fill_(-r)
    M.replicate(mesh, net)
    tree = {"a": torch.full((2,), r + 0.5), "b": [torch.tensor(r)]}
    M.replicate(mesh, tree)
    return {"rows": rows, "n": n0, "g0": grads[0].grad.numpy(),
            "g1": grads[1].grad.numpy(), "g2": grads[2].grad,
            "mean": float(M.all_reduce_mean(mesh, torch.tensor(float(r)))),
            "sum": int(M.all_reduce_sum(mesh, torch.tensor(r + 1))),
            "obj": M.broadcast_object(mesh, {"rank": r}),
            "bn": (net.weight.detach().numpy(), net.running_mean.numpy()),
            "tree": (tree["a"].numpy(), int(tree["b"][0]))}


def fails_on_rank_1(mesh, exc=ValueError):
    """Rank 1 raises ``exc``; the others wait on it in a barrier."""
    if mesh.rank == 1:
        raise exc("rank 1 fails")
    mesh.barrier()


def global_bn(mesh, x, dy, weight, bias, rm, rv):
    """A ``GlobalBatchNorm`` (converted from ``nn.BatchNorm{1,2}d``) in
    train mode on the rank's rows of ``x``, backward from the rank's rows of
    ``dy``: the gathered output and input gradient, the parameter gradients
    summed over the ranks (the gradient of the global Σ y·dy) and the
    running stats."""
    from reid_gan_torch.ops.norm import GlobalBatchNorm, convert_global_bn
    from reid_gan_torch.parallel import all_gather_rows, all_reduce_sum, shard_batch

    bn = (torch.nn.BatchNorm2d if x.ndim == 4 else torch.nn.BatchNorm1d)(x.shape[1])
    bn = convert_global_bn(bn.double(), mesh)
    assert isinstance(bn, GlobalBatchNorm)
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias), (bn.running_mean, rm),
                     (bn.running_var, rv)):
            t.copy_(torch.from_numpy(v))
    xl = shard_batch(mesh, torch.from_numpy(x)).clone().requires_grad_(True)
    y = bn(xl)
    (y * shard_batch(mesh, torch.from_numpy(dy))).sum().backward()
    return {"y": all_gather_rows(mesh, y.detach()).numpy(),
            "dx": all_gather_rows(mesh, xl.grad).numpy(),
            "dw": all_reduce_sum(mesh, bn.weight.grad).numpy(),
            "db": all_reduce_sum(mesh, bn.bias.grad).numpy(),
            "rm": bn.running_mean.numpy(), "rv": bn.running_var.numpy()}


def _resnet18(state_dict):
    from reid_gan_torch.models.resnet import ReIDResNet

    model = ReIDResNet(depth=18, norm=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return model


def usl_step(mesh, state_dict, bank, img, pid, seed, height, width, num_instances,
             k_pad):
    """One ``ClusterContrastTrainer`` step in fp64 on the rank's rows of the
    uint8 batch ``img`` (the whole batch's labels ``pid``), from
    ``state_dict``'s weights and the bank ``bank``. Returns rank 0's loss,
    state dict, bank and Adam moments (by parameter name)."""
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.parallel import shard_batch

    model = _resnet18(state_dict).double()
    trainer = ClusterContrastTrainer(model, height=height, width=width,
                                     num_instances=num_instances, device="cpu",
                                     mesh=mesh)
    state = trainer.init_state(init_memory(bank, k_pad=k_pad, device="cpu"))
    local = img if mesh is None else shard_batch(mesh, img)
    state, loss = trainer.step(state, torch.from_numpy(local), torch.from_numpy(pid),
                               seed)
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {names[id(p)]: (s["exp_avg"].numpy(), s["exp_avg_sq"].numpy())
               for p, s in state.optimizer.state.items()}
    return {"loss": float(loss),
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "bank": state.memory.features.numpy(), "moments": moments}


def sharded_eval(mesh, state_dict, query, gallery, height, width, batch_size):
    """The features (fname → row) and the (CMC, mAP) of a sharded
    ``Evaluator.evaluate`` of query + gallery from ``state_dict``'s
    weights."""
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.engine.evaluators import (
        Evaluator,
        FeatureExtractor,
        extract_features,
    )

    extractor = FeatureExtractor(_resnet18(state_dict), height=height, width=width,
                                 batch_size=batch_size, device="cpu", mesh=mesh)
    pre = Preprocessor(list(query) + list(gallery), mode="reid", height=height,
                       width=width, cache=None)
    loader = DataLoader(pre, batch_size=batch_size, drop_last=False, num_workers=1,
                        shard=mesh)
    features = extract_features(extractor, loader)[0]
    scores, mAP = Evaluator(extractor).evaluate(loader, query, gallery, cmc_flag=True)
    return {"features": dict(features), "cmc": scores, "mAP": mAP}


def _record_writes(module, rank, out_dir, names):
    """Wrap ``module``'s functions ``names`` so each call leaves a file
    ``<out_dir>/<name>.rank<r>``."""
    def wrap(name, fn):
        def inner(*a, **kw):
            open(osp.join(out_dir, f"{name}.rank{rank}"), "a").close()
            return fn(*a, **kw)
        return inner

    for name in names:
        setattr(module, name, wrap(name, getattr(module, name)))


def cli_main(mesh, cli, argv, out_dir):
    """``reid_gan_torch.cli.<cli>.main(argv, mesh=mesh)`` with its writers
    (the log, the options file, the checkpoints and the GAN nets) recording
    which ranks call them under ``out_dir``."""
    import importlib

    mod = importlib.import_module(f"reid_gan_torch.cli.{cli}")
    writers = [n for n in ("Logger", "dump_config", "save_checkpoint", "save_networks",
                           "Visualizer") if hasattr(mod, n)]
    _record_writes(mod, mesh.rank, out_dir, writers)
    return mod.main(argv, mesh=mesh)


def joint_step(mesh, enc_state, gan_states, bank, gan_bank, batch, conf, seed,
               sizes, group):
    """One ``train_all`` step in fp64 of the port's joint trainer (resnet18,
    the pose G and D of ``gan_states``) on the rank's rows of ``batch`` (the
    whole batch's ``pid`` and ``conf``). Returns rank 0's losses, the three
    nets' state dicts and both banks."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.parallel import shard_batch

    h, w, gh, gw = sizes
    model = _resnet18(enc_state).double()
    gan = AEModel(GANConfig(model="AE", model_gen="Pose"), gan_height=gh, gan_width=gw,
                  num_feats=32, ngf=8, reid_feat_dim=bank.shape[1], device="cpu")
    for net, sd in ((gan.net_G, gan_states["G"]), (gan.net_D, gan_states["D"])):
        net.double().load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    trainer = ClusterContrastWithGANTrainer(model, gan, height=h, width=w,
                                            num_instances=group, device="cpu",
                                            mesh=mesh)
    state = trainer.init_state(init_memory(bank, k_pad=256, gan_centroids=gan_bank,
                                           device="cpu"), gan.init_state())
    dev = {k: torch.from_numpy(v if k == "pid" or mesh is None
                               else shard_batch(mesh, v)) for k, v in batch.items()}
    state, errs = trainer.train_all_step(state, dev, seed, torch.from_numpy(conf))
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}  # noqa: E731
    return {"errs": {k: float(v) for k, v in errs.items()}, "enc": sd(model),
            "G": sd(gan.net_G), "D": sd(gan.net_D),
            "bank": state.memory.features.numpy(),
            "gan_bank": state.memory.gan_features.numpy()}
