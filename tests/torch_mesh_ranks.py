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


def each(mesh, fn, calls):
    """``fn(mesh, *args)`` for each ``args`` of ``calls`` in turn, so that
    several cases share one spawn; their results in order."""
    return [fn(mesh, *args) for args in calls]


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
    ``<out_dir>/<name>.rank<r>``. Returns a function that unwraps them."""
    def wrap(name, fn):
        def inner(*a, **kw):
            open(osp.join(out_dir, f"{name}.rank{rank}"), "a").close()
            return fn(*a, **kw)
        return inner

    real = {name: getattr(module, name) for name in names}
    for name, fn in real.items():
        setattr(module, name, wrap(name, fn))

    def restore():
        for name, fn in real.items():
            setattr(module, name, fn)
    return restore


def _order(pid_imgs):
    # the FD CLIs' ``main`` takes the launching process's name lists
    return {} if pid_imgs is None else {"pid_imgs": pid_imgs}


def cli_main(mesh, cli, argv, out_dir, pid_imgs=None):
    """``reid_gan_torch.cli.<cli>.main(argv, mesh=mesh)`` with its writers
    (the log, the options file, the checkpoints and the GAN nets) recording
    which ranks call them under ``out_dir``; ``pid_imgs`` goes to the FD
    CLIs' ``main``."""
    import importlib

    mod = importlib.import_module(f"reid_gan_torch.cli.{cli}")
    # fdgan_train opens its log and writes its options through fdgan_baseline
    mods = [mod] + ([importlib.import_module("reid_gan_torch.cli.fdgan_baseline")]
                    if cli == "fdgan_train" else [])
    restores = []
    for m in mods:
        writers = [n for n in ("Logger", "dump_config", "save_checkpoint", "save_networks",
                               "Visualizer") if hasattr(m, n)]
        restores.append(_record_writes(m, mesh.rank, out_dir, writers))
    try:
        return _steps(mod.main(argv, mesh=mesh, **_order(pid_imgs)))
    finally:
        for restore in restores:
            restore()


def _steps(out):
    """What a CLI's ``main`` returned, or, for the warm-up's state and
    FD-GAN's engine, the number of steps it took (G's Adam step count)."""
    if hasattr(out, "step"):
        return out.step
    if hasattr(out, "opt_G"):
        return int(next(iter(out.opt_G.state.values()))["step"])
    return out


def cli_alone(mesh, cli, argv, pid_imgs=None):
    """``reid_gan_torch.cli.<cli>.main(argv, mesh=False)`` in a spawned
    process of its own (``mesh`` is a group of one, unused), so that it
    sees the environment the ranks of a ``spawn`` see. Returns what
    ``cli_main`` returns."""
    import importlib

    mod = importlib.import_module(f"reid_gan_torch.cli.{cli}")
    return _steps(mod.main(argv, mesh=False, **_order(pid_imgs)))


def fdgan_pose_epoch(cfg, dataset, device=None, mesh=None):
    """One epoch of the ``fdgan_pose`` loader as ``cli/fdgan_train`` builds
    it (the dataset's ``pid_imgs``, ``--seed``, the epoch-0 pair sampler),
    sharded over ``mesh``: each batch's two sides' rows of the target
    images, landmarks and flips. Under a mesh each rank also writes them,
    with its dataset's own ``pid_imgs`` order (``create`` in this
    process), to ``<logs-dir>/draws.rank<r>.pkl``."""
    import pickle

    import numpy as np

    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.data.sampler import RandomPairSampler

    train = list(dataset.train)
    pre = Preprocessor(train, mode="fdgan_pose", height=cfg.data.height,
                       width=cfg.data.width, pid_imgs=dataset.pid_imgs,
                       pose_root=dataset.poses_dir, seed=cfg.train.seed, cache=None)
    loader = DataLoader(pre, sampler=RandomPairSampler(train, neg_pos_ratio=1,
                                                       seed=cfg.train.seed),
                        batch_size=cfg.data.batch_size, num_workers=cfg.data.workers,
                        drop_last=True, shard=mesh)
    rows = [[{k: np.asarray(side[k]) for k in ("target", "landmark", "flip")}
             for side in batch] for batch in loader]
    if mesh is not None:
        own = create(cfg.data.dataset, cfg.data.data_dir).pid_imgs
        with open(osp.join(cfg.train.logs_dir, f"draws.rank{mesh.rank}.pkl"), "wb") as f:
            pickle.dump({"rows": rows, "own": {p: list(v) for p, v in own.items()}}, f)
    return rows


def fdgan_pose_ranks(mesh, argv, pid_imgs):
    """A rank of ``cli/fdgan_baseline.run_main`` whose run is
    ``fdgan_pose_epoch``."""
    from reid_gan_torch.cli.fdgan_baseline import run_main
    from reid_gan_torch.config import parse_config

    cfg = parse_config(argv, sections=("data", "train"))
    return run_main(cfg, "cpu", mesh, argv, fdgan_pose_ranks, fdgan_pose_epoch, pid_imgs)


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


def _load(net, state_dict):
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return net


def _numpy_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def mode_step(mesh, spec):
    """One fp64 step of the port's joint trainer in ``spec["mode"]``
    (``train``, ``train_all``, ``train_all_bip`` or ``train_all_with_memory``)
    on the rank's rows of ``spec["batch"]`` (the whole batch's ``pid`` and
    ``conf``), from ``spec``'s state dicts: the encoder ``enc`` (resnet18,
    or a depth-18 ``ResNetBip`` with ``bip``), the generator ``gen``'s ``G``
    and ``D`` at ``sizes`` (h, w, gh, gw), the bank (and ``gan_bank``), the
    clusters of the memory mode, with ``gan_mode``. ``alpha``, where given,
    is the whole batch's WGAN-GP draws (the trainer's ``gp_draws``). Returns
    rank 0's losses, the three nets' state dicts, both banks and, for the
    memory mode, every rank's clusters."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import ClusterContrastWithGANTrainer
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.models.resnet import ReIDResNet
    from reid_gan_torch.models.resnet_variants import ResNetBip
    from reid_gan_torch.ops.cluster_memory import init_gradient_memory, init_memory
    from reid_gan_torch.parallel import all_gather_rows, shard_batch

    h, w, gh, gw = spec["sizes"]
    bank = spec["bank"]
    model = _load(ResNetBip(depth=18) if spec.get("bip") else
                  ReIDResNet(depth=18, norm=True), spec["enc"]).double()
    gan = AEModel(GANConfig(model="AE", model_gen=spec["gen"],
                            gan_mode=spec.get("gan_mode", "lsgan")),
                  gan_height=gh, gan_width=gw, num_feats=32, ngf=8,
                  reid_feat_dim=bank.shape[1], device="cpu")
    _load(gan.net_G.double(), spec["G"])
    _load(gan.net_D.double(), spec["D"])
    trainer = ClusterContrastWithGANTrainer(model, gan, height=h, width=w,
                                            num_instances=spec["group"], device="cpu",
                                            mesh=mesh)
    if spec.get("alpha") is not None:
        def gp_draws(n, dtype):
            assert n == len(spec["alpha"])
            return torch.from_numpy(spec["alpha"]).to(dtype)

        trainer.gp_draws = gp_draws
    state = trainer.init_state(init_memory(bank, k_pad=256,
                                           gan_centroids=spec.get("gan_bank"),
                                           device="cpu"), gan.init_state())
    dev = {k: torch.from_numpy(v if k == "pid" or mesh is None else shard_batch(mesh, v))
           for k, v in spec["batch"].items()}
    mode, seed, gmem = spec["mode"], spec["seed"], None
    if mode == "train":
        state, errs = trainer.train_step(state, dev, seed)
    elif mode == "train_all":
        state, errs = trainer.train_all_step(state, dev, seed,
                                             torch.from_numpy(spec["conf"]))
    elif mode == "train_all_bip":
        state, errs = trainer.train_all_bip_step(state, dev, seed)
    else:
        gmem = init_gradient_memory(spec["clusters"], k_pad=256, device="cpu")
        state, gmem, errs = trainer.train_all_with_memory_step(
            state, gmem, dev, seed, spec["cluster_lr"])
    out = {"errs": {k: float(v) for k, v in errs.items()}, "enc": _numpy_state(model),
           "G": _numpy_state(gan.net_G), "D": _numpy_state(gan.net_D),
           "bank": state.memory.features.numpy(),
           "gan_bank": state.memory.gan_features.numpy()}
    if gmem is not None:
        out["clusters"] = all_gather_rows(mesh, gmem.clusters[None]).numpy() \
            if mesh is not None else gmem.clusters[None].numpy()
    return out


class _Batches:
    def __init__(self, batches):
        self.batches = iter(batches)

    def next(self):
        return next(self.batches)


def warmup_steps(mesh, spec):
    """``GANTrainer.train_gan`` in fp64 over ``spec["xs"]`` (a list of whole
    uint8 GAN batches, the rank's rows of each taken here) from the AE
    generator's and D's state dicts ``G``, ``D`` at (gh, gw) with
    ``gan_mode``; ``alphas``, where given, are each iteration's whole-batch
    WGAN-GP draws (the trainer's ``gp_draws``). Returns rank 0's losses of
    each iteration, both nets' state dicts and the step count."""
    from reid_gan_torch.config import GANConfig
    from reid_gan_torch.engine.gan_trainers import GANTrainer
    from reid_gan_torch.models.dual_gan.ae_model import AEModel
    from reid_gan_torch.parallel import shard_batch

    gh, gw = spec["sizes"]
    gan = AEModel(GANConfig(model="AE", model_gen="AE",
                            gan_mode=spec.get("gan_mode", "lsgan")),
                  gan_height=gh, gan_width=gw, num_feats=32, ngf=8, reid_feat_dim=64,
                  device="cpu")
    _load(gan.net_G.double(), spec["G"])
    _load(gan.net_D.double(), spec["D"])
    trainer = GANTrainer(gan, print_freq=100, device="cpu", mesh=mesh)
    steps, optimize = [], gan.optimize_parameters

    def recorded(*args, **kwargs):      # each iteration's losses, in fp64
        out = optimize(*args, **kwargs)
        steps.append({k: float(v) for k, v in out[1].items()})
        return out

    gan.optimize_parameters = recorded
    if spec.get("alphas") is not None:
        alphas = iter(spec["alphas"])

        def gp_draws(n, dtype):
            a = next(alphas)
            assert n == len(a)
            return torch.from_numpy(a).to(dtype)

        trainer.gp_draws = gp_draws
    local = [{"Xs": x if mesh is None else shard_batch(mesh, x)} for x in spec["xs"]]
    state, _ = trainer.train_gan(gan.init_state(), 0, _Batches(local),
                                 train_iters=len(local), base_seed=spec["seed"])
    return {"errs": steps, "G": _numpy_state(gan.net_G), "D": _numpy_state(gan.net_D),
            "step": state.step}


def cli_main_bip18(mesh, cli, argv, out_dir):
    """``cli_main`` with ``cli/train_gan_usl``'s ``resnet_bip50`` built at
    depth 18 (the smallest ``ResNetBip``), so that a CPU run stays short."""
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.models.resnet_variants import ResNetBip

    create = train_gan_usl.create_model

    def create_model(name, *args, dtype=None, **kwargs):
        if name != "resnet_bip50":
            return create(name, *args, dtype=dtype, **kwargs)
        return ResNetBip(18, *args, **kwargs)

    train_gan_usl.create_model = create_model
    try:
        return cli_main(mesh, cli, argv, out_dir)
    finally:
        train_gan_usl.create_model = create


def mesh_pieces(mesh, x, rows, bn_in):
    """``assemble_rows`` of the whole-batch rows ``rows`` from the rank's
    slice of ``x``; ``all_reduce_means`` of rank-dependent scalars; and a
    global BatchNorm (converted from ``nn.BatchNorm2d``) in train mode
    within ``local_stats`` on ``bn_in``, which every rank holds alike:
    its output, running stats and counter."""
    from reid_gan_torch.ops.norm import GlobalBatchNorm, convert_global_bn, local_stats
    from reid_gan_torch.parallel import all_reduce_means, assemble_rows, shard_batch

    picked = assemble_rows(mesh, shard_batch(mesh, torch.from_numpy(x)),
                           torch.from_numpy(rows)).numpy()
    r = mesh.rank
    means = all_reduce_means(mesh, {"a": torch.tensor(float(r)),
                                    "b": torch.tensor(2.0 * r, dtype=torch.float64)})
    net = convert_global_bn(torch.nn.Sequential(torch.nn.BatchNorm2d(bn_in.shape[1])),
                            mesh).double().train()
    assert isinstance(net[0], GlobalBatchNorm)
    with local_stats(net):
        y = net(torch.from_numpy(bn_in))
    assert not net[0].local
    return {"picked": picked, "means": {k: (float(v), v.dtype) for k, v in means.items()},
            "y": y.detach().numpy(), "rm": net[0].running_mean.numpy(),
            "rv": net[0].running_var.numpy(),
            "n": int(net[0].num_batches_tracked)}


def siamese_step(mesh, state_dict, img1, img2, targets, p1, p2):
    """One fp64 ``SiameseTrainer`` step (depth 18) on the rank's rows of the
    uint8 pair halves and targets, with the whole batch's K14 draws ``p1``,
    ``p2``. Returns rank 0's: the loss (the ranks' mean), the logits of
    every rank in order, the gradients SGD took (averaged over the ranks),
    the state dict after the step and the class of each BatchNorm."""
    from reid_gan_torch.engine.fdgan import SiameseTrainer
    from reid_gan_torch.models.multi_branch import siamese_baseline
    from reid_gan_torch.parallel import all_gather_rows, all_reduce_mean, shard_batch

    model = _load(siamese_baseline(depth=18).double(), state_dict)
    trainer = SiameseTrainer(model, lr=0.01, momentum=0.9, weight_decay=5e-4, device="cpu",
                             mesh=mesh)
    i1, i2, t = (torch.from_numpy(shard_batch(mesh, a)) for a in (img1, img2, targets))
    loss, logits = trainer.step(i1, i2, t, torch.from_numpy(p1), torch.from_numpy(p2))
    return {"loss": float(all_reduce_mean(mesh, loss)),
            "logits": all_gather_rows(mesh, logits).numpy(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()
                      if p.grad is not None},
            "state": _numpy_state(model),
            "norms": sorted({type(m).__name__ for m in model.modules()
                             if "BatchNorm" in type(m).__name__})}


def _pair_rows(mesh, t):
    """Every rank's rows of a pair tensor (the rank's ``[b1 rows; b2
    rows]``) in the whole batch's ``[b1; b2]`` order."""
    from reid_gan_torch.parallel import all_gather_rows

    g = all_gather_rows(mesh, t)
    return g.reshape(mesh.world_size, 2, -1, *t.shape[1:]).transpose(0, 1).reshape(g.shape)


def fdgan_step(mesh, spec):
    """One fp64 ``FDGANModel`` step (depth 18) at ``spec["size"]`` with
    ``spec["cfg"]``'s config, from the state dicts ``spec["nets"]``, on the
    rank's rows of the whole pair batches ``b1``, ``b2`` with the whole
    batch's draws ``spec["draws"]`` (an ``FDDraws``'s fields; without
    masks, G draws them from the model's generator, seeded by
    ``spec["seed"]``). ``mesh`` None runs one process on the whole batch.
    Returns rank 0's: the losses (the whole batch's), the fake in the
    batch's order, each net's gradients (as its optimiser took them) and
    state dict."""
    from reid_gan_torch.config import FDGANConfig
    from reid_gan_torch.models.fdgan.model import FDDraws, FDGANModel
    from reid_gan_torch.parallel import shard_batch

    h, w = spec["size"]
    model = FDGANModel(FDGANConfig(**spec["cfg"]), height=h, width=w, depth=18, device="cpu",
                       seed=spec["seed"], mesh=mesh)
    nets = model.nets()
    for name, net in nets.items():
        _load(net.double(), spec["nets"][name])
    draws = FDDraws(**{k: [torch.from_numpy(m) for m in v] if k == "masks"
                       else torch.from_numpy(v) for k, v in spec["draws"].items()})
    b1, b2 = (spec[k] if mesh is None else shard_batch(mesh, spec[k]) for k in ("b1", "b2"))
    errors, fake = model.optimize_step(b1, b2, draws)
    return {"errors": {k: float(v) for k, v in model.global_errors(errors).items()},
            "fake": (fake if mesh is None else _pair_rows(mesh, fake)).numpy(),
            "grads": {n: {k: p.grad.numpy() for k, p in net.named_parameters()
                          if p.grad is not None} for n, net in nets.items()},
            "state": {n: _numpy_state(net) for n, net in nets.items()}}


def bf16_usl_update(mesh, state_dict, bank, x, pid, height, width, num_instances, k_pad):
    """``ClusterContrastTrainer.update`` of the bf16 resnet18 (``--fp16``)
    on the rank's rows of the augmented fp32 batch ``x`` (NCHW; the whole
    batch's labels ``pid``), from ``state_dict``'s weights and the bank.
    Returns rank 0's loss (the ranks' mean), the gradients Adam took, and
    checks of the bf16 path under the mesh: the BatchNorms' classes, every
    gradient's dtype, and the dtype of the gradient that the first
    BatchNorm hands back to its convolution."""
    from reid_gan_torch.engine.trainers import ClusterContrastTrainer
    from reid_gan_torch.models.precision import set_compute_dtype
    from reid_gan_torch.ops.cluster_memory import init_memory
    from reid_gan_torch.parallel import shard_batch

    model = set_compute_dtype(_resnet18(state_dict), torch.bfloat16)
    trainer = ClusterContrastTrainer(model, height=height, width=width,
                                     num_instances=num_instances, device="cpu", mesh=mesh)
    seen = {}

    def note(module, grad_in, grad_out):
        seen.setdefault("conv1_out_grad", grad_out[0].dtype)

    model.conv1.register_full_backward_hook(note)
    state = trainer.init_state(init_memory(bank, k_pad=k_pad, device="cpu"))
    _, loss = trainer.update(state, torch.from_numpy(shard_batch(mesh, x)),
                             torch.from_numpy(pid))
    return {"loss": float(loss),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()
                      if p.grad is not None},
            "grad_dtypes": sorted({str(p.grad.dtype) for p in model.parameters()
                                   if p.grad is not None}),
            "norms": sorted({type(m).__name__ for m in model.modules()
                             if "BatchNorm" in type(m).__name__}),
            **{k: str(v) for k, v in seen.items()}}
