"""Config system: a dataclass tree with argparse adapters preserving the
reference's flag names (copy of ``reid_gan_tpu/config.py``, the sections the
eval, USL, joint GAN and FD-GAN CLIs parse: data, model, optim, cluster,
train, gan, fdgan).
"""

import argparse
import os
from dataclasses import dataclass, field, fields

from .utils.osutils import mkdir_if_missing


@dataclass
class DataConfig:
    """Dataset + loader flags (CC/examples/cluster_contrast_train_usl.py:235-260)."""
    dataset: str = "market1501"
    data_dir: str = "./data"
    height: int = 256
    width: int = 128
    batch_size: int = 256
    num_instances: int = 16      # K in P×K batches
    workers: int = 4
    # GAN input branch (CC preprocessor 3-mode, load_size 128x64)
    gan_height: int = 128
    gan_width: int = 64


@dataclass
class ModelConfig:
    """Backbone flags (CC/examples/cluster_contrast_train_usl.py:262-270)."""
    arch: str = "resnet50"
    features: int = 0            # embedding dim; 0 = raw 2048
    dropout: float = 0.0
    pooling_type: str = "gem"
    norm: bool = True            # L2-normalize bn_x in train mode
    num_classes: int = 0


@dataclass
class OptimConfig:
    lr: float = 3.5e-4
    weight_decay: float = 5e-4
    momentum: float = 0.9        # (SGD variants)
    step_size: int = 20          # StepLR gamma 0.1 every step_size epochs
    optimizer: str = "adam"


@dataclass
class ClusterConfig:
    """Pseudo-label generation (CC/examples/*usl*.py)."""
    eps: float = 0.4
    min_samples: int = 4
    k1: int = 30                 # k-reciprocal kNN
    k2: int = 6
    use_hard: bool = False       # CM_Hard memory update
    momentum: float = 0.2        # memory bank momentum
    temp: float = 0.05           # InfoNCE temperature
    cluster_backend: str = "dbscan"   # dbscan | infomap | kmeans
    max_clusters: int = 0        # 0 = auto (pad-and-mask memory bank sizing)


@dataclass
class TrainConfig:
    epochs: int = 50
    iters: int = 400
    seed: int = 1
    print_freq: int = 10
    eval_step: int = 10
    logs_dir: str = "./logs"
    resume: str = ""
    evaluate: bool = False
    debug: bool = False          # shrink run to 1 epoch × few iters
    fp16: bool = False           # reduced-precision compute


@dataclass
class GANConfig:
    """dual_gan flags (CC/examples/options/{base,train}_options.py, and the
    AEModel plugin options CC/dual_gan/models/AE_model.py:19-46)."""
    model: str = "AE"            # dual_gan engine: AE | DPTN
    model_gen: str = "AE"        # generator flavor: AE|DEC|FD|Pose|PoseAE
    gan_mode: str = "lsgan"      # lsgan | vanilla (bce) | hinge | wgangp
    gan_lr: float = 1e-3
    ratio_g2d: float = 0.1       # D lr = gan_lr * ratio_g2d
    lambda_rec: float = 10.0
    lambda_g: float = 1.0
    lambda_style: float = 0.0
    lambda_content: float = 0.0
    use_vgg: bool = False
    vgg_weights: str = ""        # path to a torchvision vgg19 .pth state
    #                              dict; empty → LOUD random-tap warning
    ngf: int = 64
    ndf: int = 64
    # NOTE: the reference's --z_dim flag is parsed but never consumed by any
    # dual_gan model (grep over CC/dual_gan/) — not reproduced here.
    pose_channels: int = 18
    save_dir: str = "./checkpoints"
    name: str = "experiment"
    continue_train: bool = False
    which_epoch: str = "latest"
    display_freq: int = 100      # iters between visual dumps (FD/train.py:81)
    # joint-training flags (TrainOptions:57-78)
    #
    # Gating semantics chosen here (the reference never defined the
    # warmup_epo x cluster_with_gan_features interaction — its conf-weight
    # call is commented out, ...infomap.py:431-436): epochs < warmup_epo
    # run encoder-only `train_reid` with the plain reid loader; the GAN
    # joins at epoch >= warmup_epo ((epoch+1) > warmup_epo in the
    # cli/train_gan_usl.py mode dispatch), and the pose-conditioned
    # confidence weights of compute_conf_weight join ONE epoch later
    # (epoch > warmup_epo) — deliberately offset so weights are never
    # computed from a generator that has not yet taken a training step.
    warmup_epo: int = 0
    gan_train: bool = True
    bipath: bool = False
    learnable_memory: bool = False
    cluster_with_gan_features: bool = False
    cluster_lr: float = 0.1
    cf_temp: float = 0.05
    # NOTE: the reference's --lambda_nl flag drives nothing in any shipped
    # trainer (CC/examples/options/train_options.py:64) — not reproduced.
    t_s_ratio: float = 0.5       # DPTN source/target loss balance


@dataclass
class FDGANConfig:
    """FD-GAN stage II/III flags (FD/fdgan/options.py:8-58)."""
    stage: int = 1               # 1 = E frozen (stage II), 2 = joint (stage III)
    lr: float = 1e-3
    netE_pretrain: str = ""
    netG_pretrain: str = ""
    netDi_pretrain: str = ""
    netDp_pretrain: str = ""
    lambda_recon: float = 100.0
    lambda_veri: float = 0.0
    lambda_sp: float = 0.0
    smooth_label: bool = True
    pose_aug: str = "no"         # no|erase|gauss (FD/train.py:48 →
    #                              FD/reid/utils/data/preprocessor.py:114-131)
    noise_size: int = 56
    pose_feature_size: int = 128
    drop: float = 0.2
    connect_layers: int = 0
    fuse_mode: str = "cat"
    niter: int = 50
    niter_decay: int = 50
    eval_step: int = 5
    save_step: int = 10


@dataclass
class Config:
    """Top-level config tree."""
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    gan: GANConfig = field(default_factory=GANConfig)
    fdgan: FDGANConfig = field(default_factory=FDGANConfig)


# short aliases used throughout the reference CLIs
# (CC/examples/cluster_contrast_train_usl.py:235-260: -b, -a, -d, -j, -n)
_SHORT_FLAGS = {"batch_size": "-b", "arch": "-a", "dataset": "-d",
                "workers": "-j", "num_instances": "-n"}


def add_dataclass_args(parser, dc_cls, prefix=""):
    """Expose a dataclass's fields as ``--flag`` argparse options (flat names
    + the reference's short aliases)."""
    for f in fields(dc_cls):
        name = f"--{f.name.replace('_', '-')}"
        alt = f"--{f.name}"
        opts = [name] if name == alt else [name, alt]
        if f.name in _SHORT_FLAGS:
            opts.append(_SHORT_FLAGS[f.name])
        if f.type in ("bool", bool):
            parser.add_argument(*opts, dest=prefix + f.name,
                                action=argparse.BooleanOptionalAction,
                                default=None)
        else:
            ftype = {"int": int, "float": float, "str": str}.get(f.type, None)
            if ftype is None:
                ftype = f.type if callable(f.type) else str
            parser.add_argument(*opts, dest=prefix + f.name, type=ftype, default=None)


def parse_config(argv=None, sections=("data", "model", "optim", "cluster", "train", "gan")):
    """Build a Config from CLI args. Later sections win on duplicate flag
    names (none currently collide across the enabled sections)."""
    cfg = Config()
    parser = argparse.ArgumentParser(conflict_handler="resolve")
    for sec in sections:
        add_dataclass_args(parser, type(getattr(cfg, sec)), prefix=sec + ".")
    ns, _ = parser.parse_known_args(argv)
    for key, val in vars(ns).items():
        if val is None:
            continue
        sec, fname = key.split(".", 1)
        setattr(getattr(cfg, sec), fname, val)
    return cfg


def dump_config(cfg, out_dir, fname="train_opt.txt"):
    """Write the resolved options of every section, one ``section.field:
    value`` line each, whichever sections the CLI parses (config.py:222-235;
    parity: CC/examples/options/base_options.py:148-159)."""
    mkdir_if_missing(out_dir)
    lines = ["------------ Options -------------"]
    for sec_field in fields(cfg):
        sec = getattr(cfg, sec_field.name)
        for f in fields(sec):
            lines.append(f"{sec_field.name}.{f.name}: {getattr(sec, f.name)}")
    lines.append("-------------- End ----------------")
    path = os.path.join(out_dir, fname)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
