"""The port's options files (``train_opt.txt``, ``opt.txt``) against the
JAX package's ``dump_config`` of the same flags: every section of
``Config``, line for line, whichever sections the CLI parses."""

import os.path as osp
import tempfile

# the sections each JAX CLI parses (reid_gan_tpu/cli/*.py, parse_config)
JAX_SECTIONS = {
    "train_usl": ("data", "model", "optim", "cluster", "train"),
    "train_gan_usl": ("data", "model", "optim", "cluster", "train", "gan"),
    "train_gan_warmup": ("data", "model", "optim", "cluster", "train", "gan"),
    "fdgan_baseline": ("data", "model", "optim", "train"),
    "fdgan_train": ("data", "model", "optim", "train", "gan", "fdgan"),
}
ALL_SECTIONS = {"data", "model", "optim", "cluster", "train", "gan", "fdgan"}


def assert_options_match_jax(cli, path, flags):
    """``path`` (a port CLI's options file) equals JAX's ``dump_config`` of
    ``flags`` parsed as the JAX CLI ``cli`` parses them (the port's own
    ``--device`` is an unknown flag there, and ignored)."""
    from reid_gan_tpu.config import dump_config, parse_config

    fname = osp.basename(path)
    with tempfile.TemporaryDirectory() as d:
        dump_config(parse_config(flags, sections=JAX_SECTIONS[cli]), d, fname)
        with open(osp.join(d, fname)) as fh:
            ref = fh.read().splitlines()
    with open(path) as fh:
        got = fh.read().splitlines()
    assert got == ref
    assert {ln.split(".", 1)[0] for ln in got[1:-1]} == ALL_SECTIONS
