"""``scripts/torch_rank_probe.py`` patches K3's CUDA source into variants
that ``PERF.md`` reports times for: every patch must still find its anchor
in the kernel as it is, so the script keeps reproducing those numbers (the
card builds them; here only the text is checked)."""

import importlib.util
import os.path as osp

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SOURCE = osp.join(REPO, "reid_gan_torch", "csrc", "rank_stats.cu")


def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_rank_probe", osp.join(REPO, "scripts", "torch_rank_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", sorted(_probe().VARIANTS) + ["phases"])
def test_probe_variant_applies_to_the_kernel(variant):
    probe = _probe()
    with open(SOURCE) as fh:
        src = fh.read()
    if variant == "phases":
        patched = probe.phases(src)
        assert patched.count("clock64()") == 5 and "reid_probe_clock" in patched
    else:
        patched = probe.VARIANTS[variant](src)
    assert patched != src
    # the C entry the probe calls is still there, with the kernel's signature
    assert "extern \"C\" int reid_rank_stats(" in patched
