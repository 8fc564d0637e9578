"""``scripts/torch_fold_pool_probe.py`` patches K2's and K7's CUDA sources
into variants that ``PERF.md`` reports times for: every patch must still
find its anchor in the kernel as it is, so the script keeps reproducing
those numbers (the card builds them; here only the text is checked)."""

import importlib.util
import os.path as osp

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC = osp.join(REPO, "reid_gan_torch", "csrc")


def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_fold_pool_probe", osp.join(REPO, "scripts", "torch_fold_pool_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cases():
    probe = _probe()
    cases = [("gem_bn_l2n.cu", name) for name in probe.K2_VARIANTS]
    cases += [("bank_fold.cu", name) for name in probe.K7_VARIANTS]
    return cases + [("gem_bn_l2n.cu", "phases"), ("bank_fold.cu", "phases")]


@pytest.mark.parametrize("source,variant", _cases())
def test_probe_variant_applies_to_the_kernel(source, variant):
    probe = _probe()
    with open(osp.join(CSRC, source)) as fh:
        src = fh.read()
    if variant == "phases":
        patched = probe.PHASES[source](src)
        assert "clock64()" in patched and "reid_probe_clock" in patched
    else:
        table = probe.K2_VARIANTS if source == "gem_bn_l2n.cu" else probe.K7_VARIANTS
        patched = table[variant](src)
    assert patched != src
    # the C entry the probe calls is still there, with the kernel's signature
    entry = "reid_gem_bn_l2n(" if source == "gem_bn_l2n.cu" else "reid_bank_fold("
    assert entry in patched
