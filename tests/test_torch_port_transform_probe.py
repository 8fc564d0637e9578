"""``scripts/torch_transform_probe.py`` patches K1's and K12's CUDA sources
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
        "torch_transform_probe", osp.join(REPO, "scripts", "torch_transform_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cases():
    return [(source, name) for source, variants in _probe().SOURCES.items()
            for name in variants] + [("diff_transform.cu", "phases")]


@pytest.mark.parametrize("source,variant", _cases())
def test_probe_variant_applies_to_the_kernel(source, variant):
    probe = _probe()
    with open(osp.join(CSRC, source)) as fh:
        src = fh.read()
    if variant == "phases":
        patched = probe.k12_phases(src)
        assert "clock64()" in patched and "reid_probe_clock" in patched
    else:
        patched = probe.SOURCES[source][variant](src)
    assert patched != src
    # the C entry the probe calls is still there, with the kernel's signature
    entry = "reid_eval_transform(" if source == "eval_transform.cu" else "reid_diff_transform("
    assert entry in patched
