"""The port's messages, docstrings and comments name a ROADMAP item by what
it is ("ROADMAP A: msgpack checkpoints"), never by its number, which a
re-anchor of ROADMAP.md renumbers."""

import glob
import os.path as osp
import re

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ITEM_NUMBER = re.compile(r"ROADMAP A-?[0-9]")


def _flat(text):
    """The text with quotes dropped and whitespace collapsed, so that a
    message split over two string literals or two lines reads as one."""
    return re.sub(r"\s+", " ", text.replace('"', " ").replace("'", " "))


def test_no_roadmap_item_numbers_in_the_port():
    sources = [f for ext in ("py", "cu", "cuh", "cc", "h")
               for f in glob.glob(osp.join(REPO, "reid_gan_torch", "**", f"*.{ext}"),
                                  recursive=True)
               if f"{osp.sep}build{osp.sep}" not in f]
    assert len(sources) > 50
    found = []
    for path in sources:
        with open(path, encoding="utf-8") as fh:
            text = _flat(fh.read())
        found += [f"{osp.relpath(path, REPO)}: {m.group(0)}" for m in ITEM_NUMBER.finditer(text)]
    assert not found, found
