"""Dataset registry (parity: CC/clustercontrast/datasets/__init__.py and
FD/reid/datasets/__init__.py factories)."""

from .base import BaseImageDataset
from .dir_datasets import DukeMTMC, Market1501, MSMT17, PersonX, VeRi
from .json_dataset import CUHK03, JsonDataset
from .synthetic import HardSyntheticDataset, SyntheticDataset

__factory = {
    "market1501": Market1501,
    "dukemtmcreid": DukeMTMC,
    "dukemtmc": DukeMTMC,
    "msmt17": MSMT17,
    "personx": PersonX,
    "veri": VeRi,
    "cuhk03": CUHK03,
    "json": JsonDataset,
    "synthetic": SyntheticDataset,
    "synthetic_hard": HardSyntheticDataset,
}


def names():
    return sorted(__factory.keys())


def create(name, root, *args, **kwargs):
    """Create a dataset by name; returns an object with ``.train``, ``.query``,
    ``.gallery`` lists of ``(fname, pid, camid)``."""
    if name not in __factory:
        raise KeyError(f"Unknown dataset: {name}")
    return __factory[name](root, *args, **kwargs)


__all__ = ["BaseImageDataset", "create", "names"]
