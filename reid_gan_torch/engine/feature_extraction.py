"""Feature extraction helpers and an on-disk feature database (port of
``reid_gan_tpu/engine/feature_extraction.py``; parity: FD/reid/
feature_extraction/cnn.py:9-27, database.py:8-51)."""

import numpy as np


def extract_cnn_feature(extractor, imgs):
    """One uint8 batch → host features through ``extractor`` (a
    ``FeatureExtractor``); of a tuple of outputs, the first."""
    out = extractor(np.asarray(imgs))
    return out[0] if isinstance(out, tuple) else out


class FeatureDatabase:
    """A dict-like fname → feature store in an HDF5 file (the arguments are
    ``h5py.File``'s). ``h5py`` is imported here, not with the module."""

    def __init__(self, *args, **kwargs):
        import h5py

        self.fid = h5py.File(*args, **kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def __getitem__(self, keys):
        if isinstance(keys, (tuple, list)):
            return [self._get_single_item(k) for k in keys]
        return self._get_single_item(keys)

    def _get_single_item(self, key):
        return np.asarray(self.fid[key])

    def __setitem__(self, key, value):
        if key in self.fid:
            if self.fid[key].shape == value.shape and \
                    self.fid[key].dtype == value.dtype:
                self.fid[key][...] = value
                return
            del self.fid[key]
        self.fid.create_dataset(key, data=value)

    def __delitem__(self, key):
        del self.fid[key]

    def __len__(self):
        return len(self.fid)

    def __iter__(self):
        return iter(self.fid)

    def flush(self):
        self.fid.flush()

    def close(self):
        self.fid.close()
