import errno
import os


def mkdir_if_missing(dir_path):
    """Create ``dir_path`` (and parents) if absent (FD/reid/utils/osutils.py)."""
    try:
        os.makedirs(dir_path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise
