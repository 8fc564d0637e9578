"""Training visualizer: the loss log, PNG image dumps and an HTML gallery
(port of ``reid_gan_tpu/utils/visualizer.py``; parity: CC/dual_gan/
gan_visualizer.py, FD/fdgan/utils/visualizer.py). The JAX package writes the
PNGs with PIL; the port writes the same 8-bit RGB PNGs with ``zlib`` and
``struct`` alone (``write_png``), so it needs no imaging package."""

import os.path as osp
import struct
import time
import zlib

import numpy as np

from .osutils import mkdir_if_missing


def tensor2im(t, norm="tanh"):
    """An image (HWC, or the first of a batch) → HWC uint8. ``tanh``: [-1, 1]
    → [0, 255]; ``imagenet``: de-normalised. One channel is repeated to
    three; more than three (a pose map) shows as their max, clipped to
    [0, 1] (visualizer.py:21-37)."""
    arr = np.asarray(t, np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if norm == "tanh":
        arr = (arr + 1.0) / 2.0
    elif norm == "imagenet":
        arr = arr * np.array([0.229, 0.224, 0.225]) + np.array([0.485, 0.456, 0.406])
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif arr.shape[-1] != 3:
        arr = np.clip(arr.max(axis=-1, keepdims=True), 0, 1)
        arr = np.repeat(arr, 3, axis=-1)
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def write_png(path, rgb):
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG: the signature, IHDR,
    one zlib IDAT of filter-0 scanlines, IEND."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(chunk(b"IEND", b""))


class Visualizer:
    def __init__(self, log_dir, name="experiment"):
        self.dir = log_dir
        self.name = name
        self.img_dir = osp.join(log_dir, "images")
        mkdir_if_missing(self.img_dir)
        self.loss_log = osp.join(log_dir, "loss_log.txt")
        with open(self.loss_log, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) "
                    f"================\n")
        self._epochs = []

    def display_current_results(self, visuals, epoch):
        """``visuals``: label → HWC image array in tanh [-1, 1]; each to
        ``images/epoch{epoch:03d}_{label}.png``, then ``index.html`` anew
        (visualizer.py:51-63)."""
        labels = []
        for label, img in visuals.items():
            write_png(osp.join(self.img_dir, f"epoch{epoch:03d}_{label}.png"),
                      tensor2im(img))
            labels.append(label)
        if epoch not in self._epochs:
            self._epochs.append(epoch)
        self._write_html(labels)

    def print_current_errors(self, epoch, i, errors, t=0.0):
        """Print one line of losses and append it to ``loss_log.txt``."""
        msg = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) " + " ".join(
            f"{k}: {float(v):.3f}" for k, v in errors.items())
        print(msg)
        with open(self.loss_log, "a") as f:
            f.write(msg + "\n")

    def _write_html(self, labels):
        rows = []
        for epoch in sorted(self._epochs, reverse=True):
            cells = "".join(
                f"<td><img src='images/epoch{epoch:03d}_{lb}.png' width=128>"
                f"<br>{lb}</td>" for lb in labels)
            rows.append(f"<tr><td>epoch {epoch}</td>{cells}</tr>")
        html = ("<html><head><title>{}</title></head><body><table border=1>"
                "{}</table></body></html>").format(self.name, "\n".join(rows))
        with open(osp.join(self.dir, "index.html"), "w") as f:
            f.write(html)
