"""Pseudo-label generators: DBSCAN, Infomap, k-means (port of
``reid_gan_tpu/clustering``)."""
