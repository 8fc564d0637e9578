"""FD-GAN: the pose-guided feature-distilling GAN (NIPS'18) of the port
(``reid_gan_tpu/models/fdgan``)."""
