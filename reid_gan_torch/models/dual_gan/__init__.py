"""dual_gan: the pose generator, the spectral-norm discriminator and the AE
engine of the joint GAN + re-ID loop (port of ``reid_gan_tpu/models/dual_gan``;
parity: CC/dual_gan/models)."""
