"""dual_gan: the pose and AE generators, the spectral-norm discriminator and
the AE engine of the joint GAN + re-ID loop and the GAN warm-up (port of
``reid_gan_tpu/models/dual_gan``; parity: CC/dual_gan/models)."""
