"""Port parity for one fp64 ``FDGANModel`` step of stage 2 (paper stage
III: E and Di trained with fixed BatchNorm, one Adam over G and E),
``pose_aug`` erase, against the JAX package's jitted step, as
``test_torch_port_fdgan_step.py`` holds stage 1."""

from test_torch_port_fdgan_step import fdgan_step_parity
from test_torch_port_knn import few_threads  # noqa: F401 (autouse)


def test_fdgan_stage2_step_matches_jax():
    fdgan_step_parity(2, "erase")
