from setuptools import find_packages, setup

setup(
    name="reid_gan_tpu",
    version="0.1.0",
    description="TPU-native person re-identification + GAN framework "
                "(JAX/XLA/Pallas/pjit)",
    packages=find_packages(exclude=["tests"]),
    package_data={"reid_gan_tpu.native": ["Makefile", "src/*.cc"],
                  "reid_gan_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "chex", "numpy", "pillow",
    ],
)
