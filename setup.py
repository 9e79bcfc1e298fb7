"""Build for the native runtime extension: python setup.py build_ext --inplace.

The CUDA kernels of peba1_tpu_torch are not built here: they are compiled
with nvcc at first use on a machine with the card (ops/cuda_kernels.py).
"""

from setuptools import Extension, setup

setup(
    name="peba1_tpu",
    version="0.1.0",
    packages=["peba1_tpu", "peba1_tpu_torch", "peba1_tpu_torch.io",
              "peba1_tpu_torch.ops", "peba1_tpu_torch.parallel",
              "peba1_tpu_torch.utils"],
    package_data={"peba1_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "peba1_native",
            sources=["native/peba1_native.c"],
            extra_compile_args=["-O3"],
        )
    ],
)
