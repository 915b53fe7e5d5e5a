"""Packaging for mcaq-yolo-tpu (reference setup.py:1-74, minus the CUDA
extension — the fused kernel is Pallas, compiled at trace time by Mosaic,
so there is no ahead-of-time native build step for the compute path.  The
native C++ data-loader extension under native/ is built separately with
`make -C native` and loaded via ctypes, gated at import)."""

from setuptools import find_packages, setup

setup(
    name="mcaq-yolo-tpu",
    version="0.5.0",
    description=(
        "MCAQ-YOLO on TPU: morphological complexity-aware quantization for "
        "YOLO, JAX/Flax/Pallas-native (arXiv:2511.12976)"
    ),
    packages=find_packages(include=["mcaq_yolo_tpu", "mcaq_yolo_tpu.*",
                                    "mcaq_yolo_tpu_torch", "mcaq_yolo_tpu_torch.*"]),
    py_modules=["bench"],
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "pyyaml",
    ],
    extras_require={
        "full": ["opencv-python", "scipy", "matplotlib", "pillow", "orbax-checkpoint"],
        "dev": ["pytest"],
    },
    entry_points={
        "console_scripts": [
            "mcaq-yolo-train=mcaq_yolo_tpu.train:main",
            "mcaq-yolo-infer=mcaq_yolo_tpu.inference:main",
            "mcaq-yolo-bench=bench:main",
        ],
    },
)
