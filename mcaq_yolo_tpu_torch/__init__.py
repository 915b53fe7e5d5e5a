"""
MCAQ-YOLO in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX/Flax package `mcaq_yolo_tpu` (which stays in the
repository as the reference).  This slice covers the deployed inference
path: letterbox -> YOLOv8 backbone -> per-scale MCAQ transform
(morphology -> complexity MLP -> bit mapper -> spatial quantizer) -> PAN
neck -> Detect head -> decode + NMS.

The one TPU kernel of the reference (the fused Pallas spatial quantizer,
`mcaq_yolo_tpu/ops/pallas_quant.py`) is a hand-written CUDA kernel here
(`csrc/spatial_quant.cu`, built for sm_90a at first use by `ops/build.py`).

Layout
------
core/       morphology metrics, bit allocation, quantization (eval path)
models/     YOLOv8 family, MCAQ assembly, flax-tree weight bridge
ops/        the CUDA spatial-quantize kernel + its plain version, NMS
data/       letterbox / unletterbox
utils/      flax msgpack checkpoint reader and writer
inference   Predictor

Entry points run on CUDA unless the caller passes device="cpu"; with no
CUDA device and no explicit "cpu" they raise (`device.resolve_device`).
Importing the package starts no build and touches no device.
"""

__version__ = "0.1.0"
