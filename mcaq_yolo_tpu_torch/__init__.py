"""
MCAQ-YOLO in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX/Flax package `mcaq_yolo_tpu` (which stays in the
repository as the reference).  It covers the deployed inference path
(letterbox -> YOLOv8 backbone -> per-scale MCAQ transform: morphology ->
complexity MLP -> bit mapper -> spatial quantizer -> PAN neck -> Detect
head -> decode + NMS), the training step and the Trainer's core (train
mode, fractional-bit compose, YOLOv8 loss with distillation, AdamW,
curriculum), and post-training calibration.

The one TPU kernel of the reference (the fused Pallas spatial quantizer,
`mcaq_yolo_tpu/ops/pallas_quant.py`) is a hand-written CUDA kernel here
(`csrc/spatial_quant.cu`, built for sm_90a at first use by `ops/build.py`).

Layout
------
core/       morphology metrics, bit allocation, quantization, curriculum
models/     YOLOv8 family, MCAQ assembly, losses, flax-tree weight bridge
ops/        the CUDA spatial-quantize kernel + its plain version, NMS
data/       letterbox / unletterbox, seeded synthetic batches
utils/      flax msgpack checkpoint reader and writer
batch_norm  BatchNorm with flax's training-mode statistics
inference   Predictor
train       train step, optimizer, Trainer core
calibrate   post-training EMA calibration, then freeze

Entry points run on CUDA unless the caller passes device="cpu"; with no
CUDA device and no explicit "cpu" they raise (`device.resolve_device`).
Importing the package starts no build and touches no device.
"""

__version__ = "0.1.0"
