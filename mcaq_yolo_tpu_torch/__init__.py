"""
MCAQ-YOLO in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX/Flax package `mcaq_yolo_tpu` (which stays in the
repository as the reference).  It covers the deployed inference path
(letterbox -> YOLOv8 backbone -> per-scale MCAQ transform: morphology ->
complexity MLP -> bit mapper -> spatial quantizer -> PAN neck -> Detect
head -> decode + NMS), training from a YOLO-format dataset on disk (host
and device-resident loaders, Eq.(8) curriculum scoring and sampling, train
mode, fractional-bit compose, YOLOv8 loss with distillation, AdamW, mAP
evaluation, checkpoints that either package resumes, the CLI), and the
deployment of a model trained elsewhere: Ultralytics YOLOv8 weights,
post-training calibration in all four modes, the inference CLI and a
`torch.export` artifact that carries the kernel as the registered op
`mcaq::spatial_quantize`.

The one TPU kernel of the reference (the fused Pallas spatial quantizer,
`mcaq_yolo_tpu/ops/pallas_quant.py`) is a hand-written CUDA kernel here
(`csrc/spatial_quant.cu`, built for sm_90a at first use by `ops/build.py`,
which also builds the host letterbox library `csrc/dataio.cpp` with g++).

Layout
------
core/       morphology metrics, Eq.(8) scores, bit allocation, quantization,
            curriculum, NNLS refit
models/     YOLOv8 family, MCAQ assembly, losses, flax-tree weight bridge,
            Ultralytics converter
ops/        the CUDA spatial-quantize kernel (a registered op) + its plain
            version, NMS, builds
data/       YOLO dataset, loader, generators, device pipeline, native
            letterbox binding, seeded synthetic batches
utils/      flax msgpack checkpoints, mAP evaluation, seeding, CUDA timing,
            model statistics, visualization
batch_norm  BatchNorm with flax's training-mode statistics
inference   Predictor, CLI
train       train step, optimizer, Trainer, CLI
calibrate   post-training EMA calibration, then freeze
export      torch.export of the serving program, save and load
scripts/    the evidence scripts: quality arms, placement ablations, the
            deploy levers' fidelity

Entry points run on CUDA unless the caller passes device="cpu"; with no
CUDA device and no explicit "cpu" they raise (`device.resolve_device`).
Importing the package starts no build and touches no device: the names
below (`from mcaq_yolo_tpu_torch import Predictor`) import their module at
first use.
"""

from ._lazy import lazy_exports

__version__ = "0.1.0"

__getattr__, __dir__ = lazy_exports(__name__, {
    "MCAQYOLO": ".models.mcaq_yolo",
    "MCAQYOLOLoss": ".models.losses",
    "Trainer": ".train",
    "Predictor": ".inference",
    "MorphologicalComplexityAnalyzer": ".core.morphology",
    "ComplexityToBitMappingNetwork": ".core.bit_allocation",
    "LinearBitMapper": ".core.bit_allocation",
    "SpatialAdaptiveQuantization": ".core.quantization",
    "LearnedSoftMask": ".core.quantization",
    "CurriculumScheduler": ".core.curriculum",
})
