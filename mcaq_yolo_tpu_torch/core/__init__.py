"""Core MCAQ algorithms: morphology metrics, bit allocation, quantization,
curriculum scheduling (exports resolved at first use)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "CurriculumScheduler": ".curriculum",
    "ComplexityToBitMappingNetwork": ".bit_allocation",
    "ConstantBitMapper": ".bit_allocation",
    "LinearBitMapper": ".bit_allocation",
    "linear_bit_map": ".bit_allocation",
    "MorphologicalComplexityAnalyzer": ".morphology",
    "compute_phi_tiles": ".morphology",
    "SpatialAdaptiveQuantization": ".quantization",
    "LearnedSoftMask": ".quantization",
    "quantize_tensor": ".quantization",
    "compute_scale_zeropoint": ".quantization",
})
