"""YOLOv8 model family, MCAQ assembly and detection loss (exports resolved
at first use)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "ConvBnSiLU": ".layers",
    "C2f": ".layers",
    "SPPF": ".layers",
    "Bottleneck": ".layers",
    "YOLOv8Backbone": ".yolo",
    "YOLOv8Neck": ".yolo",
    "DetectHead": ".yolo",
    "YOLOv8": ".yolo",
    "VARIANTS": ".yolo",
    "MCAQYOLO": ".mcaq_yolo",
    "MCAQYOLOLoss": ".losses",
    "DetectionLoss": ".losses",
    "kd_logit_loss": ".losses",
})
