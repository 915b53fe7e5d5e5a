"""YOLOv8, YOLO11 and RT-DETR model families, MCAQ assembly and detection
loss (exports resolved at first use)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "ConvBnSiLU": ".layers",
    "C2f": ".layers",
    "SPPF": ".layers",
    "Bottleneck": ".layers",
    "C3k": ".layers",
    "C3k2": ".layers",
    "Attention": ".layers",
    "PSABlock": ".layers",
    "C2PSA": ".layers",
    "SeparableConvBnSiLU": ".layers",
    "HGStem": ".layers",
    "HGBlock": ".layers",
    "LightConv": ".layers",
    "RepConv": ".layers",
    "RepC3": ".layers",
    "HGNetv2Backbone": ".rtdetr",
    "HybridEncoder": ".rtdetr",
    "RTDETRDecoder": ".rtdetr",
    "select_queries": ".rtdetr",
    "YOLOv8Backbone": ".yolo",
    "YOLOv8Neck": ".yolo",
    "YOLO11Backbone": ".yolo",
    "YOLO11Neck": ".yolo",
    "DetectHead": ".yolo",
    "FAMILIES": ".yolo",
    "YOLOv8": ".yolo",
    "VARIANTS": ".yolo",
    "MCAQYOLO": ".mcaq_yolo",
    "MCAQYOLOLoss": ".losses",
    "DetectionLoss": ".losses",
    "kd_logit_loss": ".losses",
})
