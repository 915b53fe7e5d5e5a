"""Data pipeline: YOLO-txt dataset, letterbox, augmentation, padded
batches, the synthetic generators (exports resolved at first use)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "YOLODataset": ".dataset",
    "ImageFolderDataset": ".dataset",
    "DataLoader": ".dataset",
    "letterbox": ".dataset",
    "load_dataset_yaml": ".dataset",
    "compute_dataset_complexity": ".dataset",
    "create_complexity_balanced_sampler": ".dataset",
    "make_synthetic_dataset": ".dataset",
    "make_synthetic_dataset_v2": ".dataset",
    "make_synthetic_dataset_v3": ".dataset",
    "score_image_folder": ".dataset",
})
