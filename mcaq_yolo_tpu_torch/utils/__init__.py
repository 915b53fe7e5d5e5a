"""Utilities: evaluation (mAP), seeding, visualization (matplotlib at
first use), dataset complexity scoring (exports resolved at first use)."""

from .._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "set_global_seed": ".repro",
    "compute_map": ".evaluation",
    "evaluate_mcaq_yolo": ".evaluation",
    "visualize_complexity_map": ".visualization",
    "visualize_bit_allocation": ".visualization",
    "plot_training_curves": ".visualization",
    "visualize_complexity_vs_performance": ".visualization",
    "create_summary_report": ".visualization",
    "compute_dataset_complexity": "..data.dataset",
    "create_complexity_balanced_sampler": "..data.dataset",
})
