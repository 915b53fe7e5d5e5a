"""Minimal dict-config Trainer usage + post-train inference check, on the
PyTorch port (`mcaq_yolo_tpu_torch`; `examples/train_example.py` is the JAX
package's).  Runs end to end on a synthetic dataset, no downloads needed:

    python examples/train_example_torch.py [--device cpu]

On CUDA (the default; it raises without a card) training and serving run
the port's hand-written kernels: the phi kernel in every forward that
scores complexity, the quantize kernel in the quantized eval forwards.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mcaq_yolo_tpu_torch.data import make_synthetic_dataset  # noqa: E402
from mcaq_yolo_tpu_torch.data.dataset import read_image  # noqa: E402
from mcaq_yolo_tpu_torch.device import resolve_device  # noqa: E402
from mcaq_yolo_tpu_torch.inference import Predictor  # noqa: E402
from mcaq_yolo_tpu_torch.train import Trainer  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    # an absolute root: the dataset's yaml keeps its root as given
    root = Path(tempfile.mkdtemp(prefix="mcaq_example_")).resolve()
    yaml_path = make_synthetic_dataset(str(root), n_images=16, img_size=128,
                                       n_classes=4)

    config = {
        "model": {"name": "yolov8n", "num_classes": 4, "teacher_path": None},
        "data": {"yaml_path": yaml_path, "img_size": 128, "max_boxes": 16},
        "epochs": 3,
        "batch_size": 4,
        "learning_rate": 1e-3,
        "quantization": {
            "min_bits": 2, "max_bits": 8, "target_bits": 4.0,
            "grid_size": 8, "bit_mapping": "linear",
        },
        "curriculum": {
            "enabled": True, "warmup_epochs": 1, "transition_epochs": 2,
            "initial_temperature": 10.0,
        },
        "distillation": {"enabled": False},
        "training": {"map_interval": 1},
        "seed": 0,
        "output_dir": str(root / "outputs"),
    }

    trainer = Trainer(config, device=device)
    results = trainer.train()
    print("training:", results)

    # inference on one image with the final checkpoint
    ckpt = Path(config["output_dir"]) / "last.ckpt"
    predictor = Predictor(str(ckpt), num_classes=4, variant="yolov8n",
                          img_size=128, warmup=False, device=device)
    img_file = sorted(Path(root, "images", "train").glob("*.jpg"))[0]
    out = predictor.predict(read_image(str(img_file)))
    print(f"inference: {len(out['detections'])} detections, "
          f"{out['inference_time_ms']:.1f} ms, avg_bits {out['avg_bits']:.2f}")
    return {"root": root, "checkpoint": ckpt, "results": results,
            "history": trainer.history, "inference": out}


if __name__ == "__main__":
    main()
