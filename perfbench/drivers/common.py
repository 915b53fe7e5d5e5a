"""What the drivers share: the reference model made from the seed, the
program's checkpoint and Predictor built from it, captures of the program's
intermediate outputs, and the reference's run on what the program served."""

from __future__ import annotations

import contextlib
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

from .. import weights
from ..reference import mcaq as rm
from ..reference import network as rn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def reference_model(cfg: Dict, seed: int, device, downsample: int) -> rm.MCAQYOLO:
    m = weights.build(rm.MCAQYOLO, device, cfg["variant"], cfg["nc"],
                      cfg["mcaq"]["grid_size"], downsample)
    return weights.init_(m, seed, cfg["nc"]).eval()


def reference_teacher(cfg: Dict, student: rm.MCAQYOLO, device) -> rn.YOLOv8:
    """The float32 teacher: the student's network at its initial weights."""
    t = weights.build(rn.YOLOv8, device, cfg["variant"], cfg["nc"])
    sd = {k: v for k, v in student.state_dict().items()
          if k.split(".")[0] in ("backbone", "neck", "head")}
    t.load_state_dict(sd, strict=True)
    return t.eval()


def program_model(cfg: Dict, device, dtype, downsample: int):
    """The program's MCAQYOLO at the configuration's settings."""
    from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO

    q = cfg["mcaq"]
    return MCAQYOLO(variant=cfg["variant"], num_classes=cfg["nc"], min_bits=q["min_bits"],
                    max_bits=q["max_bits"], target_bits=q["target_bits"],
                    grid_size=q["grid_size"], bit_mapping=q["bit_mapping"],
                    monotone_param=q["monotone_param"], morph_downsample=downsample,
                    morph_tile_engine=q["morph_tile_engine"], dtype=dtype, device=device)


class Checkpoint(contextlib.AbstractContextManager):
    """The reference's weights written through the program's own checkpoint
    path into a temporary directory under TMPDIR (removed on exit)."""

    def __init__(self, cfg: Dict, state: Dict[str, torch.Tensor], device):
        from mcaq_yolo_tpu_torch.models.weights_io import to_jax_variables
        from mcaq_yolo_tpu_torch.utils.checkpoint import save_checkpoint

        s = cfg["serve"]
        self.dir = Path(tempfile.mkdtemp(prefix="perfbench-"))
        self.path = self.dir / "model.ckpt"
        model = program_model(cfg, device, torch.float32, s["morph_downsample"])
        model.load_state_dict(state, strict=True)
        q = cfg["mcaq"]
        meta = {"epoch": 0, "variant": cfg["variant"], "num_classes": cfg["nc"],
                "img_size": cfg["img_size"], "deploy_temperature": s["temperature"],
                "config": {"quantization": {k: q[k] for k in (
                    "min_bits", "max_bits", "target_bits", "grid_size", "bit_mapping",
                    "monotone_param", "normalize_complexity")},
                    "morphology": {"downsample": s["morph_downsample"],
                                   "tile_engine": q["morph_tile_engine"]}}}
        save_checkpoint(self.path, to_jax_variables(model), meta)
        del model

    def __exit__(self, *exc):
        shutil.rmtree(self.dir, ignore_errors=True)


def predictor(cfg: Dict, path: Path, device):
    from mcaq_yolo_tpu_torch.inference import Predictor

    s = cfg["serve"]
    return Predictor(str(path), conf_threshold=s["conf"], iou_threshold=s["iou"],
                     max_det=s["max_det"], pre_topk=s["pool"], warmup=False,
                     dtype=DTYPES[s["dtype"]], device=device)


class Capture:
    """Forward hooks on the program's backbone, analyzer, mapper and Detect
    head that keep their outputs while `on` is set (copies on the card)."""

    def __init__(self, model):
        self.on = False
        self.feats: List[torch.Tensor] = []
        self.complexity: List[torch.Tensor] = []
        self.bits: List[torch.Tensor] = []
        self.raw: List[torch.Tensor] = []
        self.handles = [
            model.backbone.register_forward_hook(self._keep(self.feats)),
            model.complexity_analyzer.register_forward_hook(self._keep(self.complexity)),
            model.bit_mapper.register_forward_hook(self._keep(self.bits)),
            model.head.register_forward_hook(self._keep(self.raw))]

    def _keep(self, into):
        def hook(m, args, out):
            if self.on:
                outs = out if isinstance(out, (list, tuple)) else [out]
                into.extend(o.detach().clone() for o in outs)
        return hook

    def call(self, k: int) -> Dict[str, List[torch.Tensor]]:
        """The k-th captured call's three scales of each output."""
        return {name: getattr(self, name)[3 * k:3 * k + 3]
                for name in ("feats", "complexity", "bits", "raw")}

    def remove(self):
        for h in self.handles:
            h.remove()


def reference_state(ref: rm.MCAQYOLO, x: torch.Tensor, serve: Dict, feats=None,
                    bit_maps=None, lower: bool = False) -> Dict:
    """The reference on a whole batch, in blocks: `forward_blocks`' dict
    (from the images, or from given backbone features and bit maps) plus
    the detections, one dict per image.  Float32 without TF32, or, with
    `lower` (the control; its convolutions are set by `set_precision`),
    the MCAQ math with TF32 and decode and NMS in bfloat16."""
    with torch.no_grad(), rm.float32_products(tf32=lower):
        out = ref.forward_blocks(x, serve["temperature"], feats=feats, bit_maps=bit_maps)
    out["dets"] = detections(out["raw"], serve, torch.bfloat16 if lower else torch.float32)
    return out


def detections(raw, serve: Dict, dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    from ..compare import per_image

    with torch.no_grad():
        det = rn.detect(raw, serve["conf"], serve["iou"], serve["max_det"], serve["pool"], dtype)
    return per_image(*det)


def serve_numbers(prog: Dict, own: Dict, given: Dict, dets_of_raw) -> Dict[str, float]:
    """The serving cells' numbers (`perfbench/compare.py`), stage by stage:
    the backbone features against the reference's from the images
    (`own`); the complexity and bit maps, and the raw maps, against the
    reference following the program's features and bit maps (`given`);
    the detections against the reference's decode and NMS of the program's
    raw maps (`dets_of_raw`).  End to end from the images, for the record:
    bits, raw maps and detections against `own`.  The cell's limits file
    names those it compares."""
    from .. import compare

    return {"feat_rel_err": compare.rel_err(prog["feats"], own["feats"]),
            "complexity_gap_given": compare.mean_abs(prog["complexity"], given["complexity"]),
            "bits_mismatch_given": compare.bits_mismatch(prog["bits"], given["bits"]),
            "raw_rel_err_given": compare.rel_err(prog["raw"], given["raw"]),
            "det_mismatch_given": compare.det_mismatch(prog["dets"], dets_of_raw),
            "det_box_gap_given": compare.det_box_gap(prog["dets"], dets_of_raw),
            "bits_mismatch": compare.bits_mismatch(prog["bits"], own["bits"]),
            "raw_rel_err": compare.rel_err(prog["raw"], own["raw"]),
            "det_mismatch": compare.det_mismatch(prog["dets"], own["dets"])}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
