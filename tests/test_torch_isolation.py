"""The port stands alone: every module of `mcaq_yolo_tpu_torch` imports with
jax, flax and the JAX package blocked, none of them gets loaded, and the
entry points refuse to run without CUDA unless asked for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "mcaq_yolo_tpu")
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    for name in BLOCKED:
        sys.modules[name] = None  # any import of it now raises ImportError

    import mcaq_yolo_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(mcaq_yolo_tpu_torch.__path__,
                                                   "mcaq_yolo_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = [n for n, m in sys.modules.items()
              if n.split(".")[0] in BLOCKED and m is not None]
    assert not loaded, loaded
    for name in ("train", "calibrate", "models.losses", "core.curriculum",
                 "batch_norm", "data.synthetic",  # the training slice
                 "data.dataset", "data.native_loader", "data.device_pipeline",
                 "core.morphology_cv2", "utils.evaluation", "utils.repro",  # from disk
                 "export", "utils.model_utils", "utils.visualization",  # deployment
                 "scripts.quality_evidence", "scripts.quality_assemble",  # evidence
                 "scripts.m3_permutation", "scripts.m4_variation_gain",
                 "scripts.downsample_fidelity", "scripts.pretopk_equivalence",
                 "scripts.backend_agreement", "scripts.profile_morphology",  # diagnostics
                 "scripts.roofline", "scripts.perf_sweep_diag", "scripts.train_breakdown",
                 "utils.profiling"):
        assert "mcaq_yolo_tpu_torch." + name in names, name
    import torch
    assert hasattr(torch.ops.mcaq, "spatial_quantize")  # registered at import
    from mcaq_yolo_tpu_torch.ops import build
    assert not build._libs  # nothing was built or loaded

    import torch
    if not torch.cuda.is_available():
        from mcaq_yolo_tpu_torch.inference import Predictor
        from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
        from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
        from mcaq_yolo_tpu_torch.train import Trainer
        from mcaq_yolo_tpu_torch.data.device_pipeline import DevicePipeline
        from mcaq_yolo_tpu_torch.train import main
        from mcaq_yolo_tpu_torch.inference import main as infer_main
        from mcaq_yolo_tpu_torch.scripts import (downsample_fidelity, m3_permutation,
                                                 m4_variation_gain, pretopk_equivalence,
                                                 quality_evidence)
        ck = ["--model", "no-such.ckpt", "--data", "no-such.yaml"]
        script_mains = [lambda: quality_evidence.main(["--root", "/nonexistent/never-made"]),
                        lambda: m3_permutation.main(ck), lambda: m4_variation_gain.main(ck),
                        lambda: downsample_fidelity.main(["--ckpt", "x", "--data", "y"]),
                        lambda: pretopk_equivalence.main(["--ckpt", "x", "--data-yaml", "y"])]
        for build in (lambda: MCAQYOLO(num_classes=4), lambda: YOLOv8(num_classes=4),
                      lambda: Predictor("no-such.ckpt", warmup=False),
                      lambda: Trainer({"output_dir": "/nonexistent/never-made"}, []),
                      lambda: Trainer({"output_dir": "/nonexistent/never-made"}),
                      lambda: DevicePipeline(type("D", (), {"img_size": 64})()),
                      lambda: main(["--config", "/nonexistent/never-read.yaml"]),
                      lambda: infer_main(["--model", "no-such.ckpt", "--source", "."]),
                      *script_mains):
            try:
                build()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("an entry point ran without CUDA or device='cpu'")
    print("ISOLATED", len(names))
""")


_EXPORTS = textwrap.dedent("""
    import sys
    from mcaq_yolo_tpu_torch import MCAQYOLO, Predictor, Trainer, CurriculumScheduler
    from mcaq_yolo_tpu_torch.ops import batched_nms, non_max_suppression
    from mcaq_yolo_tpu_torch.utils import (compute_map, evaluate_mcaq_yolo, set_global_seed,
                                           compute_dataset_complexity)
    from mcaq_yolo_tpu_torch.data import YOLODataset, make_synthetic_dataset_v3
    from mcaq_yolo_tpu_torch.core import LinearBitMapper, SpatialAdaptiveQuantization
    from mcaq_yolo_tpu_torch.models import VARIANTS, MCAQYOLOLoss
    import torch
    from mcaq_yolo_tpu_torch.ops import build
    assert not build._libs  # no build started
    assert not torch.cuda.is_initialized()  # no device touched
    print("EXPORTS OK")
""")


def test_package_exports_resolve_lazily_without_a_build_or_a_device():
    """The package and its sub-packages export the reference's names (PEP 562,
    resolved at first use); resolving them builds nothing and touches no
    device."""
    r = subprocess.run([sys.executable, "-c", _EXPORTS], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "EXPORTS OK" in r.stdout, r.stdout + r.stderr


def test_port_imports_without_jax_and_needs_an_explicit_cpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("ISOLATED")[1])
    assert n >= 28  # every submodule was imported


def test_port_sources_name_no_jax_import():
    """No import statement of the port or chip_smoke.py names jax, flax or
    the JAX package (a static check beside the runtime one above)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mcaq_yolo_tpu)\b", re.M)
    files = list((REPO / "mcaq_yolo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
