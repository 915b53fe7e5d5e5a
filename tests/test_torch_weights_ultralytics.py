"""Ultralytics YOLOv8 weights into the port (`mcaq_yolo_tpu_torch/models/
weights_io.py: convert_torch_yolov8, load_pretrained_into`) against the JAX
converter on the CPU, with `tests/torch_yolo_fixture.py` standing in for
the Ultralytics package (its state_dict keys are those of
`tests/yolov8_key_manifest.json`).

Contracts:
  * the converted flax tree equals the JAX converter's, leaf by leaf,
    bitwise (yolov8n, s, m);
  * strict coverage: every manifest key is consumed (BatchNorm counters and
    the DFL kernel excepted), an extra key raises under strict=True and
    passes with strict=False; a wrong shape raises;
  * the fixture's float32 forward against the port's after
    `load_pretrained_into`, yolov8n at 64 px: C3/C4/C5 features and raw
    head maps within 2e-4 (measured ~2e-6: the same operations, summed in
    another order), through `YOLOv8` and through `MCAQYOLO(quantize=False)`.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu.models.weights_io import convert_torch_yolov8 as jax_convert
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import (
    convert_torch_yolov8,
    load_pretrained_into,
    to_jax_variables,
)
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
from torch_yolo_fixture import TYOLOv8n, randomize_bn_stats, ultralytics_state_dict

MANIFEST = json.loads((Path(__file__).parent / "yolov8_key_manifest.json").read_text())


def _fixture(variant, nc, seed=0):
    torch.manual_seed(seed)
    t = TYOLOv8n(nc=nc, variant=variant)
    with torch.no_grad():
        randomize_bn_stats(t, torch.Generator().manual_seed(seed + 1))
    return t.eval()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("variant", ["yolov8n", "yolov8s", "yolov8m"])
def test_converted_tree_equals_jax_and_covers_the_manifest(variant):
    sd = ultralytics_state_dict(_fixture(variant, 80))
    assert sorted(sd) == MANIFEST[variant]["keys"]
    ours = convert_torch_yolov8(sd, strict=True)
    ref = jax_convert(sd, strict=True)
    for a, b in zip(ours, ref):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == lb[k].dtype, k
            np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))
    extra = dict(sd, **{"model.23.conv.weight": np.zeros((8, 8, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="NOT consumed"):
        convert_torch_yolov8(extra, strict=True)
    convert_torch_yolov8(extra, strict=False)


@pytest.mark.parametrize("variant", ["yolov8s", "yolov8m"])
def test_load_into_the_port_s_m(variant):
    sd = ultralytics_state_dict(_fixture(variant, 4))
    model = load_pretrained_into(YOLOv8(variant, 4, device="cpu"), sd)
    np.testing.assert_array_equal(model.backbone.ConvBnSiLU_0.Conv_0.weight.detach().numpy(),
                                  sd["model.0.conv.weight"].numpy())
    np.testing.assert_array_equal(model.head.cls2_conv1.BatchNorm_0.running_var.numpy(),
                                  sd["model.22.cv3.2.1.bn.running_var"].numpy())


def test_shape_mismatch_and_file_input(tmp_path):
    sd = ultralytics_state_dict(_fixture("yolov8n", 4))
    bad = dict(sd, **{"model.0.conv.weight": torch.zeros(7, 3, 3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_into(YOLOv8("yolov8n", 4, device="cpu"), bad)
    path = tmp_path / "yolov8n_sd.pt"
    torch.save(sd, path)
    params, _ = convert_torch_yolov8(str(path))
    np.testing.assert_array_equal(params["head"]["box0_out"]["bias"],
                                  sd["model.22.cv2.0.2.bias"].numpy())


def test_fixture_forward_matches_the_port():
    tmodel = _fixture("yolov8n", 4)
    sd = ultralytics_state_dict(tmodel)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref_maps = [o.permute(0, 2, 3, 1) for o in tmodel(x.permute(0, 3, 1, 2))]
        ref_feats = tmodel.backbone_features(x.permute(0, 3, 1, 2))
    yolo = load_pretrained_into(YOLOv8("yolov8n", 4, device="cpu"), sd)
    mcaq = load_pretrained_into(MCAQYOLO(num_classes=4, device="cpu"), sd)
    with torch.no_grad():
        maps_y = yolo(x)
        maps_m, _ = mcaq(x, quantize=False)
        feats = mcaq.backbone_features(x)
    for a, b, c in zip(maps_y, maps_m, ref_maps):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=2e-4, atol=2e-4)
    for a, b in zip(feats, ref_feats):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    # the MCAQ parts keep their values: only backbone, neck and head moved
    fresh = to_jax_variables(MCAQYOLO(num_classes=4, device="cpu"))["params"]
    after = to_jax_variables(mcaq)["params"]
    for k in ("bit_mapper", "complexity_analyzer", "quantizer_p3"):
        for (pa, a), (_, b) in zip(_leaves(after[k]), _leaves(fresh[k])):
            np.testing.assert_array_equal(a, b, err_msg=f"{k}/{'/'.join(pa)}")
