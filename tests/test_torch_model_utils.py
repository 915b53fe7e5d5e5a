"""The port's model utilities (`mcaq_yolo_tpu_torch/utils/model_utils.py`)
against the JAX package's `utils/model_utils.py` on the CPU, on one seeded
MCAQ-YOLOv8n (nc 4) and its flax tree.

Contracts: parameter counts (total and per top-level module) and size
equal; weight fake-quantization bitwise equal leaf by leaf (per channel
and global; the port quantizes along its own output axis: dim 0 of OIHW /
Linear, the last of MonotoneDense's theta); the tolerant restore equal to
the reference's, with the same warnings; activation ranges equal;
profile_model's arithmetic."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mcaq_yolo_tpu.utils import model_utils as jmu
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.weights_io import load_jax_variables, to_jax_variables
from mcaq_yolo_tpu_torch.utils import model_utils as pmu


@pytest.fixture(scope="module")
def model():
    return MCAQYOLO(num_classes=4, device="cpu", seed=2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_counts_and_size_equal_jax(model):
    params = to_jax_variables(model)["params"]
    assert pmu.count_parameters(model) == jmu.count_parameters(params)
    for bits in (32.0, 4.0):
        assert pmu.get_model_size(model, bits) == jmu.get_model_size(params, bits)


@pytest.mark.parametrize("per_channel", [True, False])
def test_weight_quantization_bitwise(model, per_channel):
    """Eagerly on the reference's side (a jitted XLA program contracts
    and reorders the arithmetic), on modules of every layout: Conv (the
    soft masks), Dense (complexity MLP) and MonotoneDense (mapper)."""
    params = to_jax_variables(model)["params"]
    some = {k: params[k] for k in ("complexity_analyzer", "bit_mapper", "quantizer_p3",
                                   "quantizer_p5")}
    ref = jmu.apply_weight_quantization(jax.tree_util.tree_map(jnp.asarray, some), bits=4,
                                        per_channel=per_channel)
    port = MCAQYOLO(num_classes=4, device="cpu", seed=2)
    pmu.apply_weight_quantization(port, bits=4, per_channel=per_channel)
    got, before = dict(_leaves(to_jax_variables(port)["params"])), dict(_leaves(some))
    changed = 0
    for k, v in _leaves(ref):
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
        changed += int(not np.array_equal(v, before[k]))
    assert changed >= 10  # every kernel moved; biases and norms did not


def test_tolerant_restore_equals_jax(model, tmp_path):
    variables = to_jax_variables(model)
    ckpt = jax.tree_util.tree_map(np.asarray, variables)
    del ckpt["params"]["head"]["box0_out"]["bias"]                       # missing
    ckpt["params"]["head"]["cls0_out"]["bias"] = np.zeros(7, np.float32)  # misshapen
    ckpt["batch_stats"]["backbone"]["ConvBnSiLU_0"]["BatchNorm_0"]["mean"] += 1.0
    ckpt["opt_state"] = {"count": np.asarray(3)}                          # ignored
    path = tmp_path / "m.ckpt"
    path.write_bytes(serialization.msgpack_serialize(ckpt))
    template = to_jax_variables(MCAQYOLO(num_classes=4, device="cpu", seed=9))
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        ours = pmu.tolerant_restore(template, path)
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref = jmu.tolerant_restore(jax.tree_util.tree_map(jnp.asarray, template), str(path))
    assert sorted(str(m.message) for m in w_port) == sorted(str(m.message) for m in w_ref)
    assert len(w_port) == 2
    assert ours.keys() == ref.keys()
    for c in ours:
        a, b = dict(_leaves(ours[c])), dict(_leaves(ref[c]))
        assert a.keys() == b.keys(), c
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{c}/{'/'.join(k)}")
    restored = MCAQYOLO(num_classes=4, device="cpu", seed=9)
    load_jax_variables(restored, {c: v for c, v in ours.items() if v})
    bn = restored.backbone.ConvBnSiLU_0.BatchNorm_0.running_mean
    np.testing.assert_array_equal(bn.numpy(), model.backbone.ConvBnSiLU_0.BatchNorm_0
                                  .running_mean.numpy() + np.float32(1.0))


def test_activation_ranges_equal_jax():
    rng = np.random.default_rng(3)
    batches = [rng.normal(0, 1 + i, (2, 6, 6, 3)).astype(np.float32) for i in range(4)]
    ours = pmu.calibrate_activation_ranges(
        lambda b: {"a": torch.from_numpy(b), "b": torch.from_numpy(b * 2)}, batches, 3)
    ref = jmu.calibrate_activation_ranges(
        lambda b: {"a": jnp.asarray(b), "b": jnp.asarray(b * 2)}, batches, 3)
    assert ours == ref
    listed = pmu.calibrate_activation_ranges(lambda b: [torch.from_numpy(b)], batches)
    assert set(listed) == {"feat0"}


def test_profile_model_on_the_cpu():
    x = torch.ones((4, 16))
    stats = pmu.profile_model(lambda t: torch.tanh(t) @ t.T, x, num_iters=3, warmup=1)
    assert stats["total_s"] > 0 and stats["iter_ms"] > 0
    assert np.isclose(stats["fps"], 3 * 4 / stats["total_s"])
