"""
Weights made from the seed on the card, in the program's state-dict layout,
and the spread that gives random weights real work to do.

`init_` draws every parameter of a reference model (`reference.mcaq.MCAQYOLO`
or `reference.network.YOLOv8`) in a few large calls from one generator,
with the program's initializers in distribution (lecun-normal convolutions
and Dense kernels, Detect biases 1.0 and the class prior, the soft mask's
near-zero output layer biased to keep, the monotone mapper's softplus
kernels), and sets every buffer.

`spread_` is `chip_smoke.py:spread_model` at commit 00c80e2, acting on the
reference: the mapper's BatchNorm statistics taken from the model's own
complexity on frames of the cell, its output layer steepened, so tiles
spread over 2-8 bits; each class output scaled and biased so that about
24 / 12 / 4 anchors an image and scale clear conf 0.25, so decode + NMS
suppresses for real, lowered until no frame of the spread has more than
half the pool above the gate (the pool then never saturates there).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .gen import generator
from .reference import mcaq as rm
from .reference import network as rn

TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to +-2


def _fans(shape):
    if len(shape) == 2:  # Linear (out, in)
        return shape[1], shape[0]
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


@torch.no_grad()
def build(cls, device, *args, **kwargs) -> nn.Module:
    """A model of `cls` with storage on `device`, every leaf still unset."""
    with torch.device("meta"):
        model = cls(*args, **kwargs)
    return model.to_empty(device=device)


@torch.no_grad()
def init_(model: nn.Module, seed: int, nc: int) -> nn.Module:
    """Every parameter and buffer of `model` from `seed` (module docstring)."""
    device = next(model.parameters()).device
    g = generator(seed, device, stream=3)
    params = dict(model.named_parameters())
    lecun = [n for n, p in params.items() if p.dim() > 1 and not n.endswith("theta")
             and not n.endswith("Dense_2.weight") and not n.endswith("soft_mask.Conv_1.weight")]
    total = sum(params[n].numel() for n in lecun)
    draw = torch.empty(total, device=device)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=g)
    at = 0
    for n in lecun:
        p = params[n]
        std = 1.0 / math.sqrt(_fans(p.shape)[0]) / TRUNC_STD
        p.copy_(draw[at:at + p.numel()].view_as(p) * std)
        at += p.numel()
    for n, p in params.items():
        if n in lecun:
            continue
        if n.endswith("theta"):  # MonotoneDense: softplus(theta) = max(|xavier(0.5)|, 1e-4)
            fi, fo = p.shape
            lim = math.sqrt(3.0 * 0.25 / ((fi + fo) / 2.0))
            w = (torch.rand(p.shape, generator=g, device=device) * 2 - 1).abs() * lim
            p.copy_(torch.log(torch.expm1(w.clamp(min=1e-4))))
        elif n.endswith("Dense_2.weight"):  # complexity MLP head: xavier uniform, gain 3
            fi, fo = _fans(p.shape)
            lim = math.sqrt(3.0 * 9.0 / ((fi + fo) / 2.0))
            p.copy_((torch.rand(p.shape, generator=g, device=device) * 2 - 1) * lim)
        elif n.endswith("soft_mask.Conv_1.weight"):
            p.copy_(1e-3 * torch.randn(p.shape, generator=g, device=device))
        elif n.endswith("soft_mask.Conv_1.bias"):
            p.copy_(torch.tensor([4.0, 0.0], device=device))
        elif ".box" in "." + n and n.endswith("_out.bias"):
            p.fill_(1.0)
        elif "cls" in n and n.endswith("_out.bias"):
            i = int(n.split("cls")[1][0])
            prior = 5.0 / nc / ((640 / rn.STRIDES[i]) ** 2)
            p.fill_(-math.log((1.0 - prior) / prior))
        elif "MonotoneDense" in n:
            p.fill_(0.1)
        elif n.endswith(".weight"):  # BatchNorm / LayerNorm scales
            p.fill_(1.0)
        else:  # every other bias
            p.zero_()
    for n, b in model.named_buffers():
        if n.endswith("running_var"):
            b.fill_(1.0)
        elif n.endswith("feature_weights"):
            b.fill_(0.2)
        else:  # running means, quantizer ranges, counters, flags
            b.zero_()
    return model


def _mapper_inputs(c: torch.Tensor) -> torch.Tensor:
    return torch.cat([c, c ** 2, torch.log1p(c)], -1)


@torch.no_grad()
def spread_(model: rm.MCAQYOLO, frames: torch.Tensor, anchors_per_scale=(24, 12, 4),
            max_per_frame: int = 128) -> Dict[str, float]:
    """In place (module docstring); `frames` (n, S, S, 3) uint8.  The
    anchor targets are lowered (x 0.8 a round) until no frame has more than
    `max_per_frame` anchors above the gate, half the NMS pool, so the pool
    does not saturate.  Returns what it set."""
    feats = model.backbone(rn.to_nchw(frames))
    c = torch.cat([model.complexity_analyzer(f.permute(0, 2, 3, 1)).reshape(-1)
                   for f in feats]).clamp(0.0, 1.0)[:, None]
    mapper = model.bit_mapper
    h = _mapper_inputs(c)
    for i in range(mapper.n_hidden):
        h = mapper.dense(i)(h)
        bn = getattr(mapper, f"BatchNorm_{i}")
        bn.running_mean.copy_(h.mean(0))
        bn.running_var.copy_(h.var(0, unbiased=False))
        h = F.leaky_relu(bn(h), 0.05)
    last = mapper.dense(mapper.n_hidden)
    last.theta.copy_(torch.log(torch.expm1(F.softplus(last.theta) * 50.0)))
    pyramid = model.neck(*[model.transform(f, i, 1.0)[0] for i, f in enumerate(feats)])
    head = model.head
    best = []
    for i, f in enumerate(pyramid):
        hcls = getattr(head, f"cls{i}_conv1")(getattr(head, f"cls{i}_conv0")(f))
        out = getattr(head, f"cls{i}_out")
        logits = F.conv2d(hcls, out.weight)
        out.weight.div_(logits.std())
        best.append((logits / logits.std()).amax(1).flatten(1))
    # lower the targets until no frame has more than half the pool above the gate
    scale = 1.0
    while True:
        qs = [torch.quantile(b.flatten(), 1.0 - k * scale / b.shape[1])
              for b, k in zip(best, anchors_per_scale)]
        per_frame = sum((b > q).sum(1) for b, q in zip(best, qs))
        if int(per_frame.max()) <= max_per_frame or scale < 0.01:
            break
        scale *= 0.8
    biases: List[float] = []
    for i, q in enumerate(qs):
        bias = float(torch.logit(torch.tensor(0.25)) - q)
        getattr(head, f"cls{i}_out").bias.fill_(bias)
        biases.append(bias)
    return {"mapper_steepening": 50.0, "class_bias": biases, "target_scale": scale,
            "above_gate_per_frame_mean": float(per_frame.float().mean()),
            "above_gate_per_frame_max": int(per_frame.max())}
