"""
Inputs made from the seed, on the card: natural-statistics scenes, the
serving size mix, letterboxed frames and synthetic training batches.

Copies, rewritten to run as a few large device calls from one
`torch.Generator`:
  * the eight serving sizes of `chip_smoke.py:serving_images` (commit 00c80e2);
  * the three natural-statistics families of `mcaq_yolo_tpu_torch/data/
    dataset.py:make_natural_statistics_images` (00c80e2): 1/f^beta noise,
    multi-octave value noise, and a mixed scene of both with smooth blobs;
  * the boxes of `mcaq_yolo_tpu_torch/data/synthetic.py:synthetic_batches`
    (00c80e2): 5-30 boxes an image, each side 4-40% of the image, filled
    with its class's colour, over a background scaled to 0..95.
Every seed gets the same sizes and counts, in another order; only the
pixels, the boxes and the order move with it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

SERVING_SIZES = [(480, 640), (640, 480), (720, 1280), (500, 500), (360, 640), (640, 640),
                 (427, 640), (1024, 768)]
PAD_VALUE = 114


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator for one purpose (`stream`) of a run: seeds above 2**62
    fold into range, so any whole number the driver passes is taken."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 62))


def _norm01(a: torch.Tensor) -> torch.Tensor:
    lo = a.amin(dim=(-2, -1), keepdim=True)
    hi = a.amax(dim=(-2, -1), keepdim=True)
    return (a - lo) / (hi - lo + 1e-9)


def _u(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def pink(g, n: int, h: int, w: int, beta: torch.Tensor, device) -> torch.Tensor:
    """n maps of 1/f^beta noise in [0, 1] (random phase)."""
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f[None] ** (-beta[:, None, None])
    phase = 2 * math.pi * torch.rand((n,) + f.shape, generator=g, device=device)
    return _norm01(torch.fft.irfft2(torch.polar(amp, phase), s=(h, w)))


def fractal(g, n: int, h: int, w: int, device, octaves: int = 6) -> torch.Tensor:
    """n maps of value noise: octaves of bilinearly upsampled random grids,
    weight 0.55^o."""
    out = torch.zeros((n, h, w), device=device)
    for o in range(octaves):
        k = 1 << (o + 2)
        if k > min(h, w):
            break
        coarse = torch.rand((n, 1, k, k), generator=g, device=device)
        out += (0.55 ** o) * F.interpolate(coarse, size=(h, w), mode="bilinear",
                                           align_corners=True)[:, 0]
    return _norm01(out)


def mixed(g, n: int, h: int, w: int, device) -> torch.Tensor:
    """Pink background, 2-4 smooth blobs and one fine-texture patch."""
    base = 0.6 * pink(g, n, h, w, _u(g, n, 1.0, 1.3, device), device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    for k in range(4):
        on = (k < 2) | (torch.rand(n, generator=g, device=device) < 0.5)
        cy, cx = _u(g, n, 0.15, 0.85, device), _u(g, n, 0.15, 0.85, device)
        sig, amp = _u(g, n, 0.05, 0.18, device), _u(g, n, 0.3, 0.7, device)
        d2 = (yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2
        blob = torch.exp(-d2 / (2 * sig[:, None, None] ** 2))
        base += (on.float() * amp)[:, None, None] * blob
    tex = fractal(g, n, h, w, device, octaves=7)
    py, px = _u(g, n, 0, 0.5, device), _u(g, n, 0, 0.5, device)
    ph, pw = _u(g, n, 0.2, 0.5, device), _u(g, n, 0.2, 0.5, device)
    inside = ((yy[None] >= py[:, None, None]) & (yy[None] < (py + ph)[:, None, None])
              & (xx[None] >= px[:, None, None]) & (xx[None] < (px + pw)[:, None, None]))
    return _norm01(base + 0.5 * tex * inside)


def scenes(g, n: int, h: int, w: int, device) -> torch.Tensor:
    """n natural-statistics RGB scenes (n, h, w, 3) uint8, the three
    families in turn."""
    fam = [i % 3 for i in range(n)]
    gray = torch.empty((n, h, w), device=device)
    for f, make in enumerate((lambda m: pink(g, m, h, w, _u(g, m, 0.9, 1.4, device), device),
                              lambda m: fractal(g, m, h, w, device),
                              lambda m: mixed(g, m, h, w, device))):
        idx = [i for i in range(n) if fam[i] == f]
        if idx:
            gray[idx] = make(len(idx))
    gain = _u(g, 3 * n, 0.7, 1.0, device).reshape(n, 1, 1, 3)
    bias = _u(g, 3 * n, 0.0, 0.25, device).reshape(n, 1, 1, 3)
    img = gray[..., None] * gain + bias
    img = img + 0.01 * torch.randn(img.shape, generator=g, device=device)
    return (img.clamp(0, 1) * 255).to(torch.uint8)


def letterbox_params(h: int, w: int, size: int) -> Tuple[float, int, int, int, int]:
    """(scale, new h, new w, pad x, pad y) of the port's letterbox rule."""
    s = min(size / h, size / w)
    nh, nw = int(round(h * s)), int(round(w * s))
    return s, nh, nw, (size - nw) // 2, (size - nh) // 2


def letterbox(img: torch.Tensor, size: int) -> torch.Tensor:
    """(n, h, w, 3) uint8 -> (n, size, size, 3) uint8: bilinear resize with
    half-pixel centres (no antialiasing), centred, padded with 114."""
    n, h, w, _ = img.shape
    _, nh, nw, px, py = letterbox_params(h, w, size)
    x = img.permute(0, 3, 1, 2).to(torch.float32)
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    out = torch.full((n, 3, size, size), float(PAD_VALUE), device=img.device)
    out[:, :, py:py + nh, px:px + nw] = x
    return out.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def unletterbox(boxes: torch.Tensor, h: int, w: int, size: int) -> torch.Tensor:
    s, _, _, px, py = letterbox_params(h, w, size)
    b = boxes.clone()
    b[..., [0, 2]] = ((b[..., [0, 2]] - px) / s).clamp(0, w)
    b[..., [1, 3]] = ((b[..., [1, 3]] - py) / s).clamp(0, h)
    return b


def size_order(g, count: int, device) -> List[Tuple[int, int]]:
    """`count` sizes from the serving mix, each size count/8 times (count a
    multiple of 8), in an order drawn from the seed."""
    perm = torch.randperm(count, generator=g, device=device).tolist()
    return [SERVING_SIZES[i % len(SERVING_SIZES)] for i in perm]


def serving_frames(g, sizes: Sequence[Tuple[int, int]], device) -> List[torch.Tensor]:
    """One scene per size, made in groups of equal size: (h, w, 3) uint8."""
    out: List[torch.Tensor] = [None] * len(sizes)
    for hw in sorted(set(sizes)):
        idx = [i for i, s in enumerate(sizes) if s == hw]
        batch = scenes(g, len(idx), hw[0], hw[1], device)
        for j, i in enumerate(idx):
            out[i] = batch[j]
    return out


def letterboxed_batches(seed: int, n_batches: int, batch: int, size: int,
                        device) -> List[torch.Tensor]:
    """`n_batches` batches (batch, size, size, 3) uint8 of scenes of the
    serving sizes, letterboxed on the card."""
    g = generator(seed, device, stream=1)
    sizes = size_order(g, n_batches * batch, device)
    frames = serving_frames(g, sizes, device)
    boxed = [None] * len(frames)
    for hw in set(sizes):
        idx = [i for i, s in enumerate(sizes) if s == hw]
        lb = letterbox(torch.stack([frames[i] for i in idx]), size)
        for j, i in enumerate(idx):
            boxed[i] = lb[j]
    return [torch.stack(boxed[k * batch:(k + 1) * batch]) for k in range(n_batches)]


def train_batches(seed: int, n_batches: int, batch: int, size: int, nc: int,
                  max_boxes: int, boxes: Tuple[int, int], device) -> List[Dict[str, torch.Tensor]]:
    """Synthetic detection batches: backgrounds of natural statistics scaled
    to 0..95, `boxes` (lo, hi) rectangles an image, sides 4-40% of the
    image, each filled with 96 + (37 c + 53 k) mod 160 in channel k."""
    g = generator(seed, device, stream=2)
    lo, hi = boxes
    out = []
    for _ in range(n_batches):
        img = (scenes(g, batch, size, size, device).to(torch.int32) * 96 // 256)
        n = torch.randint(lo, hi + 1, (batch,), generator=g, device=device).clamp(max=max_boxes)
        wh = _u(g, batch * max_boxes * 2, 0.04, 0.4, device).reshape(batch, max_boxes, 2) * size
        xy = torch.rand((batch, max_boxes, 2), generator=g, device=device) * (size - wh)
        cls = torch.randint(0, nc, (batch, max_boxes), generator=g, device=device)
        mask = torch.arange(max_boxes, device=device)[None] < n[:, None]
        bx = torch.cat([xy, xy + wh], -1) * mask[..., None]
        ib = bx.to(torch.int64)
        yy = torch.arange(size, device=device)
        colour = 96 + (cls[..., None] * 37 + torch.arange(3, device=device) * 53) % 160
        for j in range(max_boxes):  # later boxes paint over earlier ones
            inside = ((yy[None, :, None] >= ib[:, j, 1, None, None])
                      & (yy[None, :, None] < ib[:, j, 3, None, None])
                      & (yy[None, None, :] >= ib[:, j, 0, None, None])
                      & (yy[None, None, :] < ib[:, j, 2, None, None])
                      & mask[:, j, None, None])
            img = torch.where(inside[..., None], colour[:, j, None, None, :], img)
        out.append({"image": img.to(torch.uint8).contiguous(), "gt_boxes": bx.contiguous(),
                    "gt_classes": cls.to(torch.int32), "gt_mask": mask})
    return out
