"""
Device-resident data pipeline (port of
`mcaq_yolo_tpu/data/device_pipeline.py:65-392`): the letterboxed image bank
lives on the device, uploaded once in `chunk_bytes` chunks, and each batch
ships only an augmentation plan (a few hundred bytes) plus its padded
labels; mosaic, HSV, affine and flip run on the device from the plan.  It
needs no cv2, so it is the way to train with the full augmentation on a
host without cv2.

Semantics of `YOLODataset.get_item`, exactly for labels and block copies:

  mosaic  for same-size letterboxed sources the host mosaic is a fixed
          four-quarter composite (its random center cancels), so the device
          copies blocks: bitwise equal to the host.
  hsv     cv2's HSV conventions (H in [0, 180)) in float32; the host's
          intermediate uint8 rounding makes the two differ by a few levels.
  affine  scale + translate as separable bilinear resampling: a banded row
          weight matrix and a column weight matrix per image, applied as
          two batched products (`torch.einsum`); source mass outside the
          image goes to cv2's border value 114.
  hflip   exact.

Labels come from the host formulas, on the host (NumPy over at most
max_boxes rows), drawn from the loader's generator in the reference's
order.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .dataset import YOLODataset

_HSV_GAIN_SCALE = np.array([0.015, 0.7, 0.4], np.float32)


# ---------------------------------------------------------------------------
# Device-side pixel work
# ---------------------------------------------------------------------------


def _rgb_to_hsv_cv2(img: torch.Tensor):
    """float32 RGB in [0, 255] -> cv2-convention H in [0, 180), S, V in
    [0, 255]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    m = torch.minimum(torch.minimum(r, g), b)
    d = v - m
    safe_d = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(v == r, 30.0 * (g - b) / safe_d,
                    torch.where(v == g, 60.0 + 30.0 * (b - r) / safe_d,
                                120.0 + 30.0 * (r - g) / safe_d))
    h = torch.where(d > 0, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v > 0, d / torch.where(v > 0, v, torch.ones_like(v)) * 255.0,
                    torch.zeros_like(v))
    return h, s, v


def _select(i: torch.Tensor, choices, default: torch.Tensor) -> torch.Tensor:
    """jnp.select([i == 0, ..., i == 4], choices, default)."""
    out = default
    for k in range(len(choices) - 1, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def _hsv_to_rgb_cv2(h, s, v) -> torch.Tensor:
    """Inverse of `_rgb_to_hsv_cv2` (cv2's HSV2RGB convention)."""
    h60 = h / 30.0
    i = torch.floor(h60)
    f = h60 - i
    sn = s / 255.0
    p = v * (1.0 - sn)
    q = v * (1.0 - sn * f)
    t = v * (1.0 - sn * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, [v, q, p, p, t], v)
    g = _select(i, [t, v, v, q, p], p)
    b = _select(i, [p, p, t, v, v], q)
    return torch.stack([r, g, b], dim=-1)


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """img (..., S, S, 3) float32 in [0, 255]; gains (..., 3): H times g0
    modulo 180, S and V scaled and clipped to [0, 255]."""
    h, s, v = _rgb_to_hsv_cv2(img)
    g = gains[..., None, None, :]
    h = torch.remainder(h * g[..., 0], 180.0)
    s = torch.clamp(s * g[..., 1], 0.0, 255.0)
    v = torch.clamp(v * g[..., 2], 0.0, 255.0)
    return _hsv_to_rgb_cv2(h, s, v)


def _bilinear_weights(src: torch.Tensor, size: int) -> torch.Tensor:
    """src (B, S) fractional source coordinates -> (B, S, size) banded
    weights W[b, o, j] = max(0, 1 - |src[b, o] - j|)."""
    j = torch.arange(size, dtype=torch.float32, device=src.device).reshape(1, 1, size)
    return torch.clamp(1.0 - torch.abs(src[..., None] - j), 0.0, 1.0)


def affine(img: torch.Tensor, s: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
           border: float = 114.0) -> torch.Tensor:
    """Scale + translate warp of img (B, S, S, 3) float32 with
    cv2.warpAffine(INTER_LINEAR, borderValue=border) semantics for
    M = [[s, 0, c - s c + tx], [0, s, c - s c + ty]], c = S / 2."""
    S = img.shape[1]
    c = S / 2.0
    out_pos = torch.arange(S, dtype=torch.float32, device=img.device)[None, :]
    sx = (out_pos - (c - s[:, None] * c + tx[:, None])) / s[:, None]
    sy = (out_pos - (c - s[:, None] * c + ty[:, None])) / s[:, None]
    wr = _bilinear_weights(sy, S)  # output row <- source row
    wc = _bilinear_weights(sx, S)  # output column <- source column
    tmp = torch.einsum("byi,bijc->byjc", wr, img)
    sampled = torch.einsum("bxj,byjc->byxc", wc, tmp)
    mass = wr.sum(-1)[:, :, None] * wc.sum(-1)[:, None, :]
    return sampled + border * (1.0 - mass)[..., None]


def augment_batch(bank: torch.Tensor, idx4, mosaic_on, hsv_on, hsv_gains, s, tx, ty,
                  flip) -> torch.Tensor:
    """The augmented uint8 batch from the bank and a plan (tensors on the
    bank's device): idx4 (B, 4) int64, mosaic_on and flip (B,) bool, hsv_on
    (B, 4) bool, hsv_gains (B, 4, 3), s, tx, ty (B,) float32."""
    S = bank.shape[1]
    h = S // 2
    tiles = bank[idx4].to(torch.float32)  # (B, 4, S, S, 3)
    tiles = torch.where(hsv_on[..., None, None, None], hsv_jitter(tiles, hsv_gains), tiles)
    # the fixed four-quarter mosaic: crop quadrant (Y, X) takes the
    # mirror-opposite quarter of tile 2Y + X
    top = torch.cat([tiles[:, 0, h:, h:], tiles[:, 1, h:, :h]], dim=2)
    bot = torch.cat([tiles[:, 2, :h, h:], tiles[:, 3, :h, :h]], dim=2)
    mosaic = torch.cat([top, bot], dim=1)
    img = torch.where(mosaic_on[:, None, None, None], mosaic, tiles[:, 0])
    img = affine(img, s, tx, ty)
    img = torch.where(flip[:, None, None, None], torch.flip(img, dims=[2]), img)
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Host-side plan + labels
# ---------------------------------------------------------------------------


class DevicePipeline:
    """A YOLODataset's clean letterboxed images in device memory, serving
    batches whose "image" is already a device tensor (uint8 (B, S, S, 3));
    the labels stay host NumPy."""

    def __init__(self, dataset: YOLODataset, chunk_bytes: int = 64 << 20,
                 device: DeviceLike = None):
        if dataset.img_size % 2 != 0:
            raise ValueError("DevicePipeline requires an even img_size")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.S = dataset.img_size
        self.max_boxes = dataset.max_boxes

        # the clean bank and labels through the dataset's own loader with
        # augmentation off, so they cannot drift from the host path
        was_aug = dataset.augment
        dataset.augment = False
        try:
            imgs, self.boxes, self.classes = [], [], []
            for i in range(len(dataset)):
                im, bx, cl, _, _, _ = dataset._load_single(i)
                imgs.append(im)
                self.boxes.append(np.asarray(bx, np.float32))
                self.classes.append(np.asarray(cl, np.int32))
        finally:
            dataset.augment = was_aug
        stack = np.stack(imgs)
        per = max(1, int(chunk_bytes) // max(1, stack[0].nbytes))
        parts = [torch.from_numpy(stack[i:i + per]).to(self.device)
                 for i in range(0, len(stack), per)]
        self.bank = parts[0] if len(parts) == 1 else torch.cat(parts)

    def __len__(self) -> int:
        return len(self.dataset)

    # -- host label transforms (the dataset's formulas) --------------------

    def _mosaic_labels(self, idxs: Sequence[int]):
        S, h = self.S, self.S // 2
        off = [(-(S - h), -(S - h)), (h, -(S - h)), (-(S - h), h), (h, h)]
        bs, cs = [], []
        for (dx, dy), j in zip(off, idxs):
            b = self.boxes[j]
            if len(b):
                b = b.copy()
                b[:, [0, 2]] += dx
                b[:, [1, 3]] += dy
                bs.append(b)
                cs.append(self.classes[j])
        if not bs:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        b = np.concatenate(bs)
        c = np.concatenate(cs)
        b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, S)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, S)
        keep = ((b[:, 2] - b[:, 0]) >= 2.0) & ((b[:, 3] - b[:, 1]) >= 2.0)
        return b[keep], c[keep]

    def _affine_labels(self, b, c, s, tx, ty):
        S = self.S
        if not len(b):
            return b, c
        cc = S / 2.0
        m02 = cc - s * cc + tx
        m12 = cc - s * cc + ty
        b = b.astype(np.float32).copy()
        b[:, [0, 2]] = np.clip(b[:, [0, 2]] * s + m02, 0, S)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]] * s + m12, 0, S)
        keep = ((b[:, 2] - b[:, 0]) >= 2.0) & ((b[:, 3] - b[:, 1]) >= 2.0)
        return b[keep], c[keep]

    # -- batch assembly ----------------------------------------------------

    def _plan_batch(self, chunk: Sequence[int], rng: np.random.Generator, augment: bool):
        ds, B, S = self.dataset, len(chunk), self.S
        idx4 = np.tile(np.asarray(chunk, np.int64)[:, None], (1, 4))
        mosaic_on = np.zeros(B, bool)
        hsv_on = np.zeros((B, 4), bool)
        hsv_gains = np.ones((B, 4, 3), np.float32)
        s = np.ones(B, np.float32)
        tx = np.zeros(B, np.float32)
        ty = np.zeros(B, np.float32)
        flip = np.zeros(B, bool)
        gtb = np.zeros((B, self.max_boxes, 4), np.float32)
        gtc = np.zeros((B, self.max_boxes), np.int32)
        gtm = np.zeros((B, self.max_boxes), bool)

        do_affine = augment and (ds.scale_jitter > 0 or ds.translate > 0)
        for b, j in enumerate(chunk):
            if augment and rng.random() < ds.mosaic_p:
                mosaic_on[b] = True
                idx4[b, 1:] = rng.integers(0, len(ds), 3)
                boxes, classes = self._mosaic_labels(idx4[b])
                ntile = 4
            else:
                boxes, classes = self.boxes[j].copy(), self.classes[j]
                ntile = 1
            for t in range(ntile):
                if augment and rng.random() < ds.hsv_p:
                    hsv_on[b, t] = True
                    hsv_gains[b, t] = 1.0 + rng.uniform(-1, 1, 3) * _HSV_GAIN_SCALE
            if do_affine:
                s[b] = 1.0 + float(rng.uniform(-ds.scale_jitter, ds.scale_jitter))
                tx[b] = float(rng.uniform(-ds.translate, ds.translate)) * S
                ty[b] = float(rng.uniform(-ds.translate, ds.translate)) * S
                boxes, classes = self._affine_labels(boxes, classes, s[b], tx[b], ty[b])
            if augment and rng.random() < ds.hflip_p:
                flip[b] = True
                if len(boxes):
                    x1 = S - boxes[:, 2]
                    x2 = S - boxes[:, 0]
                    boxes[:, 0], boxes[:, 2] = x1.copy(), x2.copy()
            n = min(len(boxes), self.max_boxes)
            gtb[b, :n] = boxes[:n]
            gtc[b, :n] = classes[:n]
            gtm[b, :n] = True

        plan = (idx4, mosaic_on, hsv_on, hsv_gains, s, tx, ty, flip)
        labels = {"gt_boxes": gtb, "gt_classes": gtc, "gt_mask": gtm,
                  "paths": [ds.img_files[j] for j in chunk]}
        return plan, labels

    def batch(self, chunk: Sequence[int], rng: np.random.Generator,
              augment: Optional[bool] = None) -> Dict:
        augment = self.dataset.augment if augment is None else augment
        plan, labels = self._plan_batch(chunk, rng, augment)
        if augment:
            image = augment_batch(self.bank, *(torch.from_numpy(a).to(self.device)
                                               for a in plan))
        else:
            image = self.bank[torch.from_numpy(plan[0][:, 0]).to(self.device)]
        return {"image": image, **labels}

    def loader(self, batch_size: int, shuffle: bool = False,
               indices: Optional[Sequence[int]] = None, seed: int = 0,
               drop_last: bool = True, augment: Optional[bool] = None) -> "DeviceDataLoader":
        return DeviceDataLoader(self, batch_size, shuffle=shuffle, indices=indices,
                                seed=seed, drop_last=drop_last, augment=augment)


class DeviceDataLoader:
    """The host DataLoader's batching (index subset, shuffle, drop_last)
    over a DevicePipeline, yielding device-resident images."""

    def __init__(self, pipe: DevicePipeline, batch_size: int, shuffle: bool = False,
                 indices: Optional[Sequence[int]] = None, seed: int = 0,
                 drop_last: bool = True, augment: Optional[bool] = None):
        self.pipe = pipe
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.indices = list(indices) if indices is not None else list(range(len(pipe)))
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.augment = augment

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        order = list(self.indices)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if self.drop_last else len(order)
        if end == 0 and not self.drop_last:
            end = len(order)
        for i in range(0, end, bs):
            chunk = order[i:i + bs]
            if self.drop_last and len(chunk) < bs:
                break
            yield self.pipe.batch(chunk, self.rng, augment=self.augment)
