"""
Plain float32 RT-DETR-L (HGNetv2-L backbone, hybrid encoder with AIFI and
the CCFM of RepC3 blocks, RTDETRDecoder with multi-scale deformable
attention) with the MCAQ model on its three taps and the NMS-free
post-process: the reference of cell `rtdetr-l-serve-bs256` and of the
repository's CPU tests of the port's RT-DETR.

Written from Ultralytics' `ultralytics/cfg/models/rt-detr/rtdetr-l.yaml` and
the modules it names (`ultralytics/nn/modules/block.py`: HGStem, HGBlock,
RepC3; `conv.py`: Conv, DWConv, LightConv, RepConv; `transformer.py`: AIFI,
MSDeformAttn, DeformableTransformerDecoderLayer, MLP; `head.py`:
RTDETRDecoder) and `ultralytics/models/rtdetr/predict.py`, in the
state-dict layout of `mcaq_yolo_tpu_torch/models/{layers,rtdetr}.py`, so
that a state dict made here loads into the measured program unchanged.
Nothing here imports the program.  The MCAQ model puts `reference.mcaq`'s
analyzer, bit mapper and quantizers on yaml layers 3, 7 and 9 (C3, C4, C5).

Departures from Ultralytics' code: submodules carry the port's names
(`input_proj_{i}` for `input_proj[i]`, `proj5` / `proj4` / `proj3` for yaml
layers 10, 14, 19, `lateral5` / `lateral4` for 12, 17, `down3` / `down4`
for 22, 25, `enc_output` + `enc_norm` for the `enc_output` Sequential);
`nn.MultiheadAttention`'s packed in-projection is four Linears
(`q_proj`, `k_proj`, `v_proj`, `out_proj`) and its attention is written out;
BatchNorm's eps is 1e-3 everywhere (Ultralytics' `initialize_weights`); the
denoising embedding (training only) is absent; the decoder is the eval
path (no denoising queries, the score head of the last layer only); the
query selection is a stable descending sort (ties to the lower anchor
index) where Ultralytics calls `torch.topk`; `select_queries` sorts the kept
detections by score (ties to the lower query index) where Ultralytics keeps
the query order, and scales the boxes by the input's side (the port's
letterbox) where Ultralytics scales by the original image.  The equations
are Ultralytics'.

Precision: every convolution and linear layer takes `reference.network`'s
`precision` ('fp32', or 'fp8' for the control, set by `set_precision`); the
attentions' two products follow their `q_proj` (float8 operands in the
control); the deformable sampling computes its locations in float32, or in
the control rounds them to bfloat16, one precision below the program's
float32 locations.  The MCAQ math runs in float32 without TF32 (the caller
sets it: `reference.mcaq.float32_products`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import mcaq as rm
from . import network as rn
from .yolo11 import Conv

HIDDEN, HEADS, FFN, LEVELS, POINTS, QUERIES, DECODER_LAYERS = 256, 8, 1024, 3, 4, 300, 6


def variant_channels(variant: str = "rtdetr-l") -> Tuple[int, int, int]:
    """(C3, C4, C5): the outputs of yaml layers 3, 7 and 9."""
    if variant != "rtdetr-l":
        raise ValueError(f"unknown variant {variant!r}")
    return 512, 1024, 2048


class Linear(nn.Linear):
    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return F.linear(rn.fp8_round(x), rn.fp8_round(self.weight), self.bias)
        return super().forward(x)


class ConvBn(nn.Module):
    """Ultralytics' Conv: conv (no bias, `g` groups, padding `p`, default
    k // 2), BatchNorm, then `act`: 'silu', 'relu' or None."""

    def __init__(self, c_in, c_out, k=1, s=1, act="silu", g=1, p=None):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, k, s, k // 2 if p is None else p, groups=g, bias=False)
        self.BatchNorm_0 = rn.BatchNorm2d(c_out, eps=rn.BN_EPS, momentum=rn.BN_MOMENTUM)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        if self.act == "silu":
            return F.silu(x)
        return F.relu(x) if self.act == "relu" else x


def dwconv(c_in, c_out, k, s=1, act="silu"):
    return ConvBn(c_in, c_out, k, s, act, g=math.gcd(c_in, c_out))


class HGStem(nn.Module):
    def __init__(self, c1, cm, c2):
        super().__init__()
        self.stem1 = ConvBn(c1, cm, 3, 2, "relu")
        self.stem2a = ConvBn(cm, cm // 2, 2, 1, "relu", p=0)
        self.stem2b = ConvBn(cm // 2, cm, 2, 1, "relu", p=0)
        self.stem3 = ConvBn(cm * 2, cm, 3, 2, "relu")
        self.stem4 = ConvBn(cm, c2, 1, 1, "relu")

    def forward(self, x):
        x = F.pad(self.stem1(x), [0, 1, 0, 1])
        x2 = self.stem2b(F.pad(self.stem2a(x), [0, 1, 0, 1]))
        x1 = F.max_pool2d(x, 2, 1, 0, ceil_mode=True)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class LightConv(nn.Module):
    def __init__(self, c1, c2, k):
        super().__init__()
        self.conv1 = ConvBn(c1, c2, 1, 1, None)
        self.conv2 = dwconv(c2, c2, k, 1, "relu")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HGBlock(nn.Module):
    def __init__(self, c1, cm, c2, k=3, n=6, light=False, shortcut=False):
        super().__init__()
        self.n = n
        for i in range(n):
            c = c1 if i == 0 else cm
            self.add_module(f"m_{i}", LightConv(c, cm, k) if light else ConvBn(c, cm, k, 1, "relu"))
        self.sc = ConvBn(c1 + n * cm, c2 // 2, 1, 1, "relu")
        self.ec = ConvBn(c2 // 2, c2, 1, 1, "relu")
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = [x]
        for i in range(self.n):
            y.append(getattr(self, f"m_{i}")(y[-1]))
        y = self.ec(self.sc(torch.cat(y, 1)))
        return y + x if self.add else y


class RepConv(nn.Module):
    """SiLU(conv1 3x3 + conv2 1x1), no identity BatchNorm (bn=False)."""

    def __init__(self, c1, c2):
        super().__init__()
        self.conv1 = ConvBn(c1, c2, 3, 1, None)
        self.conv2 = ConvBn(c1, c2, 1, 1, None)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


class RepC3(nn.Module):
    """cv3(m(cv1(x)) + cv2(x)) with e = 1: cv3 is the identity."""

    def __init__(self, c1, c2, n=3):
        super().__init__()
        self.n = n
        self.cv1 = ConvBn(c1, c2, 1, 1)
        self.cv2 = ConvBn(c1, c2, 1, 1)
        for i in range(n):
            self.add_module(f"m_{i}", RepConv(c2, c2))

    def forward(self, x):
        y = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m_{i}")(y)
        return y + self.cv2(x)


class Backbone(nn.Module):
    """yaml layers 0-9; returns layers 3, 7 and 9."""

    def __init__(self):
        super().__init__()
        self.HGStem_0 = HGStem(3, 32, 48)
        self.HGBlock_0 = HGBlock(48, 48, 128, 3)
        self.DWConv_0 = dwconv(128, 128, 3, 2, None)
        self.HGBlock_1 = HGBlock(128, 96, 512, 3)
        self.DWConv_1 = dwconv(512, 512, 3, 2, None)
        self.HGBlock_2 = HGBlock(512, 192, 1024, 5, light=True)
        self.HGBlock_3 = HGBlock(1024, 192, 1024, 5, light=True, shortcut=True)
        self.HGBlock_4 = HGBlock(1024, 192, 1024, 5, light=True, shortcut=True)
        self.DWConv_2 = dwconv(1024, 1024, 3, 2, None)
        self.HGBlock_5 = HGBlock(1024, 384, 2048, 5, light=True)

    def forward(self, x, training=False):
        del training
        x = self.HGBlock_0(self.HGStem_0(x))
        c3 = self.HGBlock_1(self.DWConv_0(x))
        x = self.HGBlock_2(self.DWConv_1(c3))
        c4 = self.HGBlock_4(self.HGBlock_3(x))
        return c3, c4, self.HGBlock_5(self.DWConv_2(c4))


class MultiHeadAttention(nn.Module):
    """nn.MultiheadAttention (no mask, no dropout) written out:
    out_proj(concat_h softmax(q_h k_h^T / sqrt(d_h)) v_h)."""

    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, q, k, v):
        B, N, d = q.shape
        dh = d // self.heads
        r = rn.fp8_round if self.q_proj.precision == "fp8" else (lambda t: t)

        def split(t):
            return t.reshape(B, -1, self.heads, dh).transpose(1, 2)

        q, k, v = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        a = torch.softmax((r(q) @ r(k).transpose(-2, -1)) / math.sqrt(dh), dim=-1)
        o = r(a) @ r(v)
        return self.out_proj(o.transpose(1, 2).reshape(B, N, d))


def sincos_position_embedding(w, h, dim=256, temperature=10000.0, device=None):
    """AIFI.build_2d_sincos_position_embedding, as written."""
    grid_w = torch.arange(w, dtype=torch.float32, device=device)
    grid_h = torch.arange(h, dtype=torch.float32, device=device)
    grid_w, grid_h = torch.meshgrid(grid_w, grid_h, indexing="ij")
    pos_dim = dim // 4
    omega = torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = grid_w.flatten()[..., None] @ omega[None]
    out_h = grid_h.flatten()[..., None] @ omega[None]
    return torch.cat([torch.sin(out_w), torch.cos(out_w), torch.sin(out_h), torch.cos(out_h)], 1)


class AIFI(nn.Module):
    def __init__(self, c=HIDDEN, cm=1024, heads=HEADS):
        super().__init__()
        self.ma = MultiHeadAttention(c, heads)
        self.fc1, self.fc2 = Linear(c, cm), Linear(cm, c)
        self.norm1, self.norm2 = nn.LayerNorm(c), nn.LayerNorm(c)

    def forward(self, x):
        c, h, w = x.shape[1:]
        pos = sincos_position_embedding(w, h, c, device=x.device)[None]
        src = x.flatten(2).permute(0, 2, 1)
        q = src + pos
        src = self.norm1(src + self.ma(q, q, src))
        src = self.norm2(src + self.fc2(F.gelu(self.fc1(src))))
        return src.permute(0, 2, 1).reshape(-1, c, h, w)


class Neck(nn.Module):
    """yaml layers 10-27: (X3, F4, F5)."""

    def __init__(self):
        super().__init__()
        c3, c4, c5 = variant_channels()
        d = HIDDEN
        self.proj5 = ConvBn(c5, d, 1, 1, None)
        self.AIFI_0 = AIFI(d)
        self.lateral5 = ConvBn(d, d, 1, 1)
        self.proj4 = ConvBn(c4, d, 1, 1, None)
        self.RepC3_0 = RepC3(2 * d, d)
        self.lateral4 = ConvBn(d, d, 1, 1)
        self.proj3 = ConvBn(c3, d, 1, 1, None)
        self.RepC3_1 = RepC3(2 * d, d)
        self.down3 = ConvBn(d, d, 3, 2)
        self.RepC3_2 = RepC3(2 * d, d)
        self.down4 = ConvBn(d, d, 3, 2)
        self.RepC3_3 = RepC3(2 * d, d)

    def forward(self, c3, c4, c5, training=False):
        del training
        y5 = self.lateral5(self.AIFI_0(self.proj5(c5)))
        y4 = self.lateral4(self.RepC3_0(torch.cat([rn.up2(y5), self.proj4(c4)], 1)))
        x3 = self.RepC3_1(torch.cat([rn.up2(y4), self.proj3(c3)], 1))
        f4 = self.RepC3_2(torch.cat([self.down3(x3), y4], 1))
        f5 = self.RepC3_3(torch.cat([self.down4(f4), y5], 1))
        return x3, f4, f5


class MLP(nn.Module):
    def __init__(self, c_in, hidden, c_out, layers):
        super().__init__()
        dims = [c_in] + [hidden] * (layers - 1) + [c_out]
        self.n = layers
        for i in range(layers):
            self.add_module(f"Linear_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Linear_{i}")(x)
            x = F.relu(x) if i < self.n - 1 else x
        return x


class DeformSample(nn.Module):
    """multi_scale_deformable_attn_pytorch: per level `F.grid_sample` of the
    value map at 2 loc - 1 (bilinear, zero padding, align_corners False),
    summed with the attention weights.  `precision` 'fp8' (the control)
    rounds the locations to bfloat16 first."""

    precision = "fp32"

    def forward(self, value, shapes, loc, weights):
        if self.precision == "fp8":
            loc = loc.to(torch.bfloat16).to(torch.float32)
        bs, _, nh, dh = value.shape
        _, nq, _, nl, npt, _ = loc.shape
        values = value.split([h * w for h, w in shapes], dim=1)
        grids = 2 * loc - 1
        out = []
        for lvl, (h, w) in enumerate(shapes):
            v = values[lvl].flatten(2).transpose(1, 2).reshape(bs * nh, dh, h, w)
            g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
            out.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
        a = weights.transpose(1, 2).reshape(bs * nh, 1, nq, nl * npt)
        o = (torch.stack(out, dim=-2).flatten(-2) * a).sum(-1).view(bs, nh * dh, nq)
        return o.transpose(1, 2)


class MSDeformAttn(nn.Module):
    def __init__(self, d=HIDDEN, levels=LEVELS, heads=HEADS, points=POINTS):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = Linear(d, heads * levels * points * 2)
        self.attention_weights = Linear(d, heads * levels * points)
        self.value_proj = Linear(d, d)
        self.output_proj = Linear(d, d)
        self.sample = DeformSample()

    def forward(self, query, refer, value, shapes):
        bs, nq, d = query.shape
        nh, nl, npt = self.heads, self.levels, self.points
        value = self.value_proj(value).view(bs, value.shape[1], nh, d // nh)
        off = self.sampling_offsets(query).view(bs, nq, nh, nl, npt, 2)
        w = F.softmax(self.attention_weights(query).view(bs, nq, nh, nl * npt), -1)
        w = w.view(bs, nq, nh, nl, npt)
        r = refer[:, :, None, None, None]
        loc = r[..., :2] + off / npt * r[..., 2:] * 0.5
        return self.output_proj(self.sample(value, shapes, loc, w))


class DecoderLayer(nn.Module):
    def __init__(self, d=HIDDEN, heads=HEADS, ffn=FFN):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn = MSDeformAttn(d)
        self.norm2 = nn.LayerNorm(d)
        self.linear1, self.linear2 = Linear(d, ffn), Linear(ffn, d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, embed, refer, feats, shapes, qpos):
        q = embed + qpos
        embed = self.norm1(embed + self.self_attn(q, q, embed))
        embed = self.norm2(embed + self.cross_attn(embed + qpos, refer, feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def make_anchors(shapes, device, grid_size=0.05, eps=1e-2):
    """RTDETRDecoder._generate_anchors: (A, 4) logits, +inf where invalid."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        sy = torch.arange(h, dtype=torch.float32, device=device)
        sx = torch.arange(w, dtype=torch.float32, device=device)
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        xy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], dtype=torch.float32,
                                                             device=device)
        wh = torch.ones_like(xy) * grid_size * (2.0 ** i)
        anchors.append(torch.cat([xy, wh], -1).view(h * w, 4))
    a = torch.cat(anchors)
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdim=True)
    return torch.log(a / (1 - a)).masked_fill(~valid, float("inf")), valid


def stable_top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest of each row, ties to the lower index."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


class Head(nn.Module):
    """RTDETRDecoder (eval): `encode` (input projections, anchors, encoder
    output and logits) and `decode` (from a selection: six layers, the last
    score head)."""

    def __init__(self, nc=80, d=HIDDEN, queries=QUERIES, layers=DECODER_LAYERS):
        super().__init__()
        self.queries, self.n_layers = queries, layers
        for i in range(LEVELS):
            self.add_module(f"input_proj_{i}", ConvBn(d, d, 1, 1, None))
        self.enc_output = Linear(d, d)
        self.enc_norm = nn.LayerNorm(d)
        self.enc_score_head = Linear(d, nc)
        self.enc_bbox_head = MLP(d, d, 4, 3)
        self.query_pos_head = MLP(4, 2 * d, d, 2)
        for i in range(layers):
            self.add_module(f"layers_{i}", DecoderLayer(d))
            self.add_module(f"dec_score_head_{i}", Linear(d, nc))
            self.add_module(f"dec_bbox_head_{i}", MLP(d, d, 4, 3))

    def encode(self, maps) -> Dict:
        shapes = [tuple(m.shape[2:]) for m in maps]
        feats = torch.cat([getattr(self, f"input_proj_{i}")(m).flatten(2).permute(0, 2, 1)
                           for i, m in enumerate(maps)], 1)
        anchors, valid = make_anchors(shapes, feats.device)
        f = self.enc_norm(self.enc_output(valid * feats))
        return {"feats": feats, "shapes": shapes, "anchors": anchors, "f": f,
                "enc_logits": self.enc_score_head(f)}

    def decode(self, enc: Dict, idx: torch.Tensor, last_embed: bool = False):
        """-> (boxes (B, Q, 4), logits (B, Q, nc)) from the selection idx
        (B, Q); with `last_embed` also the last layer's embeddings."""
        B, Q = idx.shape
        bi = torch.arange(B, device=idx.device)[:, None].expand(B, Q)
        embed = enc["f"][bi, idx]
        refer = (self.enc_bbox_head(embed) + enc["anchors"][idx]).sigmoid()
        for i in range(self.n_layers):
            qpos = self.query_pos_head(refer)
            embed = getattr(self, f"layers_{i}")(embed, refer, enc["feats"], enc["shapes"], qpos)
            refer = torch.sigmoid(getattr(self, f"dec_bbox_head_{i}")(embed)
                                  + inverse_sigmoid(refer))
        logits = getattr(self, f"dec_score_head_{self.n_layers - 1}")(embed)
        return (refer, logits, embed) if last_embed else (refer, logits)

    def forward(self, maps, training=False):
        del training
        enc = self.encode(maps)
        return list(self.decode(enc, stable_top(enc["enc_logits"].amax(-1), self.queries)))


class RTDETR(nn.Module):
    """The plain RT-DETR-L: (B, H, W, 3) uint8 -> [boxes, logits]."""

    def __init__(self, variant="rtdetr-l", nc=80):
        super().__init__()
        variant_channels(variant)
        self.backbone, self.neck, self.head = Backbone(), Neck(), Head(nc)

    features = rn.YOLOv8.features
    forward = rn.YOLOv8.forward


class MCAQYOLO(rm.MCAQYOLO):
    """RT-DETR-L with the MCAQ transform on C3 / C4 / C5 before the
    encoder: `reference.mcaq.MCAQYOLO`'s transform and forward; its
    `forward_blocks` adds the encoder logits and the selection."""

    def __init__(self, variant="rtdetr-l", nc=80, grid=8, downsample=1):
        nn.Module.__init__(self)
        self.backbone, self.neck, self.head = Backbone(), Neck(), Head(nc)
        self.complexity_analyzer = rm.Analyzer(grid, downsample)
        self.bit_mapper = rm.BitMapper()
        for i, c in enumerate(variant_channels(variant)):
            self.add_module(f"quantizer_p{i + 3}", rm.Quantizer(c))

    @torch.no_grad()
    def forward_blocks(self, x, temperature=1.0, block=32, feats=None, bit_maps=None,
                       selection=None) -> Dict:
        """`reference.mcaq.MCAQYOLO.forward_blocks`' contract (the
        quantizers' ranges are the whole batch's), given `feats`,
        `bit_maps` and also a `selection` (B, Q) to decode from in place of
        its own.  -> dict of the backbone features, complexity and bit
        maps, avg_bits, the encoder logits (B, A, nc), the selection, and
        `raw` = [boxes, logits] of the decoder."""
        if feats is None:
            feats = [[] for _ in range(3)]
            for s in range(0, x.shape[0], block):
                for i, f in enumerate(self.backbone(rn.to_nchw(x[s:s + block]))):
                    feats[i].append(f)
            feats = [torch.cat(f) for f in feats]
        feats = [f.to(torch.float32) for f in feats]
        ranges = []
        for f in feats:
            flat = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])
            ranges.append((flat.amin(0), flat.amax(0)))
        keys = ("complexity", "bits", "enc_logits", "selection", "boxes", "logits")
        out: Dict[str, List] = {k: [] for k in keys}
        cm, bm = [[], [], []], [[], [], []]
        for s in range(0, feats[0].shape[0], block):
            q = []
            for i, f in enumerate(feats):
                given = None if bit_maps is None else bit_maps[i][s:s + block].to(torch.float32)
                fq, c, b = self.transform(f[s:s + block], i, temperature,
                                          batch_range=ranges[i], bit_map=given)
                q.append(fq)
                cm[i].append(c)
                bm[i].append(b)
            enc = self.head.encode(self.neck(*q))
            idx = stable_top(enc["enc_logits"].amax(-1), self.head.queries) \
                if selection is None else selection[s:s + block].to(enc["f"].device)
            boxes, logits = self.head.decode(enc, idx)
            for k, v in zip(keys[2:], (enc["enc_logits"], idx, boxes, logits)):
                out[k].append(v)
        res = {k: torch.cat(out[k]) for k in keys[2:]}
        res["complexity"] = [torch.cat(c) for c in cm]
        res["bits"] = [torch.cat(b) for b in bm]
        res.update(feats=feats, raw=[res["boxes"], res["logits"]],
                   avg_bits=torch.stack([b.mean() for b in res["bits"]]).mean())
        return res


def select_queries(boxes, logits, img_hw, conf=0.25, max_det=QUERIES):
    """RTDETRPredictor.postprocess on the (B, Q) queries: score = max_c
    sigmoid(logit_c), class its argmax, xywh -> xyxy times the input side;
    the queries above `conf`, by score (ties to the lower query index).
    -> one dict of boxes, scores and classes per image."""
    scores, classes = logits.sigmoid().max(-1)
    h, w = img_hw
    xy, wh = boxes[..., :2], boxes[..., 2:] / 2
    xyxy = torch.cat([xy - wh, xy + wh], -1) * torch.tensor([w, h, w, h], dtype=boxes.dtype,
                                                            device=boxes.device)
    out = []
    for b in range(boxes.shape[0]):
        keep = torch.nonzero(scores[b] > conf).flatten()
        order = keep[torch.sort(scores[b][keep], descending=True, stable=True).indices][:max_det]
        out.append({"boxes": xyxy[b][order], "scores": scores[b][order],
                    "classes": classes[b][order]})
    return out


def set_precision(model: nn.Module, precision: str, kinds=None) -> None:
    """'fp32' or 'fp8' (the control) for every convolution and linear layer
    and the deformable samplers' locations, or only for the modules of the
    classes `kinds` (e.g. `(DeformSample,)`: the locations alone)."""
    if precision not in rn.PRECISIONS:
        raise ValueError(f"precision must be one of {rn.PRECISIONS}")
    for m in model.modules():
        if isinstance(m, kinds or (rn.Conv, Linear, DeformSample)):
            m.precision = precision


def init_(model: nn.Module, seed: int, nc: int) -> nn.Module:
    """Every leaf from the seed by `perfbench/weights.py:init_`'s rules:
    convolutions and Linears lecun normal, biases 0, BatchNorm and LayerNorm
    scales 1, running statistics 0 and 1, the MCAQ modules as there."""
    from .. import weights

    return weights.init_(model, seed, nc)


@torch.no_grad()
def spread_(model: MCAQYOLO, frames: torch.Tensor, enc_scale: float = 2.0,
            queries_above: float = 25.0, head_dims: int = 4) -> Dict:
    """Give the seeded network real work on `frames` (n, S, S, 3) uint8, in
    place: (1) the encoder's three input projections (`proj5`, `proj4`,
    `proj3`: 1x1 ConvBn without activation) take as running variance the
    mean square of their convolution's output on the frames (running mean
    0), so the encoder sees unit-scale maps: at seeded weights the ReLU
    backbone shrinks its activations (C3 / C4 / C5 RMS about 1e-2 / 3e-3 /
    1e-3); no other BatchNorm is set from the frames, since with every
    BatchNorm's statistics from the frames the random ReLU backbone
    amplifies the bfloat16 rounding about 1.2x a layer (C5 50% off the
    float32 reference); (2) the bit mapper is spread as
    `perfbench/weights.py:spread_` does (BatchNorm statistics from the
    model's own complexity, output layer x50), so tiles spread over 2-8
    bits; (3) the encoder score head is scaled so its logits have std
    `enc_scale` on the frames (the selection separates the anchors); (4)
    the last decoder score head is projected onto the `head_dims`
    directions in which the queries of one frame differ most (outside the
    span of the frames' mean embeddings), scaled to unit std and biased so
    that `queries_above` of the 300 queries an image clear conf 0.25 on
    average: through six layers at seeded weights the 300 embeddings of a
    frame nearly collapse (within-frame variance about 1% of their norm),
    so a random head gives frames 0 or 250 queries above the gate, and a
    head on the weaker directions reads bfloat16 rounding.  Returns what
    it set."""
    neck = model.neck
    bns = [p.BatchNorm_0 for p in (neck.proj5, neck.proj4, neck.proj3)]

    def take_scale(bn, args):
        bn.running_mean.zero_()
        bn.running_var.copy_(args[0].square().mean(dim=(0, 2, 3)))

    feats = model.backbone(rn.to_nchw(frames))
    c = torch.cat([model.complexity_analyzer(f.permute(0, 2, 3, 1)).reshape(-1)
                   for f in feats]).clamp(0.0, 1.0)[:, None]
    mapper = model.bit_mapper
    h = torch.cat([c, c ** 2, torch.log1p(c)], -1)
    for i in range(mapper.n_hidden):
        h = mapper.dense(i)(h)
        bn = getattr(mapper, f"BatchNorm_{i}")
        bn.running_mean.copy_(h.mean(0))
        bn.running_var.copy_(h.var(0, unbiased=False))
        h = F.leaky_relu(bn(h), 0.05)
    last = mapper.dense(mapper.n_hidden)
    last.theta.copy_(torch.log(torch.expm1(F.softplus(last.theta) * 50.0)))
    hs = [bn.register_forward_pre_hook(take_scale) for bn in bns]
    try:
        head = model.head
        enc = head.encode(neck(*[model.transform(f, i, 1.0)[0] for i, f in enumerate(feats)]))
    finally:
        for hk in hs:
            hk.remove()
    esh = head.enc_score_head
    esh.weight.mul_(enc_scale / F.linear(enc["f"], esh.weight).std())
    esh.bias.zero_()
    enc["enc_logits"] = esh(enc["f"])
    idx = stable_top(enc["enc_logits"].amax(-1), head.queries)
    _, _, embed = head.decode(enc, idx, last_embed=True)
    dsh = getattr(head, f"dec_score_head_{head.n_layers - 1}")
    # the head reads only the directions in which the queries of one frame
    # differ most, outside the span of the frames' mean embeddings
    u = torch.linalg.svd(embed.mean(1).T, full_matrices=False)[0]
    d = embed - embed.mean(1, keepdim=True)
    d = (d - d @ u @ u.T).flatten(0, 1)
    v = torch.linalg.eigh(d.T @ d)[1][:, -head_dims:]
    dsh.weight.copy_(dsh.weight @ v @ v.T)
    logits = F.linear(embed, dsh.weight)
    dsh.weight.div_(logits.std())
    best = (logits / logits.std()).amax(-1)
    q = torch.quantile(best.flatten(), 1.0 - queries_above / best.shape[1])
    bias = float(torch.logit(torch.tensor(0.25)) - q)
    dsh.bias.fill_(bias)
    above = ((best + bias).sigmoid() > 0.25).sum(1)
    return {"feature_rms": [float(f.square().mean().sqrt()) for f in feats],
            "mapper_steepening": 50.0, "enc_scale": enc_scale,
            "dec_class_bias": bias, "above_gate_per_frame_mean": float(above.float().mean()),
            "above_gate_per_frame_min": int(above.min()),
            "above_gate_per_frame_max": int(above.max())}


def network_flops(nc: int = 80, img: int = 640) -> Tuple[int, int]:
    """(convolutions and linear layers, attention products) of one image:
    2 x MACs of every convolution and Linear (the attentions' projections
    included), and 2 x MACs of each attention's q k^T and attn v (N x N x
    d a product, N the tokens: AIFI's H x W, the decoder's 300 queries),
    counted from the shapes on the meta device.  The deformable sampling's
    interpolation is not counted (its bound is bytes:
    `drivers/serve_batch_rtdetr.py:deform_bytes`)."""
    total = [0, 0]

    def conv(m, args, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    def linear(m, args, out):
        total[0] += 2 * out.numel() * m.in_features

    def attention(m, args, out):
        q, k = args[0], args[1]
        total[1] += 2 * 2 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]

    with torch.device("meta"):
        net = RTDETR("rtdetr-l", nc)
        hs = []
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                hs.append(m.register_forward_hook(conv))
            elif isinstance(m, nn.Linear):
                hs.append(m.register_forward_hook(linear))
            elif isinstance(m, MultiHeadAttention):
                hs.append(m.register_forward_hook(attention))
        try:
            net.head(net.neck(*net.backbone(torch.empty((1, 3, img, img)))))
        finally:
            for h in hs:
                h.remove()
    return total[0], total[1]

