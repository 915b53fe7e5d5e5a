"""
RT-DETR-L (Zhao et al., "DETRs Beat YOLOs on Real-time Object Detection",
arXiv:2304.08069) as Ultralytics builds it from
`ultralytics/cfg/models/rt-detr/rtdetr-l.yaml`: the HGNetv2-L backbone
(yaml layers 0-9), the hybrid encoder (AIFI over the stride-32 map and the
CCFM of RepC3 blocks, layers 10-27) and `RTDETRDecoder` (layer 28), with the
NMS-free post-process of `ultralytics/models/rtdetr/predict.py`
(`select_queries`).  The modules are those of `ultralytics/nn/modules/
{block,conv,transformer,head}.py`; the attentions hold explicit q / k / v /
out `nn.Linear`s (not `nn.MultiheadAttention`'s packed `in_proj_weight`), so
the checkpoint path maps every leaf as a Linear or a LayerNorm.  The
training-only denoising embedding is not built.

The backbone returns (C3, C4, C5) = yaml layers 3, 7 and 9 (512, 1024 and
2048 channels at strides 8, 16, 32), where `MCAQYOLO` quantizes them; the
encoder returns its three 256-channel maps; the decoder returns the last
layer's boxes (B, 300, 4) (cx, cy, w, h in [0, 1]) and class logits
(B, 300, nc), both float32.

Precision on the deployed path: convolutions, linear layers, the
attentions' products and LayerNorm run in the network's dtype (bfloat16).
Anchors, box logits and their refinement, sigmoid and logit, the sampling
locations and attention weights of the deformable attention, and its
bilinear sampling with the weighted sum run in float32: the sampler reads
the value map through a float32 copy (`F.grid_sample`) and returns the
network's dtype to `output_proj`.  The query selection is a stable
descending sort of the encoder's best-class logits (ties to the lower
anchor index).

Spans (`utils/profiling.py`): 'model.aifi' (attribute `tokens`, H x W),
'rtdetr.decoder' (the whole decoder: input projections, anchors, encoder
output, selection, the six layers) and,
inside it, 'rtdetr.deform' around each deformable sampling, which also
counts `deform_attn`; 'select_queries' around the post-process.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import initializers as init
from ..utils.profiling import count, span
from .layers import ConvBnSiLU, HGBlock, HGStem, RepC3, dwconv, upsample2x

HIDDEN = 256
HEADS = 8
FFN = 1024
LEVELS = 3
POINTS = 4
QUERIES = 300
DECODER_LAYERS = 6
AIFI_FFN = 1024
LOGIT_EPS = 1e-5


def variant_channels() -> Tuple[int, int, int]:
    """(C3, C4, C5): the outputs of yaml layers 3, 7 and 9."""
    return 512, 1024, 2048


class HGNetv2Backbone(nn.Module):
    """HGNetv2-L: stem to stride 4, four stages of HGBlocks (six layers
    each) joined by depthwise stride-2 ConvBns; returns (C3, C4, C5)."""

    def __init__(self):
        super().__init__()
        self.HGStem_0 = HGStem(3, 32, 48)
        self.HGBlock_0 = HGBlock(48, 48, 128, 3)
        self.DWConv_0 = dwconv(128, 128, 3, 2, False)
        self.HGBlock_1 = HGBlock(128, 96, 512, 3)
        self.DWConv_1 = dwconv(512, 512, 3, 2, False)
        self.HGBlock_2 = HGBlock(512, 192, 1024, 5, light=True)
        self.HGBlock_3 = HGBlock(1024, 192, 1024, 5, light=True, shortcut=True)
        self.HGBlock_4 = HGBlock(1024, 192, 1024, 5, light=True, shortcut=True)
        self.DWConv_2 = dwconv(1024, 1024, 3, 2, False)
        self.HGBlock_5 = HGBlock(1024, 384, 2048, 5, light=True)

    def forward(self, x, training: bool = False):
        t = training
        x = self.HGBlock_0(self.HGStem_0(x, t), t)
        c3 = self.HGBlock_1(self.DWConv_0(x, t), t)
        x = self.HGBlock_2(self.DWConv_1(c3, t), t)
        c4 = self.HGBlock_4(self.HGBlock_3(x, t), t)
        c5 = self.HGBlock_5(self.DWConv_2(c4, t), t)
        return c3, c4, c5


class Linear(nn.Linear):
    """`nn.Linear` with the port's seeded init (lecun normal, zero bias)."""

    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        init.lecun_normal_(self.weight, g)
        self.bias.zero_()


class LayerNorm(nn.LayerNorm):
    @torch.no_grad()
    def init_weights(self, g: torch.Generator):
        del g
        self.reset_parameters()


class MLP(nn.Module):
    """`layers` Linears with ReLU between them (Ultralytics' MLP)."""

    def __init__(self, c_in: int, hidden: int, c_out: int, layers: int):
        super().__init__()
        dims = [c_in] + [hidden] * (layers - 1) + [c_out]
        self.n = layers
        for i in range(layers):
            self.add_module(f"Linear_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Linear_{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """`nn.MultiheadAttention` (batch first, no dropout, no mask) with its
    projections as four Linears: softmax(q k^T / sqrt(d_head)) v, then
    `out_proj`.  The products run in the inputs' dtype
    (`F.scaled_dot_product_attention`)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, q, k, v):
        B, N, d = q.shape

        def split(t):  # (B, N, d) -> (B, heads, N, d / heads)
            return t.reshape(B, -1, self.heads, d // self.heads).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(self.q_proj(q)), split(self.k_proj(k)),
                                           split(self.v_proj(v)))
        return self.out_proj(o.transpose(1, 2).reshape(B, N, d))


def sincos_position_embedding(w: int, h: int, dim: int, device,
                              temperature: float = 10000.0) -> torch.Tensor:
    """AIFI's `build_2d_sincos_position_embedding` as written, its
    meshgrid(grid_w, grid_h, indexing='ij') order included: (w * h, dim)
    float32, [sin(w omega), cos(w omega), sin(h omega), cos(h omega)]."""
    grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                                    torch.arange(h, dtype=torch.float32, device=device),
                                    indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (torch.arange(pos_dim, dtype=torch.float32,
                                               device=device) / pos_dim)
    out_w = grid_w.flatten()[:, None] * omega[None]
    out_h = grid_h.flatten()[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)


class AIFI(nn.Module):
    """One post-norm transformer encoder layer over the H x W tokens of a
    map: q = k = x + pos, v = x; x = LN1(x + MHA(q, k, v)); x = LN2(x +
    fc2(GELU(fc1(x)))), exact GELU.  Span 'model.aifi' (attribute
    `tokens`)."""

    def __init__(self, c: int, c_ffn: int = AIFI_FFN, heads: int = HEADS):
        super().__init__()
        self.ma = MultiHeadAttention(c, heads)
        self.fc1, self.fc2 = Linear(c, c_ffn), Linear(c_ffn, c)
        self.norm1, self.norm2 = LayerNorm(c), LayerNorm(c)

    def forward(self, x, training: bool = False):
        del training
        B, C, H, W = x.shape
        with span("model.aifi", tokens=H * W):
            pos = sincos_position_embedding(W, H, C, x.device).to(x.dtype)
            t = x.flatten(2).transpose(1, 2)
            q = t + pos
            t = self.norm1(t + self.ma(q, q, t))
            t = self.norm2(t + self.fc2(F.gelu(self.fc1(t))))
            return t.transpose(1, 2).reshape(B, C, H, W).contiguous(
                memory_format=torch.channels_last)


class HybridEncoder(nn.Module):
    """yaml layers 10-27: C5 projected to 256 and through AIFI, then the
    CCFM: top-down (upsample, concat with the projected C4 / C3, RepC3,
    1x1 lateral) and bottom-up (3x3 stride-2 conv, concat, RepC3).
    Returns (X3, F4, F5), 256 channels at strides 8, 16, 32."""

    def __init__(self):
        super().__init__()
        c3, c4, c5 = variant_channels()
        d = HIDDEN
        self.proj5 = ConvBnSiLU(c5, d, 1, act=False)
        self.AIFI_0 = AIFI(d)
        self.lateral5 = ConvBnSiLU(d, d, 1)
        self.proj4 = ConvBnSiLU(c4, d, 1, act=False)
        self.RepC3_0 = RepC3(2 * d, d)
        self.lateral4 = ConvBnSiLU(d, d, 1)
        self.proj3 = ConvBnSiLU(c3, d, 1, act=False)
        self.RepC3_1 = RepC3(2 * d, d)
        self.down3 = ConvBnSiLU(d, d, 3, 2)
        self.RepC3_2 = RepC3(2 * d, d)
        self.down4 = ConvBnSiLU(d, d, 3, 2)
        self.RepC3_3 = RepC3(2 * d, d)

    def forward(self, c3, c4, c5, training: bool = False):
        t = training
        y5 = self.lateral5(self.AIFI_0(self.proj5(c5, t), t), t)
        y4 = self.lateral4(self.RepC3_0(torch.cat([upsample2x(y5), self.proj4(c4, t)], 1), t),
                           t)
        x3 = self.RepC3_1(torch.cat([upsample2x(y4), self.proj3(c3, t)], 1), t)
        f4 = self.RepC3_2(torch.cat([self.down3(x3, t), y4], 1), t)
        f5 = self.RepC3_3(torch.cat([self.down4(f4, t), y5], 1), t)
        return x3, f4, f5


class DeformSample(nn.Module):
    """The sampling of multi-scale deformable attention, parameter-free:
    value (B, L, heads, d_head) in the network's dtype, locations
    (B, Q, heads, levels, points, 2) and weights (B, Q, heads, levels,
    points) float32 -> (B, Q, heads * d_head) in the value's dtype.  Each
    level's map is read through a float32 copy by `F.grid_sample` at 2 loc
    - 1 (bilinear, zero padding, align_corners False) and the samples are
    summed with the weights in float32.  Span 'rtdetr.deform'; counter
    `deform_attn`, one a call."""

    def forward(self, value, shapes: Sequence[Tuple[int, int]], loc, weights):
        with span("rtdetr.deform"):
            count("deform_attn")
            B, _, nh, dh = value.shape
            Q, nl, npt = loc.shape[1], loc.shape[3], loc.shape[4]
            grids = 2 * loc - 1
            samples = []
            start = 0
            for lvl, (h, w) in enumerate(shapes):
                v = value[:, start:start + h * w].float().permute(0, 2, 3, 1).reshape(
                    B * nh, dh, h, w)
                start += h * w
                g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * nh, Q, npt, 2)
                samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                             align_corners=False))
            a = weights.transpose(1, 2).reshape(B * nh, 1, Q, nl * npt)
            out = (torch.stack(samples, -2).flatten(-2) * a).sum(-1)   # (B nh, dh, Q)
            return out.reshape(B, nh * dh, Q).transpose(1, 2).to(value.dtype)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (3 levels, 8 heads, 4 points):
    v = value_proj(feats) split into heads; offsets and a softmax over the
    12 (level, point) weights from the query; loc = r_xy + offset / points
    * r_wh * 0.5; out = output_proj(the weighted samples, `DeformSample`)."""

    def __init__(self, d: int = HIDDEN, levels: int = LEVELS, heads: int = HEADS,
                 points: int = POINTS):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = Linear(d, heads * levels * points * 2)
        self.attention_weights = Linear(d, heads * levels * points)
        self.value_proj = Linear(d, d)
        self.output_proj = Linear(d, d)
        self.sample = DeformSample()

    def forward(self, query, refer, feats, shapes):
        """query (B, Q, d); refer (B, Q, 4) float32 boxes in [0, 1]."""
        B, Q, d = query.shape
        nh, nl, npt = self.heads, self.levels, self.points
        value = self.value_proj(feats).reshape(B, feats.shape[1], nh, d // nh)
        off = self.sampling_offsets(query).float().reshape(B, Q, nh, nl, npt, 2)
        w = self.attention_weights(query).float().reshape(B, Q, nh, nl * npt)
        w = w.softmax(-1).reshape(B, Q, nh, nl, npt)
        r = refer[:, :, None, None, None]
        loc = r[..., :2] + off / npt * r[..., 2:] * 0.5
        return self.output_proj(self.sample(value, shapes, loc, w))


class DecoderLayer(nn.Module):
    """e = LN1(e + MHA(e + qpos, e + qpos, e)); e = LN2(e +
    MSDeformAttn(e + qpos, r, feats)); e = LN3(e + W2 ReLU(W1 e))."""

    def __init__(self, d: int = HIDDEN, heads: int = HEADS, ffn: int = FFN):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, heads)
        self.norm1 = LayerNorm(d)
        self.cross_attn = MSDeformAttn(d)
        self.norm2 = LayerNorm(d)
        self.linear1, self.linear2 = Linear(d, ffn), Linear(ffn, d)
        self.norm3 = LayerNorm(d)

    def forward(self, e, refer, feats, shapes, qpos):
        q = e + qpos
        e = self.norm1(e + self.self_attn(q, q, e))
        e = self.norm2(e + self.cross_attn(e + qpos, refer, feats, shapes))
        return self.norm3(e + self.linear2(F.relu(self.linear1(e))))


def inverse_sigmoid(x: torch.Tensor, eps: float = LOGIT_EPS) -> torch.Tensor:
    """log(x / (1 - x)) with x and 1 - x clamped below at `eps`."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def make_anchors(shapes: Sequence[Tuple[int, int]], device, grid: float = 0.05,
                 eps: float = 1e-2):
    """Per level l the cell centres ((x + 0.5) / w, (y + 0.5) / h) and the
    size 0.05 2^l, as logits (A, 4) float32, +inf where a coordinate lies
    outside (eps, 1 - eps); and that validity (A, 1)."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        # true division by a tensor of the sides, made on the device (no host copy)
        xy = (torch.stack([gx, gy], -1) + 0.5) / torch.stack(
            [torch.full_like(gx, float(w)), torch.full_like(gy, float(h))], -1)
        wh = torch.full_like(xy, grid * 2.0 ** lvl)
        out.append(torch.cat([xy, wh], -1).reshape(h * w, 4))
    a = torch.cat(out)
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdim=True)
    return torch.log(a / (1 - a)).masked_fill(~valid, float("inf")), valid


def stable_top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the k largest of each row, ties to the lower index
    (a stable descending sort; `torch.topk`'s order among ties is
    unspecified)."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


class QuerySelect(nn.Module):
    """The query selection, parameter-free: encoder logits (B, A, nc)
    float32 -> the indices (B, Q) of the Q anchors with the largest
    best-class logit (`stable_top`)."""

    def __init__(self, queries: int = QUERIES):
        super().__init__()
        self.queries = queries

    def forward(self, enc_logits):
        return stable_top(enc_logits.amax(-1), self.queries)


class RTDETRDecoder(nn.Module):
    """Ultralytics' RTDETRDecoder in eval: input projections (1x1 conv +
    BatchNorm) of the encoder's maps, flattened into feats (B, A, 256);
    the encoder output f = LN(Linear(valid feats)), its logits; the 300
    best anchors (`QuerySelect`), refer = MLP3(f_sel) + anchor logits, the
    embeddings f_sel; six decoder layers from r = sigmoid(refer), each
    with qpos = MLP2(r) and the box refinement r = sigmoid(MLP3_i(e) +
    logit(r)); the score head of the last layer.  -> [boxes (B, Q, 4),
    logits (B, Q, nc)] float32.  Its post-process is NMS-free
    (`postprocess`, `select_queries`), so it keeps no candidate pool."""

    nms_pool = False

    def __init__(self, num_classes: int = 80, chans: Sequence[int] = (HIDDEN,) * LEVELS,
                 d: int = HIDDEN, queries: int = QUERIES, layers: int = DECODER_LAYERS):
        super().__init__()
        self.num_classes, self.n_layers = num_classes, layers
        for i, c in enumerate(chans):
            self.add_module(f"input_proj_{i}", ConvBnSiLU(c, d, 1, act=False))
        self.enc_output = Linear(d, d)
        self.enc_norm = LayerNorm(d)
        self.enc_score_head = Linear(d, num_classes)
        self.enc_bbox_head = MLP(d, d, 4, 3)
        self.query_pos_head = MLP(4, 2 * d, d, 2)
        self.selection = QuerySelect(queries)
        for i in range(layers):
            self.add_module(f"layers_{i}", DecoderLayer(d))
            self.add_module(f"dec_score_head_{i}", Linear(d, num_classes))
            self.add_module(f"dec_bbox_head_{i}", MLP(d, d, 4, 3))

    def forward(self, maps: Sequence[torch.Tensor], training: bool = False) -> List[torch.Tensor]:
        with span("rtdetr.decoder"):
            shapes = [tuple(m.shape[2:]) for m in maps]
            # (B, H * W, C) of each map: a view of channels-last memory
            feats = torch.cat([getattr(self, f"input_proj_{i}")(m, training)
                               .permute(0, 2, 3, 1).flatten(1, 2)
                               for i, m in enumerate(maps)], 1)
            anchors, valid = make_anchors(shapes, feats.device)
            f = self.enc_norm(self.enc_output(valid.to(feats.dtype) * feats))
            enc_logits = self.enc_score_head(f).float()
            idx = self.selection(enc_logits)
            B, Q = idx.shape
            e = torch.gather(f, 1, idx[..., None].expand(B, Q, f.shape[-1]))
            refer = self.enc_bbox_head(e).float() + anchors[idx]
            r = refer.sigmoid()
            for i in range(self.n_layers):
                qpos = self.query_pos_head(r.to(e.dtype))
                e = getattr(self, f"layers_{i}")(e, r, feats, shapes, qpos)
                r = torch.sigmoid(getattr(self, f"dec_bbox_head_{i}")(e).float()
                                  + inverse_sigmoid(r))
            logits = getattr(self, f"dec_score_head_{self.n_layers - 1}")(e).float()
            return [r, logits]

    def postprocess(self, raw, img_hw, conf_threshold: float, iou_threshold: float,
                    max_det: int, pre_topk: int):
        """The deployed post-process of `raw` = [boxes, logits]:
        `select_queries` -> (boxes, scores, classes, valid, the number of
        queries above conf).  NMS-free, so `iou_threshold` and `pre_topk`
        are unused."""
        del iou_threshold, pre_topk
        return select_queries(*raw, img_hw, conf_threshold, max_det)


def build_network(num_classes: int):
    """(backbone, encoder, decoder) of RT-DETR-L."""
    return HGNetv2Backbone(), HybridEncoder(), RTDETRDecoder(num_classes)


def select_queries(boxes: torch.Tensor, logits: torch.Tensor, img_hw: Tuple[int, int],
                   conf_threshold: float = 0.25, max_det: int = QUERIES):
    """The NMS-free post-process (Ultralytics' `RTDETRPredictor.postprocess`):
    per query score = max_c sigmoid(logit_c), class its argmax, the box
    (cx, cy, w, h) in [0, 1] to xyxy pixels of the input (`img_hw`); the
    queries with score > conf, sorted by score (ties to the lower query
    index) and padded to `max_det` with `valid` False.  -> (boxes (B,
    max_det, 4), scores, classes int32, valid, the number of queries above
    conf (B,) int32).  One span, 'select_queries'."""
    with span("select_queries"):
        scores, classes = logits.sigmoid().max(-1)
        keep = scores > conf_threshold
        h, w = img_hw
        c, half = boxes[..., :2], boxes[..., 2:] / 2
        lo, hi = c - half, c + half
        xyxy = torch.stack([lo[..., 0] * w, lo[..., 1] * h, hi[..., 0] * w, hi[..., 1] * h], -1)
        ranked = torch.where(keep, scores, torch.zeros_like(scores))
        B, Q = scores.shape
        n = min(max_det, Q)
        order = stable_top(ranked, n)
        valid = torch.gather(keep, 1, order)
        out_scores = torch.gather(ranked, 1, order)
        out_boxes = torch.gather(xyxy, 1, order[..., None].expand(B, n, 4)) * valid[..., None]
        out_classes = torch.gather(classes, 1, order).to(torch.int32) * valid
        if max_det > n:
            pad = max_det - n
            out_boxes, out_scores = F.pad(out_boxes, (0, 0, 0, pad)), F.pad(out_scores, (0, pad))
            out_classes, valid = F.pad(out_classes, (0, pad)), F.pad(valid, (0, pad))
        return (out_boxes, out_scores, out_classes, valid,
                keep.sum(-1).to(torch.int32))
