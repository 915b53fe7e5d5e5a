"""The port's CUDA kernel against its plain PyTorch version, on the GPU.

Every test here needs a CUDA device and nvcc; without them each skips.
This file imports neither jax nor the JAX package, so it also runs on a
GPU host that has no JAX. There `tests/conftest.py` (which imports jax)
is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Contract: bitwise equality with `spatial_quantize_torch`, in float32 and
bfloat16, with and without the soft mask, on exact tile multiples and on
a non-multiple shape (tile floor(h * Ht / H)).  The kernel moves 16 bytes
of channels per thread and refuses a channel count or an alignment that
does not fit that group."""

import numpy as np
import pytest
import torch

from mcaq_yolo_tpu_torch.ops import spatial_quant as sq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _inputs(device, B, H, W, C, Ht, Wt, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = t(rng.normal(0, 1, (B, H, W, C)))
    bit_map = t(rng.uniform(1.5, 8.5, (B, Ht, Wt)))  # the kernel rounds and clips
    mask = t(rng.uniform(0.0, 1.0, (B, H, W)))
    return x, bit_map, mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape", [
    (4, 80, 80, 64, 10, 10),   # P3 of yolov8n at 640 px
    (4, 20, 20, 256, 5, 5),    # P5
    (3, 12, 12, 24, 5, 5),     # non-multiple tile grid
])
def test_kernel_bitwise_equals_plain(cuda, dtype, with_mask, shape):
    B, H, W, C, Ht, Wt = shape
    x, bit_map, mask = _inputs(cuda, B, H, W, C, Ht, Wt, seed=H * C)
    x = x.to(dtype)
    lo, hi = torch.aminmax(x.reshape(-1, C), dim=0)
    lo, hi = lo.float().contiguous(), hi.float().contiguous()
    m = mask if with_mask else None
    before = sq.spatial_quantize.launches
    out = sq.spatial_quantize(x, bit_map, lo, hi, m)
    ref = sq.spatial_quantize_torch(x, bit_map, lo, hi, m)
    torch.cuda.synchronize()
    assert sq.spatial_quantize.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, bit_map, mask = _inputs(cuda, 2, 16, 16, 8, 4, 4, seed=1)
    lo, hi = x.amin(dim=(0, 1, 2)).contiguous(), x.amax(dim=(0, 1, 2)).contiguous()
    before = sq.spatial_quantize.launches
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # not NHWC-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        sq.spatial_quantize(nchw, bit_map, lo, hi)
    with pytest.raises(TypeError):
        sq.spatial_quantize(x.half(), bit_map, lo, hi)
    with pytest.raises(ValueError, match="bit_map on"):
        sq.spatial_quantize(x, bit_map.cpu(), lo, hi)
    with pytest.raises(ValueError, match="mask"):
        sq.spatial_quantize(x, bit_map, lo, hi, mask[:, :8])
    x6, bit6, _ = _inputs(cuda, 2, 9, 7, 6, 4, 3, seed=2)  # C not a multiple of 4 / 8
    lo6, hi6 = x6.amin(dim=(0, 1, 2)).contiguous(), x6.amax(dim=(0, 1, 2)).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="multiple"):
            sq.spatial_quantize(x6.to(dtype), bit6, lo6, hi6)
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 4 bytes off
        sq.spatial_quantize(shifted, bit_map, lo, hi)
    assert sq.spatial_quantize.launches == before
