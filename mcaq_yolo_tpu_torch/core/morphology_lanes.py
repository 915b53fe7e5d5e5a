"""
The per-tile phi engine as one CUDA kernel (port of
`mcaq_yolo_tpu/core/morphology_lanes.py`, the JAX package's default tile
engine, `morph_tile_engine='lanes'`).

The JAX engine lays the per-tile pipeline out for the TPU: tiles packed into
the 128 vector lanes, shift-add Gaussian and Sobel, shift-max/min morphology,
a sort-based Otsu.  Its `pack_tiles` / `unpack_scalars` are that register
layout and have no counterpart here.  On Hopper the same pipeline is
`csrc/morph_tiles.cu`: one launch per scale, every operator of phi1-phi5 and
the three interaction terms fused; tiles up to 8 x 8 are whole tiles per
warp in registers, larger ones one tile per block in shared memory (see the
source's note for the design and what bounds it).

  phi_tiles(gray, tile, canny_impl, binarize_impl, contour_components)
      gray (B, ht*tile, wt*tile) float32 in [0, 1] -> phi (B, ht, wt, 8), as
      `compute_phi_tiles` stacks it (phi1 halved, then phi1*phi2, phi3^2,
      sqrt(phi4*phi5 + 1e-12)).  Calls the registered op `mcaq::phi_tiles`,
      so eager code and a `torch.export` program run the same node: on a CUDA
      tensor the op launches the kernel (or raises: there is no fallback), on
      a CPU tensor it runs the plain version.
  phi_tiles_torch(...)
      The plain version: `morphology.phi_metrics_tiled` (the 'rows' engine's
      ops) and the stack.  The kernel is held to it bitwise on the card up
      to 128 x 128 tiles; above, where the plain version's float Otsu sums
      round, bitwise but for the tiles that `otsu_bins_differ` names.
  phi_metrics_tiled(gray, tile, canny_impl, binarize_impl, contour_components)
      JAX's signature: the five (B, ht, wt) maps, phi1 unhalved.

`phi_tiles.launches` counts kernel launches (and nothing else).  The kernel
takes every power-of-two tile from 1 to 1024 (what `image_ops.tile_size_for`
gives up to 16383 px at grid 8), and every option: its geometry is
`launch_geometry`.  The CPU op takes any power-of-two tile.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.build import Entry
from . import morphology as tm

# the kernel's constants (csrc/morph_tiles.cu): the warp path (kSmallThreads,
# kSmallMaxLt) and the block path (kThreads, kHeader, kMaxSmem, kGlobalBlocks)
WARP = 32
SMALL_THREADS = 128          # 4 warps a block
SMALL_MAX_TILE = 8           # tiles up to 8 x 8 take the warp path
LARGE_THREADS = 256
HEADER_BYTES = 2048          # the block path's counters, histogram and reductions
MAX_SMEM = 232448            # the H100's dynamic shared memory per block
PLANE_BYTES_PER_PIXEL = 25   # five float planes and five byte planes
MAX_TILE = 1024             # kMaxLt: a box-count counter for each of up to 10 scales
# blocks (and global scratch slices) when the planes do not fit in shared
# memory (tiles from 128): a few per SM, striding over the tiles
GLOBAL_BLOCKS = 264


class Geometry(NamedTuple):
    """The kernel's launch geometry for `n_tiles` tiles of `tile` pixels."""
    warp_path: bool        # whole tiles per warp in registers (tile <= 8), else a block a tile
    tiles_per_warp: int    # warp path: 32 / tile^2 (one 8 x 8 tile); block path 0
    tiles_per_block: int   # warp path: 4 warps' tiles; block path 1
    threads: int           # threads per block
    grid: int              # blocks launched
    ws_global: bool        # the planes live in a global scratch, not in shared memory
    ws_bytes: int          # block path: plane bytes of one tile
    smem: int              # dynamic shared memory per block, bytes
    scratch_bytes: int     # global scratch of the launch, bytes


@functools.lru_cache(maxsize=256)
def launch_geometry(n_tiles: int, tile: int) -> Geometry:
    """Tiles up to 8 x 8: a warp takes whole tiles (32 / tile^2 of them, one
    8 x 8 tile at two pixels a lane), a block 4 warps, no shared memory.
    Larger tiles: one per block of 256 threads, its planes in shared memory
    unless they exceed it (tiles from 128), then in a global scratch slice
    per block, the blocks striding over the tiles."""
    if tile < 1 or tile > MAX_TILE or tile & (tile - 1):
        raise ValueError(f"phi_tiles: the tile must be a power of two in [1, {MAX_TILE}], "
                         f"got {tile}")
    if n_tiles < 1:
        raise ValueError(f"phi_tiles: no tiles ({n_tiles})")
    n = tile * tile
    if tile <= SMALL_MAX_TILE:
        tpw = max(1, WARP // n)
        tpb = tpw * SMALL_THREADS // WARP
        return Geometry(True, tpw, tpb, SMALL_THREADS, -(-n_tiles // tpb), False, 0, 0, 0)
    ws_bytes = PLANE_BYTES_PER_PIXEL * n
    ws_global = HEADER_BYTES + ws_bytes > MAX_SMEM
    grid = min(n_tiles, GLOBAL_BLOCKS) if ws_global else n_tiles
    return Geometry(False, 0, 1, LARGE_THREADS, grid, ws_global, ws_bytes,
                    HEADER_BYTES + (0 if ws_global else ws_bytes),
                    grid * ws_bytes if ws_global else 0)


# float operations per pixel of the plain version, each elementwise op and
# each library function call counted once, by stage (the kernel's bound)
OPS_PER_PIXEL = {
    "phi3_sobel": 26,          # 4 separable 3-tap passes, 2 squares, 4 tile sums
    "canny_cv2compat": 148,    # 5-tap blur x2, Otsu, Sobel, L1, atan2 bins, NMS, 8 passes
    "canny_legacy": 85,        # the same with L2, min-max normalization, 2 passes
    "binarize_adaptive": 45,   # 11-tap blur x2 of gray*255, compare
    "binarize_otsu": 7,
    "lbp": 42,                 # 8 compares, ones, transitions, 10 label counts
    "contour": 12,             # erode3, boundary, area
    "euler": 16,               # one 2x2 window per pixel, its pattern class
    "box_counts": 2,
    "edge_density": 1,
}


def phi_tiles_ops(gray_numel: int, canny_impl: str = "cv2compat",
                  binarize_impl: str = "adaptive", contour_components: bool = True) -> int:
    """Float operations of one phi_tiles call on a gray map of `gray_numel`
    pixels (per-tile scalar work, a few dozen operations a tile, left out)."""
    per = (OPS_PER_PIXEL["phi3_sobel"] + OPS_PER_PIXEL["lbp"] + OPS_PER_PIXEL["contour"]
           + OPS_PER_PIXEL["box_counts"] + OPS_PER_PIXEL["edge_density"]
           + OPS_PER_PIXEL["canny_legacy" if canny_impl == "legacy" else "canny_cv2compat"]
           + OPS_PER_PIXEL["binarize_otsu" if binarize_impl == "otsu" else "binarize_adaptive"]
           + (OPS_PER_PIXEL["euler"] if contour_components else 0))
    return per * gray_numel


def phi_tiles_bytes(gray: torch.Tensor, tile: int) -> int:
    """Bytes one call must move: the gray map read once, phi written once."""
    B, H, W = gray.shape
    return gray.numel() * 4 + B * (H // tile) * (W // tile) * 8 * 4


def _check_options(canny_impl: str, binarize_impl: str) -> None:
    for name, value, allowed in (("canny_impl", canny_impl, tm.CANNY_IMPLS),
                                 ("binarize_impl", binarize_impl, tm.BINARIZE_IMPLS)):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def _check(gray: torch.Tensor, tile: int):
    """Refuse a map that is not whole power-of-two tiles; returns (B, ht,
    wt).  (The kernel's own bound on the tile is `launch_geometry`'s.)"""
    if gray.dtype != torch.float32 or gray.dim() != 3 or not gray.is_contiguous():
        raise ValueError("phi_tiles: gray must be a contiguous (B, H, W) float32 tensor, "
                         f"got {gray.dtype} {tuple(gray.shape)}")
    B, H, W = gray.shape
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"phi_tiles: the tile must be a power of two, got {tile}")
    if B < 1 or H < tile or W < tile or H % tile or W % tile:
        raise ValueError(f"phi_tiles: the map ({H}, {W}) must be whole tiles of {tile}")
    if gray.numel() >= 2 ** 40:
        raise ValueError("phi_tiles: the map is too large")
    return B, H // tile, W // tile


def phi_tiles_torch(gray: torch.Tensor, tile: int, canny_impl: str = "cv2compat",
                    binarize_impl: str = "adaptive",
                    contour_components: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    return tm.stack_phi(*tm.phi_metrics_tiled(gray, tile, canny_impl, binarize_impl,
                                              contour_components))


def _kernel_otsu_bins(x: torch.Tensor) -> torch.Tensor:
    """The kernel's Otsu bin of each tile of x (N, t, t), in PyTorch: an
    exact integer scan of the 256-bin histogram's counts and of sum(2b + 1),
    each rounded once to float32, sigma_b as the kernel scores it, the
    largest, the lowest bin on a tie; (N,) int64.  It equals the plain
    version's bin (`morphology.otsu_threshold`) up to 128 x 128 tiles, where
    the plain version's float cumsum is exact; above, a tile where the two
    differ is one where the kernel's phi may differ from the plain version's."""
    N, n = x.shape[0], x[0].numel()
    idx = torch.clamp((x * 256).to(torch.int32), 0, 255).reshape(N, n).long()
    counts = torch.zeros((N, 256), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    K = counts.cumsum(1)
    S = (counts * (2 * torch.arange(256, device=x.device) + 1)).cumsum(1)
    p = torch.tensor(1.0 / n, dtype=torch.float32)
    q = p * (1.0 / 512.0)
    omega, mu, mu_t = K.float() * p, S.float() * q, S[:, -1:].float() * q
    d = mu_t * omega - mu
    sigma = (d * d) / (omega * (1.0 - omega) + 1e-12)
    return torch.where(counts > 0, sigma, torch.full_like(sigma, -1.0)).argmax(1)


def otsu_bins_differ(tiles: torch.Tensor, canny_impl: str = "cv2compat",
                     binarize_impl: str = "adaptive") -> torch.Tensor:
    """(N,) bool over tiles (N, t, t): where the kernel's Otsu bin differs
    from the plain version's on an Otsu input of these options (the
    cv2compat blur or the legacy normalized NMS; the tile itself for Otsu
    binarization).  Never up to 128 x 128; above, such a tile is the only
    one whose phi from the kernel may differ from the plain version's."""
    inputs = [tm.legacy_nms_n(tiles) if canny_impl == "legacy"
              else tm._sep_filter(tiles, tm._gaussian_taps(5, 1.0), "edge")]
    if binarize_impl == "otsu":
        inputs.append(tiles)
    differ = torch.zeros(tiles.shape[0], dtype=torch.bool, device=tiles.device)
    for x in inputs:
        plain = (tm.otsu_threshold(x).flatten() * 256.0 - 0.5).long()
        differ |= plain != _kernel_otsu_bins(x)
    return differ


# the kernel's C entry (csrc/morph_tiles.cu)
_ENTRY = Entry("phi_tiles", "morph_tiles", "mcaq_phi_tiles",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_int]
               + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _taps():
    """The Gaussian taps of the plain version, as C float arrays."""
    g5 = tm._gaussian_taps(5, 1.0)
    g11 = tm._gaussian_taps(11, tm.ADAPTIVE_SIGMA)
    return (ctypes.c_float * 5)(*g5), (ctypes.c_float * 11)(*g11)


def kernel_args(gray: torch.Tensor, tile: int, canny_impl: str, binarize_impl: str,
                contour_components: bool):
    """The C entry's integer arguments for this call (checked here, and
    again by the entry): (B, ht, wt, log2 tile, legacy, otsu, contour,
    tiles per block, grid, planes in global memory, plane bytes per tile,
    shared memory bytes), and the geometry."""
    _check_options(canny_impl, binarize_impl)
    B, ht, wt = _check(gray, tile)
    geo = launch_geometry(B * ht * wt, tile)
    return (B, ht, wt, tile.bit_length() - 1, int(canny_impl == "legacy"),
            int(binarize_impl == "otsu"), int(bool(contour_components)), geo.tiles_per_block,
            geo.grid, int(geo.ws_global), geo.ws_bytes, geo.smem), geo


def _launch(gray: torch.Tensor, tile: int, canny_impl: str, binarize_impl: str,
            contour_components: bool) -> torch.Tensor:
    """The kernel on a CUDA tensor: checks, launches, counts the launch."""
    ints, geo = kernel_args(gray, tile, canny_impl, binarize_impl, contour_components)
    B, ht, wt = ints[:3]
    phi = torch.empty((B, ht, wt, 8), dtype=torch.float32, device=gray.device)
    scratch = (torch.empty(geo.scratch_bytes, dtype=torch.uint8, device=gray.device)
               if geo.ws_global else None)
    g5, g11 = _taps()
    _ENTRY.launch(gray.device.index, gray.data_ptr(), phi.data_ptr(),
                  scratch.data_ptr() if scratch is not None else None, *ints, g5, g11)
    phi_tiles.launches += 1
    return phi


# The kernel as a registered op: the plain version on the CPU, the kernel on
# CUDA, an empty (B, ht, wt, 8) tensor while a program is traced (torch.export),
# so an exported program carries the op as a node.
@torch.library.custom_op("mcaq::phi_tiles", mutates_args=(), device_types="cpu")
def _phi_tiles_op(gray: torch.Tensor, tile: int, canny_impl: str, binarize_impl: str,
                  contour_components: bool) -> torch.Tensor:
    _check_options(canny_impl, binarize_impl)
    _check(gray, tile)
    return phi_tiles_torch(gray, tile, canny_impl, binarize_impl, contour_components)


_phi_tiles_op.register_kernel("cuda")(_launch)


@_phi_tiles_op.register_fake
def _(gray, tile, canny_impl, binarize_impl, contour_components):
    B, H, W = gray.shape
    return gray.new_empty((B, H // tile, W // tile, 8))


def phi_tiles(gray: torch.Tensor, tile: int, canny_impl: str = "cv2compat",
              binarize_impl: str = "adaptive", contour_components: bool = True) -> torch.Tensor:
    """phi (B, ht, wt, 8) of a normalized gray map: the kernel on a CUDA
    tensor, the plain version on a CPU tensor, through `mcaq::phi_tiles`."""
    if gray.device.type not in ("cpu", "cuda"):
        raise ValueError(f"phi_tiles: unsupported device {gray.device}")
    return torch.ops.mcaq.phi_tiles(gray, tile, canny_impl, binarize_impl,
                                    bool(contour_components))


phi_tiles.launches = 0


def phi_metrics_tiled(gray: torch.Tensor, tile: int, canny_impl: str = "cv2compat",
                      binarize_impl: str = "adaptive", contour_components: bool = True):
    """JAX's `morphology_lanes.phi_metrics_tiled`: gray (B, Hc, Wc) -> the
    five (B, ht, wt) metric maps, phi1 unhalved (one `phi_tiles` call)."""
    phi = phi_tiles(gray, tile, canny_impl, binarize_impl, contour_components)
    return (phi[..., 0] * 2.0,) + tuple(phi[..., i] for i in range(1, 5))
