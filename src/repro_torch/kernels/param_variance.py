"""Fused replica-mean + variance-probe kernel (port of
``repro/kernels/param_variance.py::mean_and_sqdev``).

The kernel is CUDA C++ for Hopper, ``csrc/mean_sqdev.cu``, built and
loaded by ``kernels/build.py`` at first use; nothing is compiled when this
module is imported.  ``mean_and_sqdev_many`` runs it once over every leaf
of a parameter tree, in one of three modes:

* ``"mean"``: the replica mean of each leaf into an output buffer;
* ``"sync"``: the mean written back into all R replicas, in place;
* ``"delta"``: ``mean − w_r`` into an output buffer of W's size, W only
  read (DaSGD's snapshot);
* ``"sync_to"`` and ``"delta_to"``: the sync and the delta against a
  given mean (a mean buffer, ``mean=``, each value divided by
  ``divisor``) instead of the replicas' own: the mesh backend's
  write-back of the all-reduced sum of the ranks' means (``divisor`` the
  world size) and its DaSGD delta; ``"delta_to"`` may write over its
  leaves (``out`` the buffer whose ``out_views`` they are);

and gives each leaf's Σ_i ||mean − w_i||² (against the given mean in the
``_to`` modes) and S_k = Σ_l sq_l / R.
``mean_and_sqdev`` is the reference's one-leaf contract, the same kernel
with its leaf passed by value.  A CPU tensor goes to the plain version
(``kernels/ref.py``) and a CUDA tensor to the kernel — there is no
fallback: a kernel that fails to build or launch raises.

Each launch adds one to ``mean_and_sqdev.launches`` and the number of
leaves it covered to ``mean_and_sqdev.leaves``.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mean_and_sqdev_many_ref, mean_and_sqdev_ref

SOURCE = build.CSRC / "mean_sqdev.cu"
MODES = {"mean": 0, "sync": 1, "delta": 2,     # Mode in csrc/mean_sqdev.cu
         "sync_to": 3, "delta_to": 4}
GIVEN_MEAN = ("sync_to", "delta_to")          # modes that read ``mean``
NO_OUT = ("sync", "sync_to")                  # modes that write W alone
SMS = 132              # the H100's streaming multiprocessors
BLOCKS_PER_SM = 4      # blocks of the persistent grid on each SM


@functools.cache
def _library() -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return build.load(SOURCE, {
        "repro_mean_sqdev_many_f32": (p, p, i32, i64, i32, i32, i64, p, p,
                                      ctypes.c_float, p, p, p, i32, p),
        "repro_mean_sqdev_f32": (p, p, p, p, p, i32, i64, i32, i64, i64, i32,
                                 p)})


def tile_cols(R: int) -> int:
    """Columns per replica in one tile (``tile_cols_for`` in the source):
    32 KB of W for R <= 8 (8 float4 loads a thread), 64 KB at R = 16."""
    return 1024 * max(1, 8 // R)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class TilePlan(NamedTuple):
    """How one launch covers a tree: a pure function of the leaf sizes
    (elements per replica) and R.  Leaf l has ``cols[l]`` columns a
    replica, cut into ``ceil(cols / tile_cols)`` tiles numbered from
    ``first_tile[l]``; tile t covers the columns ``[(t − first_tile[l])·
    tile_cols, ... + tile_cols)`` of its leaf ``tile_leaf[t]``, clipped at
    ``cols[l]``.  ``vec[l]`` (16-byte loads) is ``cols[l] % 4 == 0``.  A
    mean buffer holds leaf l at ``out_off[l]`` (each leaf rounded up to 4
    columns, so 16-byte rows stay aligned); a delta buffer at ``R ·
    out_off[l]``."""
    R: int
    tile_cols: int
    cols: Tuple[int, ...]
    first_tile: Tuple[int, ...]
    out_off: Tuple[int, ...]
    vec: Tuple[bool, ...]
    tile_leaf: Tuple[int, ...]

    @property
    def n_tiles(self) -> int:
        return len(self.tile_leaf)

    def tile(self, t: int) -> Tuple[int, int, int]:
        """(leaf, first column, end column) of tile t, as the kernel takes
        them."""
        leaf = self.tile_leaf[t]
        start = (t - self.first_tile[leaf]) * self.tile_cols
        return leaf, start, min(start + self.tile_cols, self.cols[leaf])

    def out_numel(self, mode: str) -> int:
        """Elements of the output buffer of ``mode`` (0 for the syncs)."""
        n = self.out_off[-1] + _round4(self.cols[-1])
        return {"mean": n, "sync": 0, "delta": self.R * n, "sync_to": 0,
                "delta_to": self.R * n}[mode]


@functools.lru_cache(maxsize=64)
def tile_plan(cols: Tuple[int, ...], R: int) -> TilePlan:
    """The plan of a tree whose leaves hold ``cols`` elements a replica."""
    if R < 1 or not cols:
        raise ValueError(f"a tile plan needs R >= 1 and a leaf, got R={R}, "
                         f"{len(cols)} leaves")
    width = tile_cols(R)
    first, off, tile_leaf = [], [], []
    n_out = 0
    for leaf, n in enumerate(cols):
        if n < 1:
            raise ValueError(f"leaf {leaf} is empty")
        first.append(len(tile_leaf))
        off.append(n_out)
        n_out += _round4(n)
        tile_leaf.extend([leaf] * -(-n // width))
    return TilePlan(R, width, tuple(cols), tuple(first), tuple(off),
                    tuple(n % 4 == 0 for n in cols), tuple(tile_leaf))


def grid_blocks(n_tiles: int) -> int:
    """The persistent grid: a multiple of the SMs, fixed by the tile count
    alone (the sums do not depend on it: each tile is one block's)."""
    return SMS * min(BLOCKS_PER_SM, -(-n_tiles // SMS))


def _check_leaves(leaves: Sequence[torch.Tensor]) -> int:
    """Raise on what the kernel does not take; returns R."""
    if not leaves:
        raise ValueError("mean_and_sqdev_many needs at least one leaf")
    first = leaves[0]
    if first.dim() < 1:
        raise ValueError("mean_and_sqdev_many needs (R, ...) leaves, got a "
                         "scalar")
    R, device = first.shape[0], first.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"mean_and_sqdev runs on cuda or cpu, not {device}")
    for x in leaves:
        if x.dtype != torch.float32:
            raise TypeError(f"mean_and_sqdev takes float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"mean_and_sqdev_many: leaves lie on {device} "
                             f"and {x.device}; they must share one device")
        if x.dim() < 1 or x.shape[0] != R:
            raise ValueError(f"mean_and_sqdev_many: every leaf needs the "
                             f"replica axis of size {R}, got shape "
                             f"{tuple(x.shape)}")
        if x.numel() == 0:
            raise ValueError(f"mean_and_sqdev needs a non-empty (R, ...) "
                             f"tensor, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("mean_and_sqdev needs contiguous tensors")
    return R


def _plan_of(leaves: Sequence[torch.Tensor]) -> TilePlan:
    R = leaves[0].shape[0]
    return tile_plan(tuple(x.numel() // R for x in leaves), R)


def new_out(leaves: Sequence[torch.Tensor], mode: str) -> torch.Tensor:
    """A flat f32 output buffer for ``mode`` ("mean", "delta" or
    "delta_to") on the leaves' device; a "mean" buffer is also the given
    mean of the ``_to`` modes."""
    return torch.empty(_plan_of(leaves).out_numel(mode), dtype=torch.float32,
                       device=leaves[0].device)


def out_views(out: torch.Tensor, leaves: Sequence[torch.Tensor],
              mode: str) -> List[torch.Tensor]:
    """Each leaf's part of ``out``: its mean (the leaf's shape without the
    replica axis) or its delta (the leaf's shape)."""
    plan = _plan_of(leaves)
    delta = mode in ("delta", "delta_to")
    scale = plan.R if delta else 1
    views = []
    for x, off, n in zip(leaves, plan.out_off, plan.cols):
        shape = x.shape if delta else x.shape[1:]
        views.append(out[scale * off:scale * (off + n)].view(shape))
    return views


# The device tables of the last two trees: (device, R, addresses, sizes) ->
# (plan, leaf table, tile list).  W is written in place between syncs, so a
# tree keeps its key; fresh buffers (a restore) give a new one.  A run syncs
# one tree; a table kept for a tree that is gone holds 4 bytes a tile.
_TABLES: "OrderedDict[tuple, Tuple[TilePlan, torch.Tensor, torch.Tensor]]" \
    = OrderedDict()
_MAX_TABLES = 2


def _device_table(leaves: Sequence[torch.Tensor]
                  ) -> Tuple[TilePlan, torch.Tensor, torch.Tensor]:
    """The leaf table (five int64 a leaf: address, columns, first tile,
    output offset, 16-byte flag) and the tile list (int32) on the leaves'
    device.  The leaves are checked when their table is built; later calls
    on the same addresses and sizes read only those."""
    first = leaves[0]
    if first.dim() < 1:
        _check_leaves(leaves)
    ptrs = tuple(map(torch.Tensor.data_ptr, leaves))
    key = (first.device, first.shape[0], ptrs,
           tuple(map(torch.Tensor.numel, leaves)))
    entry = _TABLES.get(key)
    if entry is not None:
        _TABLES.move_to_end(key)
        return entry
    _check_leaves(leaves)
    plan = _plan_of(leaves)
    rows = [(ptr, n, t0, off, int(vec and ptr % 16 == 0))
            for ptr, n, t0, off, vec in zip(
                ptrs, plan.cols, plan.first_tile, plan.out_off, plan.vec)]
    entry = (plan, torch.tensor(rows, dtype=torch.int64).to(first.device),
             torch.tensor(plan.tile_leaf, dtype=torch.int32).to(first.device))
    _TABLES[key] = entry
    if len(_TABLES) > _MAX_TABLES:
        _TABLES.popitem(last=False)
    return entry


def _check_buffer(buf: Optional[torch.Tensor], n: int, device,
                  what: str) -> None:
    if buf is not None and (
            buf.dtype != torch.float32 or buf.device != device
            or not buf.is_contiguous() or buf.numel() != n
            or buf.data_ptr() % 16):
        raise ValueError(f"{what} must be a contiguous, 16-byte aligned f32 "
                         f"buffer of {n} elements on {device}")


def mean_and_sqdev_many(leaves: Sequence[torch.Tensor], mode: str = "sync",
                        out: Optional[torch.Tensor] = None,
                        mean: Optional[torch.Tensor] = None,
                        divisor: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over every leaf of a stacked-replica tree (f32, contiguous,
    one device, one R).  Returns (sq, S_k): each leaf's Σ_i ||mean −
    w_i||² as an (L,) f32 tensor, and (Σ_l sq_l) / R as an f32 scalar.
    ``mode`` "sync" writes the mean into every replica of each leaf;
    "mean" and "delta" write into ``out``, a flat f32 buffer from
    ``new_out`` (each leaf's part given by ``out_views``).  "sync_to" and
    "delta_to" take the mean from ``mean``, a "mean" buffer, divided by
    ``divisor`` (a true division), instead.  On the card: one launch,
    bitwise repeatable."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    leaves = list(leaves)
    if not leaves:
        raise ValueError("mean_and_sqdev_many needs at least one leaf")
    device = leaves[0].device
    if device.type == "cuda":
        plan, table, tiles = _device_table(leaves)
    else:
        _check_leaves(leaves)
        plan = _plan_of(leaves)
    if (out is None) != (mode in NO_OUT):
        raise ValueError(f"mode {mode!r} takes an out buffer (new_out) if "
                         f"and only if it is not a sync")
    if (mean is None) == (mode in GIVEN_MEAN):
        raise ValueError(f"mode {mode!r} takes a mean buffer (new_out(..., "
                         f"'mean')) if and only if it is one of "
                         f"{GIVEN_MEAN}")
    _check_buffer(out, plan.out_numel(mode), device, "out")
    _check_buffer(mean, plan.out_numel("mean"), device, "mean")
    if divisor != 1 and mode not in GIVEN_MEAN or not divisor >= 1:
        raise ValueError(f"divisor {divisor} needs a mode of {GIVEN_MEAN} "
                         f"and must be at least 1")
    if device.type == "cpu":
        return mean_and_sqdev_many_ref(
            leaves, mode,
            None if out is None else out_views(out, leaves, mode),
            None if mean is None else out_views(mean, leaves, "mean"),
            divisor)
    L = len(leaves)
    partials = torch.empty(plan.n_tiles, dtype=torch.float32, device=device)
    res = torch.empty(L + 1, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().repro_mean_sqdev_many_f32(
            table.data_ptr(), tiles.data_ptr(), L, plan.n_tiles, plan.R,
            MODES[mode], plan.tile_cols,
            None if out is None else out.data_ptr(),
            None if mean is None else mean.data_ptr(), float(divisor),
            partials.data_ptr(),
            res.data_ptr(), res.data_ptr() + 4 * L,
            grid_blocks(plan.n_tiles),
            torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "mean_sqdev")
    mean_and_sqdev.launches += 1
    mean_and_sqdev.leaves += L
    return res[:L], res[L]


def mean_and_sqdev(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: (R, ...) f32, one stacked-replica buffer.  Returns (mean of shape
    ``w.shape[1:]`` in f32, Σ_i ||mean − w_i||² as an f32 scalar tensor).
    Divide the scalar by R for the paper's S_k contribution.  The kernel of
    ``mean_and_sqdev_many`` in mode "mean", with the leaf passed by value
    (no table to build)."""
    if w.dtype != torch.float32:
        raise TypeError(f"mean_and_sqdev takes float32, got {w.dtype}")
    if w.dim() < 1 or w.numel() == 0:
        raise ValueError(f"mean_and_sqdev needs a non-empty (R, ...) "
                         f"tensor, got shape {tuple(w.shape)}")
    if w.device.type == "cpu":
        return mean_and_sqdev_ref(w)
    if w.device.type != "cuda":
        raise ValueError(f"mean_and_sqdev runs on cuda or cpu, not "
                         f"{w.device}")
    if not w.is_contiguous():
        raise ValueError("mean_and_sqdev needs a contiguous tensor")
    rows = w.shape[0]
    cols = w.numel() // rows
    width = tile_cols(rows)
    n_tiles = -(-cols // width)
    mean = torch.empty(w.shape[1:], dtype=torch.float32, device=w.device)
    partials = torch.empty(n_tiles, dtype=torch.float32, device=w.device)
    res = torch.empty(2, dtype=torch.float32, device=w.device)
    vec = cols % 4 == 0 and w.data_ptr() % 16 == 0 and mean.data_ptr() % 16 == 0
    with torch.cuda.device(w.device):
        err = _library().repro_mean_sqdev_f32(
            w.data_ptr(), mean.data_ptr(), partials.data_ptr(),
            res.data_ptr(), res.data_ptr() + 4, rows, cols, int(vec), width,
            n_tiles, grid_blocks(n_tiles),
            torch.cuda.current_stream(w.device).cuda_stream)
    build.check(err, "mean_sqdev")
    mean_and_sqdev.launches += 1
    mean_and_sqdev.leaves += 1
    return mean, res[0]


mean_and_sqdev.launches = 0
mean_and_sqdev.leaves = 0
