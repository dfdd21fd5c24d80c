"""CUDA wrappers of the fused delta pipeline (port of
``repro/kernels/delta_pipeline/delta_pipeline.py``).

``delta_sq_norms_cuda`` launches K2 (per-client Σx², the clip reduction),
``delta_pipeline_apply_cuda`` launches K3 (clip pre-scale → compression
emulation → Eq. 6 weighted sum or masked median / trimmed mean → DP
noise → server momentum → apply) and ``delta_pipeline_partial_cuda``
launches K4 (a fog's clip pre-scale → compression emulation →
UNnormalized weighted sum) from ``csrc/delta_pipeline.cu``. As in the JAX wrapper, the per-client rows
(Eq. 6 weights with the optional staleness discount and damping, the
``[num_sel, k_trim]`` pair, the clip scales) and the (C, L) compression
table (:func:`segment_table`) are computed outside the kernel with
torch ops, on the device, with no host synchronisation (their Python
constants are fills, ``device.scalar``, not copies from the host).

K3's weighted sum, K4 and K1 launch one streaming kernel on a grid and
shared-memory ring that :func:`fedavg_plan` computes here from the
shapes and the card's SM count, and hands the C entries as integers.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream and raises if the launch is refused. Launches are counted
in plain integer attributes, ``delta_sq_norms_cuda.launches`` (K2),
``launch_pipeline.launches`` (K3) and ``launch_partial.launches`` (K4),
which grow by one per launch. ``launch_pipeline.robust_launches`` counts
the K3 launches that went to ``robust_kernel`` (median / trimmed), as the
C entry reports them.
``ops.py`` sends CPU tensors to the plain versions in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.device import scalar
from repro_torch.fl.fuse import segment_ids
from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "delta_pipeline.cu"
_EPS = 1e-12  # matches core.aggregation._EPS
_COMPRESSION = {"none": 0, "int8": 1, "topk": 2}
_AGGREGATOR = {"fedavg": 0, "median": 1, "trimmed": 2}
_OPTIMIZER = {"fedavg": 0, "fedavgm": 1, "fedadam": 2}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# The streaming kernel's constants, as in csrc/delta_pipeline.cu.
CONSUMERS = 256  # consumer threads; one producer warp besides
COLS_PER_THREAD = 4  # so a tile is at most 1,024 columns
MAX_STAGES = 32
MAX_SMEM = 232_448  # 227 KB, the most one block may use
STAGE_BYTES = 16_384  # rows per stage: at least this many bytes ...
MIN_STAGE_ROWS = 32  # ... and at least 32 bytes of each column
NORM_COLS = 1 << 20  # K2: columns of a row per block (kNormCols)


class FedavgPlan(NamedTuple):
    """The streaming kernel's launch: ``blocks`` blocks, each owning one
    range of at most ``cols_per_block`` columns (a multiple of
    ``granule``, 16 bytes of columns), walked in tiles of ``tile_cols``
    columns; a ring of ``stages`` stages of ``rows_per_stage`` client rows
    in ``smem_bytes`` of dynamic shared memory."""

    blocks: int
    granule: int
    cols_per_block: int
    tile_cols: int
    rows_per_stage: int
    stages: int
    smem_bytes: int
    row_stride: int

    def c_args(self) -> tuple[int, int, int, int, int]:
        """The trailing plan arguments of the C entries."""
        return (self.blocks, self.tile_cols, self.rows_per_stage, self.stages,
                self.smem_bytes)

    @property
    def ring_bytes(self) -> int:
        """Bytes of the ring, the most a block has in flight."""
        return self.stages * self.rows_per_stage * self.row_stride


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def ring_offset(c: int, tile_cols: int) -> int:
    """Where the ring starts in the kernel's dynamic shared memory: after
    2 x MAX_STAGES mbarriers, the (C,) weight and clip-scale rows and the
    tile's (tile_cols,) float32 sums; 128-byte aligned."""
    return _align(_align(16 * MAX_STAGES + 8 * c, 16) + 4 * tile_cols, 128)


@functools.lru_cache(maxsize=256)
def fedavg_plan(c: int, p: int, elem_bytes: int, n_sms: int) -> FedavgPlan:
    """The grid and ring of the streaming kernel for a (c, p) buffer of
    ``elem_bytes``-byte elements on a card with ``n_sms`` SMs.

    One block per SM (two were slower), no more blocks than there are
    16-byte granules of columns, each owning the columns
    :func:`block_ranges` gives it. A stage holds the rows of one tile of a
    block's range (``row_stride`` bytes each: the tile and one granule of
    slack for the row's shift), at least ``MIN_STAGE_ROWS / elem_bytes``
    rows and ``STAGE_BYTES``; the ring takes as many stages as the block's
    shared memory holds, up to every stage the block has. A pure function
    of its integers, cached."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"elem_bytes must be 2 or 4, got {elem_bytes}")
    if c < 1 or p < 1 or n_sms < 1:
        raise ValueError(f"bad plan arguments c={c} p={p} n_sms={n_sms}")
    granule = 16 // elem_bytes
    granules = -(-p // granule)
    blocks = min(n_sms, granules)
    cols_per_block = -(-granules // blocks) * granule
    tile_cols = min(cols_per_block, CONSUMERS * COLS_PER_THREAD)
    tiles = -(-cols_per_block // tile_cols)
    row_stride = tile_cols * elem_bytes + 16
    room = MAX_SMEM - ring_offset(c, tile_cols)
    if room < row_stride:
        raise ValueError(f"no room for one row: c={c} p={p}")
    rows = min(c, max(MIN_STAGE_ROWS // elem_bytes, STAGE_BYTES // row_stride))
    stages_needed = tiles * -(-c // rows)
    if stages_needed > 1:  # leave room for two stages
        rows = max(1, min(rows, room // (2 * row_stride)))
        stages_needed = tiles * -(-c // rows)
    stages = min(stages_needed, room // (rows * row_stride), MAX_STAGES)
    smem = ring_offset(c, tile_cols) + stages * rows * row_stride
    return FedavgPlan(blocks, granule, cols_per_block, tile_cols, rows, stages, smem,
                      row_stride)


def block_ranges(p: int, granule: int, blocks: int) -> list[tuple[int, int]]:
    """The column range [lo, hi) of each block, as the kernel computes it:
    the ceil(p / granule) granules split as evenly as they go, the first
    ``granules % blocks`` blocks one granule more; the last range ends at p."""
    granules = -(-p // granule)
    per, extra = divmod(granules, blocks)
    out = []
    for b in range(blocks):
        g_lo = b * per + min(b, extra)
        g_hi = g_lo + per + (1 if b < extra else 0)
        out.append((g_lo * granule, min(g_hi * granule, p)))
    return out


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(updates: torch.Tensor) -> FedavgPlan:
    """:func:`fedavg_plan` for a (C, P) CUDA buffer on its own card."""
    c, p = updates.shape
    index = updates.device.index
    if index is None:
        index = torch.cuda.current_device()
    return fedavg_plan(c, p, updates.element_size(), sm_count(index))


@functools.cache
def library():
    """Build (first use) and load the kernels; returns the KernelLibrary.
    Cached: the source hash is taken once, not on every launch."""
    kl = load_library("fedfog_delta_pipeline", [SOURCE])
    kl.lib.fedfog_delta_sq_norms.argtypes = [_P, _P, _P, _I, _LL, _P]
    kl.lib.fedfog_delta_sq_norms.restype = _I
    kl.lib.fedfog_delta_pipeline.argtypes = (
        [_P] * 11 + [_I, _I, _LL, _F, _F, _I, _I, _I] + [_I] * 5 + [_P]
    )
    kl.lib.fedfog_delta_pipeline.restype = _I
    kl.lib.fedfog_robust_launches.argtypes = []
    kl.lib.fedfog_robust_launches.restype = _LL
    kl.lib.fedfog_delta_pipeline_partial.argtypes = (
        [_P] * 6 + [_I, _I, _LL, _I] + [_I] * 5 + [_P]
    )
    kl.lib.fedfog_delta_pipeline_partial.restype = _I
    return kl


def _check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed (code {rc})")


def delta_sq_norms_cuda(updates: torch.Tensor) -> torch.Tensor:
    """K2: per-client Σx² over the fused (C, P) delta buffer -> (C,) f32.
    Each block sums one row's span of ``NORM_COLS`` columns; a row of more
    than one span takes a (C, spans) scratch for the span sums, which a
    second kernel adds in a fixed order."""
    if updates.dim() != 2:
        raise ValueError(f"updates must be (C, P), got {tuple(updates.shape)}")
    c, p = updates.shape
    _check(updates, "updates", (c, p))
    if c > 65535:
        raise ValueError(f"delta_sq_norms supports C <= 65535 clients, got {c}")
    out = torch.empty((c,), dtype=torch.float32, device=updates.device)
    n_spans = -(-p // NORM_COLS)
    spans = (torch.empty((c * n_spans,), dtype=torch.float32, device=updates.device)
             if n_spans > 1 else None)
    lib = library().lib
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        _raise_on(
            lib.fedfog_delta_sq_norms(updates.data_ptr(), out.data_ptr(), _ptr(spans),
                                      c, p, stream),
            "delta_sq_norms",
        )
    delta_sq_norms_cuda.launches += 1
    return out


delta_sq_norms_cuda.launches = 0


def segment_table(updates, compression, topk_fraction, seg_sizes, pre=None):
    """(C, L) compression table: int8 dequant scales or top-k thresholds.

    The single definition of the per-(client, leaf) reduction, shared by
    ``fl.compression.apply_compression`` and the kernel wrapper, over
    static leaf slices, so no temporary is larger than one leaf's rows.
    int8: ``max|x|/127 + 1e-12`` per leaf; top-k: the kth-largest |x| per
    leaf (``torch.topk``). ``pre`` (C,) positive clip scales rescale a
    table computed on the raw deltas, as in the JAX wrapper.
    """
    cols, off = [], 0
    for sz in seg_sizes:
        sl = torch.abs(updates[:, off:off + sz])
        if compression == "int8":
            cols.append(torch.amax(sl, dim=1, keepdim=True))
        else:
            k = max(1, int(sz * topk_fraction))
            cols.append(torch.topk(sl, k, dim=1).values[:, -1:])
        off += sz
    tab = torch.cat(cols, dim=1)
    if pre is not None:
        tab = tab * pre[:, None]
    return tab / 127.0 + 1e-12 if compression == "int8" else tab


def validate(updates, compression, seg_sizes, aggregator, staleness):
    """The JAX wrapper's argument checks, shared with the plain version."""
    if compression not in _COMPRESSION:
        raise ValueError(f"unknown compression {compression!r}")
    if compression != "none" and seg_sizes is None:
        raise ValueError("compression requires seg_sizes (fused leaf sizes)")
    if compression != "none" and int(sum(seg_sizes)) != updates.shape[1]:
        raise ValueError(f"seg_sizes sum {sum(seg_sizes)} != P {updates.shape[1]}")
    if aggregator not in _AGGREGATOR:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if aggregator != "fedavg" and staleness is not None:
        raise ValueError(
            f"aggregator={aggregator!r} is unweighted; staleness weighting "
            "does not compose with it"
        )


def pipeline_rows(
    updates, mask, weights, staleness, staleness_exponent, trim_fraction,
    *, clip_norm, compression, topk_fraction, seg_sizes, aggregator,
    sq_norms=delta_sq_norms_cuda,
):
    """The per-client rows and the compression table K3 reads, computed
    with torch ops as the JAX wrapper computes them outside Pallas.

    Returns ``(wn, cnt, pre, seg, tab)``: (C,) Eq. 6 weights (or the 0/1
    mask for the robust aggregators), the (2,) int32 ``[num_sel, k_trim]``
    pair (robust only), (C,) clip scales, (P,) int32 leaf ids and the
    (C, L) table (compression only). ``sq_norms`` is the K2 launcher; the
    CPU tests pass its plain version.
    """
    dev = updates.device
    cnt = None
    if aggregator in ("median", "trimmed"):
        wn = mask.to(torch.float32)
        num_sel = torch.sum(mask.to(torch.int32))
        k_trim = torch.floor(
            num_sel.to(torch.float32) * scalar(trim_fraction, dev)
        ).to(torch.int32)
        cnt = torch.stack([num_sel, k_trim]).to(torch.int32)
    else:
        m = mask.to(torch.float32) * weights.to(torch.float32)
        if staleness is not None:
            # (1+s)^-a discount + global damping (the async_aggregate rule,
            # equal to plain Eq. 6 at zero staleness).
            s = torch.clamp(staleness.to(torch.float32), min=0.0)
            disc = (1.0 + s) ** (-scalar(staleness_exponent, dev))
            dm = m * disc
            wn = dm / (torch.sum(dm) + _EPS)
            wn = wn * ((torch.sum(dm) + _EPS) / (torch.sum(m) + _EPS))
        else:
            wn = m / (torch.sum(m) + _EPS)
    return (wn, cnt) + gate_rows(
        updates, clip_norm, compression, topk_fraction, seg_sizes, sq_norms
    )


def gate_rows(updates, clip_norm, compression, topk_fraction, seg_sizes,
              sq_norms=delta_sq_norms_cuda):
    """``(pre, seg, tab)``: (C,) clip scales from K2's norms (clip only),
    (P,) int32 leaf ids and the (C, L) table on the raw deltas, rescaled
    by ``pre`` (compression only); None where the gate is off."""
    dev = updates.device
    pre = None
    if clip_norm and clip_norm > 0:
        norm = torch.sqrt(sq_norms(updates))
        pre = torch.clamp(scalar(clip_norm, dev) / torch.clamp(norm, min=1e-12), max=1.0)
    seg = tab = None
    if compression != "none":
        seg = segment_ids(seg_sizes, dev)
        tab = segment_table(updates, compression, topk_fraction, seg_sizes, pre=pre)
    return pre, seg, tab


def delta_pipeline_apply_cuda(
    updates: torch.Tensor,  # (C, P) fused client deltas
    base: torch.Tensor,  # (P,) fused global model
    mask: torch.Tensor,  # (C,) bool participation
    weights: torch.Tensor,  # (C,) |D_i| dataset sizes
    lr: float = 1.0,
    staleness: torch.Tensor | None = None,
    staleness_exponent: float = 0.0,
    dp_noise: torch.Tensor | None = None,
    momentum: torch.Tensor | None = None,
    trim_fraction: float = 0.1,
    *,
    clip_norm: float = 0.0,
    compression: str = "none",
    topk_fraction: float = 0.05,
    seg_sizes: tuple[int, ...] | None = None,
    server_optimizer: str = "fedavg",
    server_momentum: float = 0.9,
    aggregator: str = "fedavg",
):
    """K3: one pass over the (C, P) buffer. Returns the updated (P,) model,
    or ``(model, new_mu)`` when ``momentum`` is given with a momentum
    server optimizer. Same gates and semantics as the JAX function."""
    if updates.dim() != 2:
        raise ValueError(f"updates must be (C, P), got {tuple(updates.shape)}")
    c, p = updates.shape
    validate(updates, compression, seg_sizes, aggregator, staleness)
    if aggregator != "fedavg" and c > 256:
        raise ValueError(f"median / trimmed support C <= 256 clients, got {c}")
    if c > 4096:
        raise ValueError(f"the kernel supports C <= 4096 clients, got {c}")
    if server_optimizer not in _OPTIMIZER:
        raise ValueError(f"unknown server_optimizer {server_optimizer!r}")
    _check(updates, "updates", (c, p))
    _check(base, "base", (p,))
    _check(mask, "mask", (c,), torch.bool)
    _check(weights, "weights", (c,))
    has_mu = momentum is not None and server_optimizer in ("fedavgm", "fedadam")
    if dp_noise is not None:
        _check(dp_noise, "dp_noise", (p,))
    if has_mu:
        _check(momentum, "momentum", (p,))
    if staleness is not None:
        _check(staleness, "staleness", (c,), staleness.dtype)
    wn, cnt, pre, seg, tab = pipeline_rows(
        updates, mask, weights, staleness, staleness_exponent, trim_fraction,
        clip_norm=clip_norm, compression=compression,
        topk_fraction=topk_fraction, seg_sizes=seg_sizes, aggregator=aggregator,
    )
    out = torch.empty_like(base)
    new_mu = torch.empty_like(momentum) if has_mu else None
    launch_pipeline(
        updates, base, wn, cnt, pre, seg, tab, dp_noise,
        momentum if has_mu else None, out, new_mu,
        lr=lr, server_momentum=server_momentum, compression=compression,
        aggregator=aggregator,
        server_optimizer=server_optimizer if has_mu else "fedavg",
    )
    return (out, new_mu) if has_mu else out


def launch_pipeline(
    updates, base, wn, cnt, pre, seg, tab, noise, mu, out, new_mu, *,
    lr, server_momentum, compression, aggregator, server_optimizer,
):
    """Launch K3 on prepared rows (see :func:`pipeline_rows`) into the
    caller's ``out`` / ``new_mu``. The one place K3 is launched, and so the
    one place its ``launches`` count grows."""
    c, p = updates.shape
    n_leaves = tab.shape[1] if tab is not None else 0
    lib = library().lib
    robust_before = lib.fedfog_robust_launches()
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        rc = lib.fedfog_delta_pipeline(
            updates.data_ptr(), base.data_ptr(), wn.data_ptr(), _ptr(cnt),
            _ptr(pre), _ptr(seg), _ptr(tab), _ptr(noise), _ptr(mu),
            out.data_ptr(), _ptr(new_mu), c, n_leaves, p, float(lr),
            float(server_momentum), _COMPRESSION[compression],
            _AGGREGATOR[aggregator], _OPTIMIZER[server_optimizer],
            *device_plan(updates).c_args(), stream,
        )
    _raise_on(rc, "delta_pipeline_apply")
    launch_pipeline.launches += 1
    launch_pipeline.robust_launches += lib.fedfog_robust_launches() - robust_before


launch_pipeline.launches = 0
launch_pipeline.robust_launches = 0


def delta_pipeline_partial_cuda(
    updates: torch.Tensor,  # (C_local, P) fused deltas of one fog's clients
    dm: torch.Tensor,  # (C_local,) UNnormalized Eq. 6 weights (mask·|D|·disc)
    *,
    clip_norm: float = 0.0,
    compression: str = "none",
    topk_fraction: float = 0.05,
    seg_sizes: tuple[int, ...] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4: one pass over a fog's (C_local, P) block -> the (P,) partial
    ``Σ_i dm_i·T(x_i)``, T = clip pre-scale then compression emulation
    with fog-local norms and table. Same gates as the JAX function.
    ``out``, a contiguous (P,) float32 tensor, takes the partial in place
    of a new one (the sharded pass's (P+2,) pack)."""
    if updates.dim() != 2:
        raise ValueError(f"updates must be (C, P), got {tuple(updates.shape)}")
    c, p = updates.shape
    validate(updates, compression, seg_sizes, "fedavg", None)
    if c > 4096:
        raise ValueError(f"the kernel supports C <= 4096 clients, got {c}")
    _check(updates, "updates", (c, p))
    _check(dm, "dm", (c,))
    pre, seg, tab = gate_rows(updates, clip_norm, compression, topk_fraction, seg_sizes)
    if out is None:
        out = torch.empty((p,), dtype=torch.float32, device=updates.device)
    _check(out, "out", (p,))
    launch_partial(updates, dm, pre, seg, tab, out, compression=compression)
    return out


def launch_partial(updates, dm, pre, seg, tab, out, *, compression):
    """Launch K4 on prepared rows (see :func:`gate_rows`) into ``out``. The
    one place K4 is launched, and so the one place its count grows."""
    c, p = updates.shape
    n_leaves = tab.shape[1] if tab is not None else 0
    lib = library().lib
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        rc = lib.fedfog_delta_pipeline_partial(
            updates.data_ptr(), dm.data_ptr(), _ptr(pre), _ptr(seg), _ptr(tab),
            out.data_ptr(), c, n_leaves, p, _COMPRESSION[compression],
            *device_plan(updates).c_args(), stream,
        )
    _raise_on(rc, "delta_pipeline_partial")
    launch_partial.launches += 1


launch_partial.launches = 0
