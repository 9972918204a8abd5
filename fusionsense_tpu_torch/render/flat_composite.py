"""Flat segmented pair compositing: kernels K1 (forward) and K2 (backward).

Counterpart of fusionsense_tpu/render/pallas_flat.py. Tiles own contiguous,
variable-length runs of 128-pair blocks of one (pair_budget, 8 + C) table
[mx, my, ca, cb, cc, log_op, abs_tap_x, abs_tap_y, chan...]:

- K1 composites each tile's blocks front to back. A block is skipped when it
  holds no pair or when EVERY pixel of its tile is already saturated
  (log T <= -9.21); until then saturated pixels keep accumulating. It writes
  out (T+1, C, P), the final log-transmittance (T+1, P) and the log T
  entering every block, `carry` (nb, P). Row T is the dummy tile that owns
  the blocks past the live population.
- K2 writes the table gradient dtab (PB, 8 + C) of the live blocks: d mx,
  d my, d ca, d cb, d cc, d log_op, |d mx|, |d my| (gsplat's absgrad, in the
  zero-valued abs_tap columns) and d chan. Dead and dummy blocks get zero
  rows.

A block entered at log T `L` adds exp(L) * acc_b to out and delta_b to
log T, where acc_b (nb, C, P) and delta_b (nb, P) are the block's own blend
and sum of log(1 - alpha) from T = 1. So each kernel is a few stages, none
of which walks a run's blocks with the blending math (csrc/flat_composite.cu
gives the design):

  K1: fwd_blocks (delta, acc per block) -> fwd_scan (the skip rule: carry,
      live, log T per tile) -> fwd_combine (out = sum of exp(carry) * acc)
  K2: bwd_suffix (S per block, from acc and the cotangents) -> bwd_blocks
      (each live block's gradient rows from its carry, exit log T and S)

K1 returns (out, logT, carry, acc, live); K2 takes the last four back.
Every stage exists twice: a CUDA kernel and a plain tensor version with the
same semantics, vectorised over blocks or over tiles. A wrapper sends a CPU
tensor to the plain version and a CUDA tensor to the kernel; there is no
fallback between the two. Every row of out/logT is written by both (tiles
without blocks get out = 0, log T = 0), which gives the reference's
_mask_empty semantics by construction.

blend_bf16 is the reference's bf16 blend (pallas_flat.py's blend_bf16
branch): both operands of each blend product (acc = chan^T w; backward
q = chan g_out and d chan = w g_out^T) are rounded to bfloat16 and the
products summed in float32; the alpha math stays float32. Every stage that
forms such a product takes the flag: fwd_blocks, bwd_suffix (its q reads
g_out) and bwd_blocks. The plain versions round with .to(torch.bfloat16),
which is round to nearest even, as the kernels' __float2bfloat16_rn. A
block forms w from T = 1 and the reference from the tile's running T, so
a rounded w may differ from the reference's by one bf16 ulp. The suffix S
of K2 is a sum of w * q with w float32 in the reference, so under the flag
fwd_blocks also returns sacc, the blend with w left float32, and K1 hands
K2 sacc in place of acc (the same tensor without the flag).

The kernels leave out the rows cull_rows marks (dead slots and other rows
that give alpha = 0 at every pixel of their tile); the plain versions take
them, which adds exact zeros (csrc/flat_composite.cu states why). Both
versions of fwd_blocks also return `kept`, the rows of each block that the
kernel stages, so the kernel's cull is held against cull_rows.
"""
from __future__ import annotations

import math

import torch

from fusionsense_tpu_torch.kernels.build import Launches, check, launch

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
LOG_ALPHA_MAX = math.log(ALPHA_MAX)
T_EPS_LOG = -9.21
CULL_LOG_OP = -15.0       # the cull's bounds, as in csrc/flat_composite.cu
CULL_QUAD_MAX = 1e5
_CHUNK = 64               # blocks a plain block stage takes at once

# launch counts (kernels/build.py Launches), one per K1 or K2 call
_COUNTS = Launches(("flat_composite_fwd", "flat_composite_bwd"),
                   plain=("flat_composite_fwd_plain",
                          "flat_composite_bwd_plain"))
LAUNCHES, CAPTURED = _COUNTS.counts, _COUNTS.captured
reset_launch_counts, _count = _COUNTS.reset, _COUNTS.count


def blend_operand(x: torch.Tensor, blend_bf16: bool) -> torch.Tensor:
    """x as a blend product takes it: rounded to bfloat16 (nearest even)
    and back under blend_bf16, else x itself."""
    return x.to(torch.bfloat16).to(x.dtype) if blend_bf16 else x


def tile_runs(blk_tile: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """(num_tiles + 2,) int32 run boundaries: tile t (t <= num_tiles, the
    dummy included) owns blocks [runs[t], runs[t+1]). blk_tile must be
    non-decreasing, as flat_bin_gaussians lays it out."""
    q = torch.arange(num_tiles + 2, dtype=torch.int32, device=blk_tile.device)
    return torch.searchsorted(blk_tile.to(torch.int32), q, out_int32=True)


def block_tiles(runs: torch.Tensor, nb: int) -> torch.Tensor:
    """(nb,) int64 tile of each block, from the run boundaries."""
    b = torch.arange(nb, dtype=runs.dtype, device=runs.device)
    return torch.searchsorted(runs[:-1].contiguous(), b, right=True) - 1


def cull_rows(table, blk_tile, tiles_x, tile_size, B=128, tile_lo=0):
    """(nb, B) bool: rows that give alpha = 0 and alive = False at every
    pixel of their block's tile: finite, log_op <= -15, a PSD conic, and the
    conic's quadratic form bounded over the tile (csrc/flat_composite.cu
    states the argument). blk_tile holds local tile ids; the tile's pixels
    are those of global tile blk_tile + tile_lo."""
    PB, W = table.shape
    rows = table.reshape(PB // B, B, W)
    mx, my = rows[..., 0], rows[..., 1]
    ca, cb, cc, lo = rows[..., 2], rows[..., 3], rows[..., 4], rows[..., 5]
    tile = blk_tile.long() + tile_lo
    x0 = ((tile % tiles_x) * tile_size).to(torch.float32)[:, None] + 0.5
    y0 = ((tile // tiles_x) * tile_size).to(torch.float32)[:, None] + 0.5
    span = float(tile_size - 1)
    X = torch.maximum((x0 - mx).abs(), (x0 + span - mx).abs())
    Y = torch.maximum((y0 - my).abs(), (y0 + span - my).abs())
    quad = 0.5 * ca * X * X + cb.abs() * X * Y + 0.5 * cc * Y * Y
    return (torch.isfinite(rows).all(dim=-1) & (lo <= CULL_LOG_OP)
            & (ca >= 0) & (cc >= 0) & (ca * cc >= cb * cb)
            & (quad <= CULL_QUAD_MAX))


# ------------------------------------------------------------ plain ------

def _pixel_xy(tile: torch.Tensor, tiles_x: int, tile_size: int, P: int,
              tile_lo: int = 0):
    """Pixel centers (t, 1, P) of the given local tile ids, whose global ids
    are tile + tile_lo."""
    ts = tile_size
    tile = tile + tile_lo
    ox = ((tile % tiles_x) * ts).to(torch.float32)[:, None, None]
    oy = ((tile // tiles_x) * ts).to(torch.float32)[:, None, None]
    lane = torch.arange(P, device=tile.device)
    px = ox + (lane % ts).to(torch.float32) + 0.5
    py = oy + (lane // ts).to(torch.float32) + 0.5
    return px, py


def _alpha_of_rows(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """rows (t, B, >=6) [mx, my, ca, cb, cc, log_op] -> alpha (t, B, P)."""
    mx, my = rows[..., 0:1], rows[..., 1:2]
    ca, cb, cc, lo = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5], rows[..., 5:6]
    dx = px - mx
    dy = py - my
    power = -(0.5 * ca * dx * dx + cb * dx * dy + 0.5 * cc * dy * dy) + lo
    alpha_raw = torch.exp(torch.clamp_max(power, LOG_ALPHA_MAX))
    alive = (alpha_raw >= ALPHA_MIN) & (power < LOG_ALPHA_MAX)
    alpha = torch.where(alpha_raw < ALPHA_MIN, torch.zeros_like(alpha_raw),
                        alpha_raw)
    return alpha, alive, (dx, dy, ca, cb, cc)


def _runs_by_position(runs: torch.Tensor):
    start = runs[:-1].long()
    length = (runs[1:] - runs[:-1]).long()
    return start, length, int(length.max()) if length.numel() else 0


def _at_position(start, length, k):
    """Tiles whose run has a k-th block, and that block."""
    tiles = torch.nonzero(k < length).squeeze(1)
    return tiles, start[tiles] + k


def fwd_blocks_plain(table, runs, blk_count, tiles_x, tile_size, B=128,
                     blend_bf16=False, tile_lo=0):
    """Stage 1 of K1: every block with count > 0 composited by itself from
    T = 1. Returns delta (nb, P), the block's sum of log(1 - alpha), and
    acc (nb, C, P), its blend, zeros elsewhere; kept (nb,) int32, the rows
    of each block with count > 0 that cull_rows keeps, 0 elsewhere; sacc,
    the blend K2's suffix reads: acc itself, or under blend_bf16 the blend
    with w left float32."""
    PB, W = table.shape
    C, P, nb = W - 8, tile_size * tile_size, PB // B
    tab = table.reshape(nb, B, W)
    tile = block_tiles(runs, nb)
    f32 = dict(dtype=torch.float32, device=table.device)
    delta = torch.zeros((nb, P), **f32)
    acc = torch.zeros((nb, C, P), **f32)
    sacc = torch.zeros((nb, C, P), **f32) if blend_bf16 else acc
    kept = torch.where(
        blk_count > 0,
        B - cull_rows(table, tile, tiles_x, tile_size, B, tile_lo).sum(1),
        0).to(torch.int32)
    for bl in torch.nonzero(blk_count > 0).squeeze(1).split(_CHUNK):
        rows = tab[bl]
        px, py = _pixel_xy(tile[bl], tiles_x, tile_size, P, tile_lo)
        alpha, _, _ = _alpha_of_rows(rows, px, py)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        w = alpha * torch.exp(cum - lg)
        chan = blend_operand(rows[..., 8:], blend_bf16)
        acc[bl] = torch.einsum("tbc,tbp->tcp", chan,
                               blend_operand(w, blend_bf16))
        if blend_bf16:
            sacc[bl] = torch.einsum("tbc,tbp->tcp", chan, w)
        delta[bl] = cum[:, -1, :]
    return delta, acc, kept, sacc


def fwd_scan_plain(delta, runs, blk_count):
    """Stage 2 of K1: the skip rule along each run. Returns carry (nb, P),
    the log T entering each block; live (nb,) int32, whether the block is
    composited; logT (T+1, P), each tile's final log T."""
    nb, P = delta.shape
    start, length, max_len = _runs_by_position(runs)
    log_t = torch.zeros((start.numel(), P), dtype=torch.float32,
                        device=delta.device)
    carry = torch.zeros((nb, P), dtype=torch.float32, device=delta.device)
    live = torch.zeros((nb,), dtype=torch.int32, device=delta.device)
    for k in range(max_len):
        tiles, blk = _at_position(start, length, k)
        lt = log_t[tiles]
        carry[blk] = lt
        lv = (blk_count[blk] > 0) & (lt.max(dim=1).values > T_EPS_LOG)
        live[blk] = lv.to(torch.int32)
        log_t[tiles[lv]] = lt[lv] + delta[blk[lv]]
    return carry, live, log_t


def fwd_combine_plain(acc, carry, live, runs):
    """Stage 3 of K1: out (T+1, C, P), the sum over each run's live blocks
    of exp(carry) * acc, in order."""
    _, C, P = acc.shape
    start, length, max_len = _runs_by_position(runs)
    out = torch.zeros((start.numel(), C, P), dtype=torch.float32,
                      device=acc.device)
    for k in range(max_len):
        tiles, blk = _at_position(start, length, k)
        lv = live[blk] > 0
        tl, bl = tiles[lv], blk[lv]
        out[tl] += torch.exp(carry[bl])[:, None, :] * acc[bl]
    return out


def bwd_suffix_plain(acc, carry, live, runs, g_out, blend_bf16=False):
    """Stage 1 of K2: S (nb, P), the sum over each block's later live blocks
    of exp(carry) * sum_c g_out[c] * acc[c] (each block's sum of w * q;
    acc is fwd_blocks' sacc, and g_out is rounded as q's operand under
    blend_bf16)."""
    nb, _, P = acc.shape
    g_out = blend_operand(g_out, blend_bf16)
    start, length, max_len = _runs_by_position(runs)
    s = torch.zeros((start.numel(), P), dtype=torch.float32, device=acc.device)
    S = torch.zeros((nb, P), dtype=torch.float32, device=acc.device)
    for k in reversed(range(max_len)):
        tiles, blk = _at_position(start, length, k)
        S[blk] = s[tiles]
        lv = live[blk] > 0
        tl, bl = tiles[lv], blk[lv]
        s[tl] += torch.exp(carry[bl]) * torch.einsum("tcp,tcp->tp",
                                                     g_out[tl], acc[bl])
    return S


def bwd_blocks_plain(table, runs, live, g_out, g_logt, logt, carry, S,
                     tiles_x, tile_size, B=128, blend_bf16=False, tile_lo=0):
    """Stage 2 of K2: dtab (PB, 8 + C) of the live blocks, each replayed from
    its carry with its suffix S; dead blocks get zeros."""
    PB, W = table.shape
    P, nb = tile_size * tile_size, PB // B
    tab = table.reshape(nb, B, W)
    tile = block_tiles(runs, nb)
    dtab = torch.zeros((nb, B, W), dtype=torch.float32, device=table.device)
    t_fin = torch.exp(logt)
    for bl in torch.nonzero(live > 0).squeeze(1).split(_CHUNK):
        tl = tile[bl]
        rows = tab[bl]
        chan = rows[..., 8:]
        go = g_out[tl]                                      # (t, C, P)
        glt = g_logt[tl][:, None, :]
        tf = t_fin[tl][:, None, :]
        px, py = _pixel_xy(tl, tiles_x, tile_size, P, tile_lo)
        alpha, alive, (dx, dy, ca, cb, cc) = _alpha_of_rows(rows, px, py)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        t_excl = torch.exp(carry[bl][:, None, :] + cum - lg)
        w = alpha * t_excl
        go_b = blend_operand(go, blend_bf16)
        q = torch.einsum("tbc,tcp->tbp", blend_operand(chan, blend_bf16), go_b)
        a_term = w * q
        cum_a = torch.cumsum(a_term, dim=1)
        suffix = (cum_a[:, -1:, :] - cum_a) + S[bl][:, None, :]
        inv1m = 1.0 / (1.0 - alpha)
        d_alpha = q * t_excl - suffix * inv1m - glt * tf * inv1m
        d_power = torch.where(alive, alpha * d_alpha, torch.zeros_like(alpha))
        gx = ca * dx + cb * dy
        gy = cb * dx + cc * dy
        d_mx = torch.sum(d_power * gx, -1)
        d_my = torch.sum(d_power * gy, -1)
        d_ca = torch.sum(d_power * (-0.5 * dx * dx), -1)
        d_cb = torch.sum(d_power * (-dx * dy), -1)
        d_cc = torch.sum(d_power * (-0.5 * dy * dy), -1)
        d_lo = torch.sum(d_power, -1)
        d_chan = torch.einsum("tbp,tcp->tbc", blend_operand(w, blend_bf16),
                              go_b)
        dtab[bl] = torch.cat(
            [torch.stack([d_mx, d_my, d_ca, d_cb, d_cc, d_lo, d_mx.abs(),
                          d_my.abs()], -1), d_chan], -1)
    return dtab.reshape(PB, W)


def flat_composite_fwd_plain(table, runs, blk_count, num_tiles, tiles_x,
                             tile_size, B=128, blend_bf16=False, tile_lo=0):
    """Plain K1: returns (out (T+1, C, P), logT (T+1, P), carry (nb, P),
    sacc (nb, C, P), live (nb,) int32); sacc is fwd_blocks' blend for K2's
    suffix. tile_lo is the global id of local tile 0."""
    LAUNCHES["flat_composite_fwd_plain"] += 1
    delta, acc, _, sacc = fwd_blocks_plain(table, runs, blk_count, tiles_x,
                                           tile_size, B, blend_bf16, tile_lo)
    carry, live, logt = fwd_scan_plain(delta, runs, blk_count)
    return fwd_combine_plain(acc, carry, live, runs), logt, carry, sacc, live


def flat_composite_bwd_plain(table, runs, g_out, g_logt, logt, carry, acc,
                             live, tiles_x, tile_size, B=128,
                             blend_bf16=False, tile_lo=0):
    """Plain K2: g_out (T+1, C, P), g_logt/logt (T+1, P) and K1's carry,
    sacc (as acc) and live -> dtab (PB, 8 + C)."""
    LAUNCHES["flat_composite_bwd_plain"] += 1
    S = bwd_suffix_plain(acc, carry, live, runs, g_out, blend_bf16)
    return bwd_blocks_plain(table, runs, live, g_out, g_logt, logt, carry, S,
                            tiles_x, tile_size, B, blend_bf16, tile_lo)


# ----------------------------------------------------------- kernels ------

_C_SUPPORTED = 8
_FNS = {   # C entry point -> (pointer arguments, int arguments)
    "fs_flat_fwd_blocks": (7, 8), "fs_flat_fwd_scan": (6, 2),
    "fs_flat_fwd_combine": (5, 3), "fs_flat_bwd_suffix": (6, 4),
    "fs_flat_bwd_blocks": (9, 8),
}


def _check_geometry(table, tile_size, B):
    PB, W = table.shape
    P = tile_size * tile_size
    if W - 8 != _C_SUPPORTED:
        raise ValueError(f"the CUDA kernels take C = {_C_SUPPORTED} channels, "
                         f"got a table of width {W}")
    if P % 32 or P > 1024:
        raise ValueError(f"tile_size {tile_size}: the kernels need "
                         "tile_size**2 a multiple of 32 and at most 1024")
    if B % 16 or B > 256 or PB % B:
        raise ValueError(f"block {B}: needs a multiple of 16, at most 256, "
                         "dividing the pair budget")


def _launch(fn, tensors, ints):
    launch("flat_composite", _FNS, fn, tensors, ints)


_F32, _I32 = torch.float32, torch.int32


def fwd_blocks_cuda(table, runs, blk_count, tiles_x, tile_size, B=128,
                    blend_bf16=False, tile_lo=0):
    """Stage 1 of K1 on the card; same returns as fwd_blocks_plain."""
    _check_geometry(table, tile_size, B)
    PB, W = table.shape
    C, P, nb = W - 8, tile_size * tile_size, PB // B
    check(table.device, ("table", table, _F32, (PB, W)),
          ("runs", runs, _I32, (runs.numel(),)),
          ("blk_count", blk_count, _I32, (nb,)))
    delta = torch.empty((nb, P), dtype=_F32, device=table.device)
    acc = torch.empty((nb, C, P), dtype=_F32, device=table.device)
    sacc = torch.empty_like(acc) if blend_bf16 else acc
    kept = torch.empty((nb,), dtype=_I32, device=table.device)
    _launch("fs_flat_fwd_blocks",
            (table, runs, blk_count, delta, acc, sacc, kept),
            (nb, runs.numel() - 1, tiles_x, tile_size, B, C, int(blend_bf16),
             tile_lo))
    return delta, acc, kept, sacc


def fwd_scan_cuda(delta, runs, blk_count):
    """Stage 2 of K1 on the card; same returns as fwd_scan_plain."""
    nb, P = delta.shape
    T1 = runs.numel() - 1
    check(delta.device, ("delta", delta, _F32, (nb, P)),
          ("runs", runs, _I32, (T1 + 1,)),
          ("blk_count", blk_count, _I32, (nb,)))
    carry = torch.empty((nb, P), dtype=_F32, device=delta.device)
    live = torch.empty((nb,), dtype=_I32, device=delta.device)
    logt = torch.empty((T1, P), dtype=_F32, device=delta.device)
    _launch("fs_flat_fwd_scan", (delta, runs, blk_count, carry, live, logt),
            (T1, P))
    return carry, live, logt


def fwd_combine_cuda(acc, carry, live, runs):
    """Stage 3 of K1 on the card; same returns as fwd_combine_plain."""
    nb, C, P = acc.shape
    T1 = runs.numel() - 1
    check(acc.device, ("acc", acc, _F32, (nb, C, P)),
          ("carry", carry, _F32, (nb, P)), ("live", live, _I32, (nb,)),
          ("runs", runs, _I32, (T1 + 1,)))
    out = torch.empty((T1, C, P), dtype=_F32, device=acc.device)
    _launch("fs_flat_fwd_combine", (acc, carry, live, runs, out), (T1, P, C))
    return out


def bwd_suffix_cuda(acc, carry, live, runs, g_out, blend_bf16=False):
    """Stage 1 of K2 on the card; same returns as bwd_suffix_plain."""
    nb, C, P = acc.shape
    T1 = runs.numel() - 1
    if C != _C_SUPPORTED:
        raise ValueError(f"the CUDA kernels take C = {_C_SUPPORTED} channels")
    check(acc.device, ("acc", acc, _F32, (nb, C, P)),
          ("carry", carry, _F32, (nb, P)), ("live", live, _I32, (nb,)),
          ("runs", runs, _I32, (T1 + 1,)),
          ("g_out", g_out, _F32, (T1, C, P)))
    S = torch.empty((nb, P), dtype=_F32, device=acc.device)
    _launch("fs_flat_bwd_suffix", (acc, carry, live, runs, g_out, S),
            (T1, P, C, int(blend_bf16)))
    return S


def bwd_blocks_cuda(table, runs, live, g_out, g_logt, logt, carry, S,
                    tiles_x, tile_size, B=128, blend_bf16=False, tile_lo=0):
    """Stage 2 of K2 on the card; same returns as bwd_blocks_plain."""
    _check_geometry(table, tile_size, B)
    PB, W = table.shape
    C, P, nb = W - 8, tile_size * tile_size, PB // B
    T1 = runs.numel() - 1
    check(table.device, ("table", table, _F32, (PB, W)),
          ("runs", runs, _I32, (T1 + 1,)), ("live", live, _I32, (nb,)),
          ("g_out", g_out, _F32, (T1, C, P)),
          ("g_logt", g_logt, _F32, (T1, P)), ("logt", logt, _F32, (T1, P)),
          ("carry", carry, _F32, (nb, P)), ("S", S, _F32, (nb, P)))
    dtab = torch.empty((PB, W), dtype=_F32, device=table.device)
    _launch("fs_flat_bwd_blocks",
            (table, runs, live, g_out, g_logt, logt, carry, S, dtab),
            (nb, T1, tiles_x, tile_size, B, C, int(blend_bf16), tile_lo))
    return dtab


def flat_composite_fwd_cuda(table, runs, blk_count, num_tiles, tiles_x,
                            tile_size, B=128, blend_bf16=False, tile_lo=0):
    """K1 on the card: three launches; same returns as
    flat_composite_fwd_plain."""
    if runs.shape != (num_tiles + 2,):
        raise ValueError("runs must have num_tiles + 2 entries")
    delta, acc, _, sacc = fwd_blocks_cuda(table, runs, blk_count, tiles_x,
                                          tile_size, B, blend_bf16, tile_lo)
    carry, live, logt = fwd_scan_cuda(delta, runs, blk_count)
    out = fwd_combine_cuda(acc, carry, live, runs)
    _count("flat_composite_fwd")
    return out, logt, carry, sacc, live


def flat_composite_bwd_cuda(table, runs, g_out, g_logt, logt, carry, acc,
                            live, tiles_x, tile_size, B=128,
                            blend_bf16=False, tile_lo=0):
    """K2 on the card: two launches; same returns as
    flat_composite_bwd_plain."""
    S = bwd_suffix_cuda(acc, carry, live, runs, g_out, blend_bf16)
    dtab = bwd_blocks_cuda(table, runs, live, g_out, g_logt, logt, carry, S,
                           tiles_x, tile_size, B, blend_bf16, tile_lo)
    _count("flat_composite_bwd")
    return dtab


def flat_composite_fwd(table, *args, **kw):
    """K1: the kernels for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return flat_composite_fwd_cuda(table, *args, **kw)
    return flat_composite_fwd_plain(table, *args, **kw)


def flat_composite_bwd(table, *args, **kw):
    """K2: the kernels for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return flat_composite_bwd_cuda(table, *args, **kw)
    return flat_composite_bwd_plain(table, *args, **kw)


# ---------------------------------------------------------- autograd ------

class _FlatComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, blk_tile, blk_count, num_tiles, tiles_x,
                tile_size, B, blend_bf16, tile_lo):
        runs = tile_runs(blk_tile, num_tiles)
        blk_count = blk_count.to(torch.int32).contiguous()
        table = table.contiguous()
        out, logt, carry, acc, live = flat_composite_fwd(
            table, runs, blk_count, num_tiles, tiles_x, tile_size, B,
            blend_bf16, tile_lo)
        ctx.save_for_backward(table, runs, logt, carry, acc, live)
        ctx.geom = (num_tiles, tiles_x, tile_size, B, blend_bf16, tile_lo)
        out_t = out[:num_tiles].transpose(1, 2).contiguous()   # (T, P, C)
        alpha = 1.0 - torch.exp(logt[:num_tiles])
        return out_t, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        table, runs, logt, carry, acc, live = ctx.saved_tensors
        num_tiles, tiles_x, tile_size, B, blend_bf16, tile_lo = ctx.geom
        C = table.shape[1] - 8
        P = tile_size * tile_size
        f32 = dict(dtype=torch.float32, device=table.device)
        # the dummy row T receives zero cotangent
        g_out_t = torch.zeros((num_tiles + 1, C, P), **f32)
        g_logt = torch.zeros((num_tiles + 1, P), **f32)
        if g_out is not None:
            g_out_t[:num_tiles] = g_out.transpose(1, 2)
        if g_alpha is not None:
            g_logt[:num_tiles] = -g_alpha
        dtab = flat_composite_bwd(table, runs, g_out_t, g_logt, logt, carry,
                                  acc, live, tiles_x, tile_size, B,
                                  blend_bf16, tile_lo)
        return dtab, None, None, None, None, None, None, None, None


def flat_composite(table, blk_tile, blk_count, num_tiles, tiles_x,
                   tile_size, B=128, blend_bf16=False, tile_lo=0):
    """Composite the flat segmented pair table.

    Same returns as pallas_flat.flat_composite: (out (num_tiles, P, C),
    alpha (num_tiles, P)); the gradient reaches the table only, with
    |d mx|, |d my| in columns 6, 7. The reference's blk_first is not taken:
    tile runs follow from the non-decreasing blk_tile (local tile ids).
    The reference's blk_gtile is blk_tile + tile_lo: tile_lo is the global
    id of local tile 0 (a tile-sharded mesh's shard me * T_loc), and each
    block's pixel centres and row cull are those of its global tile.
    blend_bf16 takes the reference's bf16 blend products."""
    return _FlatComposite.apply(table, blk_tile, blk_count, num_tiles,
                                tiles_x, tile_size, B, bool(blend_bf16),
                                int(tile_lo))
