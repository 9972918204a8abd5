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
- K2 walks each tile's blocks in reverse, replays each live block from the
  carries, and writes the table gradient dtab (PB, 8 + C): d mx, d my, d ca,
  d cb, d cc, d log_op, |d mx|, |d my| (gsplat's absgrad, in the zero-valued
  abs_tap columns) and d chan. Dead and dummy blocks get zero rows.

Both exist twice: a CUDA kernel (csrc/flat_composite.cu, one CTA per tile,
one thread per pixel) and a plain tensor version with the same block
semantics, looping over "block index within tile" and vectorised over
tiles. A wrapper sends a CPU tensor to the plain version and a CUDA tensor
to the kernel; there is no fallback between the two. Every row of out/logT
is written by both (tiles without blocks get out = 0, log T = 0), which
gives the reference's _mask_empty semantics by construction.
"""
from __future__ import annotations

import ctypes
import math

import torch

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
LOG_ALPHA_MAX = math.log(ALPHA_MAX)
T_EPS_LOG = -9.21

# launches per entry point; chip_smoke.py zeroes these before driving the
# main path and reads them after it
LAUNCHES = {"flat_composite_fwd": 0, "flat_composite_bwd": 0,
            "flat_composite_fwd_plain": 0, "flat_composite_bwd_plain": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _no_bf16(blend_bf16: bool) -> None:
    if blend_bf16:
        raise NotImplementedError(
            "blend_bf16=True is not ported: K1/K2 blend in float32 only "
            "(ROADMAP N5)")


def tile_runs(blk_tile: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """(num_tiles + 2,) int32 run boundaries: tile t (t <= num_tiles, the
    dummy included) owns blocks [runs[t], runs[t+1]). blk_tile must be
    non-decreasing, as flat_bin_gaussians lays it out."""
    q = torch.arange(num_tiles + 2, dtype=torch.int32, device=blk_tile.device)
    return torch.searchsorted(blk_tile.to(torch.int32), q, out_int32=True)


# ------------------------------------------------------------ plain ------

def _pixel_xy(tile: torch.Tensor, tiles_x: int, tile_size: int, P: int):
    """Pixel centers (t, 1, P) of the given tile ids."""
    ts = tile_size
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


def flat_composite_fwd_plain(table, runs, blk_count, num_tiles, tiles_x,
                             tile_size, B=128, blend_bf16=False):
    """Plain K1: returns (out (T+1, C, P), logT (T+1, P), carry (nb, P))."""
    _no_bf16(blend_bf16)
    LAUNCHES["flat_composite_fwd_plain"] += 1
    PB, W = table.shape
    C, P, nb, T1 = W - 8, tile_size * tile_size, PB // B, num_tiles + 1
    tab = table.reshape(nb, B, W)
    f32 = dict(dtype=torch.float32, device=table.device)
    out = torch.zeros((T1, C, P), **f32)
    log_t = torch.zeros((T1, P), **f32)
    carry = torch.zeros((nb, P), **f32)
    start, length, max_len = _runs_by_position(runs)
    for k in range(max_len):
        tiles = torch.nonzero(k < length).squeeze(1)
        blk = start[tiles] + k
        lt = log_t[tiles]
        carry[blk] = lt
        live = (blk_count[blk] > 0) & (lt.max(dim=1).values > T_EPS_LOG)
        tl, bl, lt = tiles[live], blk[live], lt[live]
        if tl.numel() == 0:
            continue
        rows = tab[bl]
        px, py = _pixel_xy(tl, tiles_x, tile_size, P)
        alpha, _, _ = _alpha_of_rows(rows, px, py)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        t_excl = torch.exp(lt[:, None, :] + cum - lg)
        w = alpha * t_excl
        out[tl] += torch.einsum("tbc,tbp->tcp", rows[..., 8:], w)
        log_t[tl] = lt + cum[:, -1, :]
    return out, log_t, carry


def flat_composite_bwd_plain(table, runs, blk_count, g_out, g_logt, logt,
                             carry, tiles_x, tile_size, B=128,
                             blend_bf16=False):
    """Plain K2: g_out (T+1, C, P), g_logt/logt (T+1, P), carry (nb, P)
    -> dtab (PB, 8 + C)."""
    _no_bf16(blend_bf16)
    LAUNCHES["flat_composite_bwd_plain"] += 1
    PB, W = table.shape
    P, nb, T1 = tile_size * tile_size, PB // B, logt.shape[0]
    tab = table.reshape(nb, B, W)
    dtab = torch.zeros((nb, B, W), dtype=torch.float32, device=table.device)
    S = torch.zeros((T1, P), dtype=torch.float32, device=table.device)
    t_fin = torch.exp(logt)
    start, length, max_len = _runs_by_position(runs)
    for k in reversed(range(max_len)):
        tiles = torch.nonzero(k < length).squeeze(1)
        blk = start[tiles] + k
        lin = carry[blk]
        live = (blk_count[blk] > 0) & (lin.max(dim=1).values > T_EPS_LOG)
        tl, bl, lin = tiles[live], blk[live], lin[live]
        if tl.numel() == 0:
            continue
        rows = tab[bl]
        chan = rows[..., 8:]
        go = g_out[tl]                                      # (t, C, P)
        glt = g_logt[tl][:, None, :]
        tf = t_fin[tl][:, None, :]
        px, py = _pixel_xy(tl, tiles_x, tile_size, P)
        alpha, alive, (dx, dy, ca, cb, cc) = _alpha_of_rows(rows, px, py)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        t_excl = torch.exp(lin[:, None, :] + cum - lg)
        w = alpha * t_excl
        q = torch.einsum("tbc,tcp->tbp", chan, go)
        a_term = w * q
        cum_a = torch.cumsum(a_term, dim=1)
        suffix = (cum_a[:, -1:, :] - cum_a) + S[tl][:, None, :]
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
        d_chan = torch.einsum("tbp,tcp->tbc", w, go)
        dtab[bl] = torch.cat(
            [torch.stack([d_mx, d_my, d_ca, d_cb, d_cc, d_lo, d_mx.abs(),
                          d_my.abs()], -1), d_chan], -1)
        S[tl] += torch.sum(a_term, dim=1)
    return dtab.reshape(PB, W)


# ----------------------------------------------------------- kernels ------

_C_SUPPORTED = 8


def _check_launch(table, runs, blk_count, tile_size, B):
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
    nb = PB // B
    for name, t, dt, shape in (("table", table, torch.float32, (PB, W)),
                               ("runs", runs, torch.int32, None),
                               ("blk_count", blk_count, torch.int32, (nb,))):
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"{name} must be on {table.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")


def _lib():
    from fusionsense_tpu_torch.kernels.build import load

    lib = load("flat_composite")
    if not getattr(lib, "_fs_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fs_flat_composite_fwd.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.fs_flat_composite_fwd.restype = ci
        lib.fs_flat_composite_bwd.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.fs_flat_composite_bwd.restype = ci
        lib._fs_typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def flat_composite_fwd_cuda(table, runs, blk_count, num_tiles, tiles_x,
                            tile_size, B=128, blend_bf16=False):
    """K1 on the card; same returns as flat_composite_fwd_plain."""
    _no_bf16(blend_bf16)
    _check_launch(table, runs, blk_count, tile_size, B)
    if runs.shape != (num_tiles + 2,):
        raise ValueError("runs must have num_tiles + 2 entries")
    PB, W = table.shape
    P, nb, T1 = tile_size * tile_size, PB // B, num_tiles + 1
    f32 = dict(dtype=torch.float32, device=table.device)
    out = torch.empty((T1, W - 8, P), **f32)
    logt = torch.empty((T1, P), **f32)
    carry = torch.empty((nb, P), **f32)
    lib = _lib()
    err = lib.fs_flat_composite_fwd(
        table.data_ptr(), runs.data_ptr(), blk_count.data_ptr(),
        out.data_ptr(), logt.data_ptr(), carry.data_ptr(), T1, tiles_x, tile_size, B, W - 8,
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "flat_composite_fwd")
    LAUNCHES["flat_composite_fwd"] += 1
    return out, logt, carry


def flat_composite_bwd_cuda(table, runs, blk_count, g_out, g_logt, logt,
                            carry, tiles_x, tile_size, B=128,
                            blend_bf16=False):
    """K2 on the card; same returns as flat_composite_bwd_plain."""
    _no_bf16(blend_bf16)
    _check_launch(table, runs, blk_count, tile_size, B)
    PB, W = table.shape
    P, nb, T1 = tile_size * tile_size, PB // B, logt.shape[0]
    if runs.shape != (T1 + 1,):
        raise ValueError("runs must have num_tiles + 2 entries")
    for name, t, shape in (("g_out", g_out, (T1, W - 8, P)),
                           ("g_logt", g_logt, (T1, P)), ("logt", logt, (T1, P)),
                           ("carry", carry, (nb, P))):
        if (t.device != table.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {table.device}")
    dtab = torch.empty((PB, W), dtype=torch.float32, device=table.device)
    lib = _lib()
    err = lib.fs_flat_composite_bwd(
        table.data_ptr(), runs.data_ptr(), blk_count.data_ptr(),
        g_out.data_ptr(), g_logt.data_ptr(),
        logt.data_ptr(), carry.data_ptr(), dtab.data_ptr(),
        T1, tiles_x, tile_size, B, W - 8,
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "flat_composite_bwd")
    LAUNCHES["flat_composite_bwd"] += 1
    return dtab


def flat_composite_fwd(table, *args, **kw):
    """K1: the kernel for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return flat_composite_fwd_cuda(table, *args, **kw)
    return flat_composite_fwd_plain(table, *args, **kw)


def flat_composite_bwd(table, *args, **kw):
    """K2: the kernel for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return flat_composite_bwd_cuda(table, *args, **kw)
    return flat_composite_bwd_plain(table, *args, **kw)


# ---------------------------------------------------------- autograd ------

class _FlatComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, blk_tile, blk_count, num_tiles, tiles_x,
                tile_size, B):
        runs = tile_runs(blk_tile, num_tiles)
        blk_count = blk_count.to(torch.int32).contiguous()
        table = table.contiguous()
        out, logt, carry = flat_composite_fwd(
            table, runs, blk_count, num_tiles, tiles_x, tile_size, B)
        ctx.save_for_backward(table, runs, blk_count, logt, carry)
        ctx.geom = (num_tiles, tiles_x, tile_size, B)
        out_t = out[:num_tiles].transpose(1, 2).contiguous()   # (T, P, C)
        alpha = 1.0 - torch.exp(logt[:num_tiles])
        return out_t, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        table, runs, blk_count, logt, carry = ctx.saved_tensors
        num_tiles, tiles_x, tile_size, B = ctx.geom
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
        dtab = flat_composite_bwd(table, runs, blk_count, g_out_t, g_logt,
                                  logt, carry, tiles_x, tile_size, B)
        return dtab, None, None, None, None, None, None


def flat_composite(table, blk_tile, blk_count, num_tiles, tiles_x,
                   tile_size, B=128, blend_bf16=False):
    """Composite the flat segmented pair table.

    Same returns as pallas_flat.flat_composite: (out (num_tiles, P, C),
    alpha (num_tiles, P)); the gradient reaches the table only, with
    |d mx|, |d my| in columns 6, 7. The reference's blk_first and blk_gtile
    are not taken: tile runs follow from the non-decreasing blk_tile, and
    each block's pixels are those of the tile that owns it."""
    _no_bf16(blend_bf16)
    return _FlatComposite.apply(table, blk_tile, blk_count, num_tiles,
                                tiles_x, tile_size, B)
