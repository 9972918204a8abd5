"""Dense per-tile compositing: kernels K3 (forward) and K4 (backward).

Counterpart of fusionsense_tpu/render/pallas_composite2.py, the `pallas`
backend. Each tile owns one row block of a (T, K, 8 + C) table
[mx, my, ca, cb, cc, log_op, abs_tap_x, abs_tap_y, chan...], its first
count[t] slots live and the rest dead (log_op = -1e10):

- K3 composites a tile's 128-pair chunks front to back while
  c < ceil(count / B) and some pixel of the tile still has log T > -9.21
  (the reference's while_loop cond, checked before each chunk). It writes
  out (T, C, P), the final log T (T, P), the log T entering each composited
  chunk, `carries` (T, K / B, P) (zero for chunks it did not composite), and
  the number of chunks composited, nused (T,) int32.
- K4 zeroes dtab (T, K, 8 + C) and walks each tile's nused chunks in
  reverse, replaying alpha from the carries: d mx, d my, d ca, d cb, d cc,
  d log_op, |d mx|, |d my| (gsplat's absgrad, in the zero-valued abs_tap
  columns) and d chan.

Both exist twice: a CUDA kernel (csrc/composite2.cu, one CTA per tile, one
thread per pixel) and a plain tensor version with the same chunk semantics,
looping over the chunk index and vectorised over tiles. A wrapper sends a
CPU tensor to the plain version and a CUDA tensor to the kernel; there is no
fallback between the two. tile_ids gives each table row's global tile, so a
tile-sharded caller can composite an offset slice.
"""
from __future__ import annotations

import ctypes

import torch

from fusionsense_tpu_torch.render.flat_composite import (
    T_EPS_LOG, _alpha_of_rows, _pixel_xy, _raise_on,
)

# launches per entry point; chip_smoke.py zeroes these before driving the
# main path and reads them after it
LAUNCHES = {"composite2_fwd": 0, "composite2_bwd": 0,
            "composite2_fwd_plain": 0, "composite2_bwd_plain": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _no_bf16(blend_bf16: bool) -> None:
    if blend_bf16:
        raise NotImplementedError(
            "blend_bf16=True is not ported: K3/K4 blend in float32 only "
            "(ROADMAP N5)")


def _chunks_of(K: int, B: int) -> int:
    """Chunks per tile; the reference's BlockSpecs need B to divide K."""
    if K % B:
        raise ValueError(f"chunk {B} must divide the tile capacity {K}")
    return K // B


def _n_chunks(counts: torch.Tensor, B: int, nc: int) -> torch.Tensor:
    """ceil(count / B), clipped to the chunks the table holds."""
    return torch.clamp((counts.long() + B - 1) // B, 0, nc)


# ------------------------------------------------------------ plain ------

def composite2_fwd_plain(table, counts, tile_ids, tiles_x, tile_size, B=128,
                         blend_bf16=False):
    """Plain K3: returns (out (T, C, P), logT (T, P), carries (T, K/B, P),
    nused (T,) int32)."""
    _no_bf16(blend_bf16)
    LAUNCHES["composite2_fwd_plain"] += 1
    T, K, W = table.shape
    C, P, nc = W - 8, tile_size * tile_size, _chunks_of(K, B)
    f32 = dict(dtype=torch.float32, device=table.device)
    out = torch.zeros((T, C, P), **f32)
    log_t = torch.zeros((T, P), **f32)
    carries = torch.zeros((T, nc, P), **f32)
    nused = torch.zeros((T,), dtype=torch.int32, device=table.device)
    n_chunks = _n_chunks(counts, B, nc)
    px_all, py_all = _pixel_xy(tile_ids.long(), tiles_x, tile_size, P)
    for c in range(nc):
        # the cond is monotone: once a tile stops, it never resumes
        go = (c < n_chunks) & (log_t.max(dim=1).values > T_EPS_LOG)
        tl = torch.nonzero(go).squeeze(1)
        if tl.numel() == 0:
            break
        lt = log_t[tl]
        carries[tl, c] = lt
        rows = table[tl, c * B:(c + 1) * B]
        alpha, _, _ = _alpha_of_rows(rows, px_all[tl], py_all[tl])
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        w = alpha * torch.exp(lt[:, None, :] + cum - lg)
        out[tl] += torch.einsum("tbc,tbp->tcp", rows[..., 8:], w)
        log_t[tl] = lt + cum[:, -1, :]
        nused[tl] += 1
    return out, log_t, carries, nused


def composite2_bwd_plain(table, neff, tile_ids, g_out, g_logt, logt, carries,
                         tiles_x, tile_size, B=128, blend_bf16=False):
    """Plain K4: g_out (T, C, P), g_logt/logt (T, P), carries (T, K/B, P),
    neff (T,) -> dtab (T, K, 8 + C)."""
    _no_bf16(blend_bf16)
    LAUNCHES["composite2_bwd_plain"] += 1
    T, K, W = table.shape
    P, nc = tile_size * tile_size, _chunks_of(K, B)
    dtab = torch.zeros((T, K, W), dtype=torch.float32, device=table.device)
    S = torch.zeros((T, P), dtype=torch.float32, device=table.device)
    t_fin = torch.exp(logt)
    n_eff = torch.clamp(neff.long(), 0, nc)
    px_all, py_all = _pixel_xy(tile_ids.long(), tiles_x, tile_size, P)
    for c in reversed(range(nc)):
        tl = torch.nonzero(c < n_eff).squeeze(1)
        if tl.numel() == 0:
            continue
        rows = table[tl, c * B:(c + 1) * B]
        chan = rows[..., 8:]
        go = g_out[tl]                                      # (t, C, P)
        glt = g_logt[tl][:, None, :]
        tf = t_fin[tl][:, None, :]
        alpha, alive, (dx, dy, ca, cb, cc) = _alpha_of_rows(
            rows, px_all[tl], py_all[tl])
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        t_excl = torch.exp(carries[tl, c][:, None, :] + cum - lg)
        w = alpha * t_excl
        q = torch.einsum("tbc,tcp->tbp", chan, go)
        a_term = w * q
        cum_a = torch.cumsum(a_term, dim=1)
        suffix = (cum_a[:, -1:, :] - cum_a) + S[tl][:, None, :]
        inv1m = 1.0 / (1.0 - alpha)
        d_alpha = q * t_excl - suffix * inv1m - glt * tf * inv1m
        d_power = torch.where(alive, alpha * d_alpha, torch.zeros_like(alpha))
        d_mx = torch.sum(d_power * (ca * dx + cb * dy), -1)
        d_my = torch.sum(d_power * (cb * dx + cc * dy), -1)
        d_ca = torch.sum(d_power * (-0.5 * dx * dx), -1)
        d_cb = torch.sum(d_power * (-dx * dy), -1)
        d_cc = torch.sum(d_power * (-0.5 * dy * dy), -1)
        d_lo = torch.sum(d_power, -1)
        d_chan = torch.einsum("tbp,tcp->tbc", w, go)
        dtab[tl, c * B:(c + 1) * B] = torch.cat(
            [torch.stack([d_mx, d_my, d_ca, d_cb, d_cc, d_lo, d_mx.abs(),
                          d_my.abs()], -1), d_chan], -1)
        S[tl] += torch.sum(a_term, dim=1)
    return dtab


# ----------------------------------------------------------- kernels ------

_C_SUPPORTED = 8


def _check_launch(table, tile_size, B, ints, floats):
    """Raise on what the kernels do not take. `ints` / `floats` map names to
    (tensor, shape) for the int32 / float32 inputs beside the table."""
    if table.dim() != 3:
        raise ValueError(f"table must be (T, K, 8 + C), got {tuple(table.shape)}")
    T, K, W = table.shape
    P = tile_size * tile_size
    if W - 8 != _C_SUPPORTED:
        raise ValueError(f"the CUDA kernels take C = {_C_SUPPORTED} channels, "
                         f"got a table of width {W}")
    if P % 32 or P > 1024:
        raise ValueError(f"tile_size {tile_size}: the kernels need "
                         "tile_size**2 a multiple of 32 and at most 1024")
    if B % 16 or B > 256 or K % B:
        raise ValueError(f"chunk {B}: needs a multiple of 16, at most 256, "
                         f"dividing the tile capacity {K}")
    checks = [("table", table, torch.float32, (T, K, W))]
    checks += [(n, t, torch.int32, s) for n, (t, s) in ints.items()]
    checks += [(n, t, torch.float32, s) for n, (t, s) in floats.items()]
    for name, t, dt, shape in checks:
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"{name} must be on {table.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")


def _lib():
    from fusionsense_tpu_torch.kernels.build import load

    lib = load("composite2")
    if not getattr(lib, "_fs_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fs_composite2_fwd.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.fs_composite2_fwd.restype = ci
        lib.fs_composite2_bwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.fs_composite2_bwd.restype = ci
        lib._fs_typed = True
    return lib


def composite2_fwd_cuda(table, counts, tile_ids, tiles_x, tile_size, B=128,
                        blend_bf16=False):
    """K3 on the card; same returns as composite2_fwd_plain."""
    _no_bf16(blend_bf16)
    T, K, W = table.shape
    _check_launch(table, tile_size, B,
                  {"counts": (counts, (T,)), "tile_ids": (tile_ids, (T,))}, {})
    P, nc = tile_size * tile_size, K // B
    f32 = dict(dtype=torch.float32, device=table.device)
    out = torch.empty((T, W - 8, P), **f32)
    logt = torch.empty((T, P), **f32)
    carries = torch.empty((T, nc, P), **f32)
    nused = torch.empty((T,), dtype=torch.int32, device=table.device)
    err = _lib().fs_composite2_fwd(
        table.data_ptr(), counts.data_ptr(), tile_ids.data_ptr(),
        out.data_ptr(), logt.data_ptr(), carries.data_ptr(), nused.data_ptr(),
        T, tiles_x, tile_size, K, B, W - 8,
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "composite2_fwd")
    LAUNCHES["composite2_fwd"] += 1
    return out, logt, carries, nused


def composite2_bwd_cuda(table, neff, tile_ids, g_out, g_logt, logt, carries,
                        tiles_x, tile_size, B=128, blend_bf16=False):
    """K4 on the card; same returns as composite2_bwd_plain."""
    _no_bf16(blend_bf16)
    T, K, W = table.shape
    P, nc = tile_size * tile_size, K // B
    _check_launch(table, tile_size, B,
                  {"neff": (neff, (T,)), "tile_ids": (tile_ids, (T,))},
                  {"g_out": (g_out, (T, W - 8, P)), "g_logt": (g_logt, (T, P)),
                   "logt": (logt, (T, P)), "carries": (carries, (T, nc, P))})
    dtab = torch.empty((T, K, W), dtype=torch.float32, device=table.device)
    err = _lib().fs_composite2_bwd(
        neff.data_ptr(), tile_ids.data_ptr(), table.data_ptr(),
        g_out.data_ptr(), g_logt.data_ptr(), logt.data_ptr(),
        carries.data_ptr(), dtab.data_ptr(), T, tiles_x, tile_size, K, B,
        W - 8, torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(err, "composite2_bwd")
    LAUNCHES["composite2_bwd"] += 1
    return dtab


def composite2_fwd(table, *args, **kw):
    """K3: the kernel for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return composite2_fwd_cuda(table, *args, **kw)
    return composite2_fwd_plain(table, *args, **kw)


def composite2_bwd(table, *args, **kw):
    """K4: the kernel for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return composite2_bwd_cuda(table, *args, **kw)
    return composite2_bwd_plain(table, *args, **kw)


# ---------------------------------------------------------- autograd ------

class _Composite2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, counts, tile_ids, tiles_x, tile_size, B):
        table = table.contiguous()
        counts = counts.to(torch.int32).contiguous()
        tile_ids = tile_ids.to(torch.int32).contiguous()
        out, logt, carries, nused = composite2_fwd(
            table, counts, tile_ids, tiles_x, tile_size, B)
        ctx.save_for_backward(table, nused, tile_ids, logt, carries)
        ctx.geom = (tiles_x, tile_size, B)
        return out.transpose(1, 2).contiguous(), 1.0 - torch.exp(logt)

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        table, nused, tile_ids, logt, carries = ctx.saved_tensors
        tiles_x, tile_size, B = ctx.geom
        T, _, W = table.shape
        P = tile_size * tile_size
        f32 = dict(dtype=torch.float32, device=table.device)
        g_out_t = (torch.zeros((T, W - 8, P), **f32) if g_out is None
                   else g_out.transpose(1, 2).contiguous())
        g_logt = (torch.zeros((T, P), **f32) if g_alpha is None
                  else (-g_alpha).contiguous())
        dtab = composite2_bwd(table, nused, tile_ids, g_out_t, g_logt, logt,
                              carries, tiles_x, tile_size, B)
        return dtab, None, None, None, None, None


def composite2(table, counts, tile_ids, tiles_x, tile_size, B=128,
               blend_bf16=False):
    """Composite the dense per-tile table.

    Same returns as pallas_composite2: (out (T, P, C), alpha (T, P)); the
    gradient reaches the table only, with |d mx|, |d my| in columns 6, 7.
    Dead slots must carry log_op = -1e10; counts (T,) are the live slots per
    tile and tile_ids (T,) each row's global tile id (arange(T) for a whole
    image)."""
    _no_bf16(blend_bf16)
    return _Composite2.apply(table, counts, tile_ids, tiles_x, tile_size, B)
