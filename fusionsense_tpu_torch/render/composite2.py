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
- K4 writes dtab (T, K, 8 + C) of each tile's nused chunks: d mx, d my,
  d ca, d cb, d cc, d log_op, |d mx|, |d my| (gsplat's absgrad, in the
  zero-valued abs_tap columns) and d chan; rows past nused * B are zero.

A chunk entered at log T `L` adds exp(L) * acc_c to out and delta_c to
log T, where acc_c (T, K/B, C, P) and delta_c (T, K/B, P) are the chunk's
own blend and sum of log(1 - alpha) from T = 1. So each kernel is two
stages, none of which walks a tile's chunks with the blending math
(csrc/composite2.cu gives the design):

  K3: fwd_chunks (delta, acc per chunk below ceil(count / B)) ->
      fwd_combine (the stop rule: out, log T, carries, nused)
  K4: bwd_suffix (S per chunk, from acc and the cotangents) -> bwd_chunks
      (each used chunk's gradient rows from its carries and S)

K3 returns (out, logT, carries, nused, sacc); K4 takes the last three
back.
Every stage exists twice: a CUDA kernel and a plain tensor version with the
same semantics, looping over the chunk index and vectorised over tiles. A
wrapper sends a CPU tensor to the plain version and a CUDA tensor to the
kernel; there is no fallback between the two. delta and acc are defined
for chunks below ceil(count / B) and S for chunks below nused: the kernels
leave the rest unwritten and the plain versions zero, and nothing reads
them. tile_ids gives each table row's global tile, so a tile-sharded
caller can composite an offset slice.

blend_bf16 is the reference's bf16 blend (pallas_composite2.py's
blend_bf16 branch), as in render/flat_composite.py: fwd_chunks, bwd_suffix
and bwd_chunks round both operands of each blend product to bfloat16 and
sum the products in float32. A chunk forms w from T = 1 and the reference
from the tile's running T, so a rounded w may differ from the reference's
by one bf16 ulp. As in the flat layout, fwd_chunks also returns sacc, the
blend with w left float32 under the flag (acc itself without it), and K3
hands K4 sacc: the reference's suffix sums w * q with w float32.
"""
from __future__ import annotations

import torch

from fusionsense_tpu_torch.kernels.build import Launches, check, launch
from fusionsense_tpu_torch.render.flat_composite import (
    T_EPS_LOG, _alpha_of_rows, _pixel_xy, blend_operand,
)

# launch counts (kernels/build.py Launches), one per K3 or K4 call
_COUNTS = Launches(("composite2_fwd", "composite2_bwd"),
                   plain=("composite2_fwd_plain", "composite2_bwd_plain"))
LAUNCHES, CAPTURED = _COUNTS.counts, _COUNTS.captured
reset_launch_counts, _count = _COUNTS.reset, _COUNTS.count


def _chunks_of(K: int, B: int) -> int:
    """Chunks per tile; the reference's BlockSpecs need B to divide K."""
    if K % B:
        raise ValueError(f"chunk {B} must divide the tile capacity {K}")
    return K // B


def n_chunks(counts: torch.Tensor, B: int, nc: int) -> torch.Tensor:
    """ceil(count / B), clipped to the chunks the table holds: the chunks
    fwd_chunks composites."""
    return torch.clamp((counts.long() + B - 1) // B, 0, nc)


# ------------------------------------------------------------ plain ------

def fwd_chunks_plain(table, counts, tile_ids, tiles_x, tile_size, B=128,
                     blend_bf16=False):
    """Stage 1 of K3: every chunk below ceil(count / B) composited by itself
    from T = 1. Returns delta (T, K/B, P), its sum of log(1 - alpha), and
    acc (T, K/B, C, P), its blend; zeros for the other chunks; sacc, the
    blend K4's suffix reads: acc itself, or under blend_bf16 the blend with
    w left float32."""
    T, K, W = table.shape
    C, P, nc = W - 8, tile_size * tile_size, _chunks_of(K, B)
    f32 = dict(dtype=torch.float32, device=table.device)
    delta = torch.zeros((T, nc, P), **f32)
    acc = torch.zeros((T, nc, C, P), **f32)
    sacc = torch.zeros((T, nc, C, P), **f32) if blend_bf16 else acc
    n = n_chunks(counts, B, nc)
    px_all, py_all = _pixel_xy(tile_ids.long(), tiles_x, tile_size, P)
    for c in range(nc):
        tl = torch.nonzero(c < n).squeeze(1)
        if tl.numel() == 0:
            break
        rows = table[tl, c * B:(c + 1) * B]
        alpha, _, _ = _alpha_of_rows(rows, px_all[tl], py_all[tl])
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        w = alpha * torch.exp(cum - lg)
        chan = blend_operand(rows[..., 8:], blend_bf16)
        acc[tl, c] = torch.einsum("tbc,tbp->tcp", chan,
                                  blend_operand(w, blend_bf16))
        if blend_bf16:
            sacc[tl, c] = torch.einsum("tbc,tbp->tcp", chan, w)
        delta[tl, c] = cum[:, -1, :]
    return delta, acc, sacc


def fwd_combine_plain(delta, acc, counts, B=128):
    """Stage 2 of K3: the stop rule. Returns out (T, C, P), logT (T, P),
    carries (T, K/B, P), the log T entering each composited chunk (zero
    past nused), and nused (T,) int32. Reads delta and acc of the chunks
    composited only."""
    T, nc, C, P = acc.shape
    f32 = dict(dtype=torch.float32, device=acc.device)
    out = torch.zeros((T, C, P), **f32)
    log_t = torch.zeros((T, P), **f32)
    carries = torch.zeros((T, nc, P), **f32)
    nused = torch.zeros((T,), dtype=torch.int32, device=acc.device)
    n = n_chunks(counts, B, nc)
    for c in range(nc):
        # the cond is monotone: once a tile stops, it never resumes; a NaN
        # in log T stops it, as jnp.max gives NaN
        go = (c < n) & (log_t.max(dim=1).values > T_EPS_LOG)
        tl = torch.nonzero(go).squeeze(1)
        if tl.numel() == 0:
            break
        lt = log_t[tl]
        carries[tl, c] = lt
        out[tl] += torch.exp(lt)[:, None, :] * acc[tl, c]
        log_t[tl] = lt + delta[tl, c]
        nused[tl] += 1
    return out, log_t, carries, nused


def bwd_suffix_plain(acc, carries, nused, g_out, blend_bf16=False):
    """Stage 1 of K4: S (T, K/B, P), for each chunk below nused the sum over
    the tile's later used chunks of exp(carries) * sum_c g_out[c] * acc[c]
    (the chunk's suffix of w * q; acc is fwd_chunks' sacc, and g_out is
    rounded as q's operand under blend_bf16), summed last chunk first; zeros
    past nused."""
    T, nc, _, P = acc.shape
    g_out = blend_operand(g_out, blend_bf16)
    f32 = dict(dtype=torch.float32, device=acc.device)
    S = torch.zeros((T, nc, P), **f32)
    s = torch.zeros((T, P), **f32)
    n = torch.clamp(nused.long(), 0, nc)
    for c in reversed(range(nc)):
        tl = torch.nonzero(c < n).squeeze(1)
        if tl.numel() == 0:
            continue
        S[tl, c] = s[tl]
        s[tl] += torch.exp(carries[tl, c]) * torch.einsum(
            "tcp,tcp->tp", g_out[tl], acc[tl, c])
    return S


def bwd_chunks_plain(table, nused, tile_ids, g_out, g_logt, logt, carries, S,
                     tiles_x, tile_size, B=128, blend_bf16=False):
    """Stage 2 of K4: dtab (T, K, 8 + C), each chunk below nused replayed
    from its carry with its suffix S; zero rows past nused * B."""
    T, K, W = table.shape
    P, nc = tile_size * tile_size, _chunks_of(K, B)
    dtab = torch.zeros((T, K, W), dtype=torch.float32, device=table.device)
    t_fin = torch.exp(logt)
    n = torch.clamp(nused.long(), 0, nc)
    px_all, py_all = _pixel_xy(tile_ids.long(), tiles_x, tile_size, P)
    for c in range(nc):
        tl = torch.nonzero(c < n).squeeze(1)
        if tl.numel() == 0:
            break
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
        go_b = blend_operand(go, blend_bf16)
        q = torch.einsum("tbc,tcp->tbp", blend_operand(chan, blend_bf16), go_b)
        a_term = w * q
        cum_a = torch.cumsum(a_term, dim=1)
        suffix = (cum_a[:, -1:, :] - cum_a) + S[tl, c][:, None, :]
        inv1m = 1.0 / (1.0 - alpha)
        d_alpha = q * t_excl - suffix * inv1m - glt * tf * inv1m
        d_power = torch.where(alive, alpha * d_alpha, torch.zeros_like(alpha))
        d_mx = torch.sum(d_power * (ca * dx + cb * dy), -1)
        d_my = torch.sum(d_power * (cb * dx + cc * dy), -1)
        d_ca = torch.sum(d_power * (-0.5 * dx * dx), -1)
        d_cb = torch.sum(d_power * (-dx * dy), -1)
        d_cc = torch.sum(d_power * (-0.5 * dy * dy), -1)
        d_lo = torch.sum(d_power, -1)
        d_chan = torch.einsum("tbp,tcp->tbc", blend_operand(w, blend_bf16),
                              go_b)
        dtab[tl, c * B:(c + 1) * B] = torch.cat(
            [torch.stack([d_mx, d_my, d_ca, d_cb, d_cc, d_lo, d_mx.abs(),
                          d_my.abs()], -1), d_chan], -1)
    return dtab


def composite2_fwd_plain(table, counts, tile_ids, tiles_x, tile_size, B=128,
                         blend_bf16=False):
    """Plain K3: returns (out (T, C, P), logT (T, P), carries (T, K/B, P),
    nused (T,) int32, sacc (T, K/B, C, P), fwd_chunks' blend for K4's
    suffix)."""
    LAUNCHES["composite2_fwd_plain"] += 1
    delta, acc, sacc = fwd_chunks_plain(table, counts, tile_ids, tiles_x,
                                        tile_size, B, blend_bf16)
    return (*fwd_combine_plain(delta, acc, counts, B), sacc)


def composite2_bwd_plain(table, nused, tile_ids, g_out, g_logt, logt, carries,
                         acc, tiles_x, tile_size, B=128, blend_bf16=False):
    """Plain K4: g_out (T, C, P), g_logt/logt (T, P) and K3's carries,
    nused and sacc (as acc) -> dtab (T, K, 8 + C)."""
    LAUNCHES["composite2_bwd_plain"] += 1
    S = bwd_suffix_plain(acc, carries, nused, g_out, blend_bf16)
    return bwd_chunks_plain(table, nused, tile_ids, g_out, g_logt, logt,
                            carries, S, tiles_x, tile_size, B, blend_bf16)


# ----------------------------------------------------------- kernels ------

_C_SUPPORTED = 8
_FNS = {   # C entry point -> (pointer arguments, int arguments)
    "fs_dense_fwd_chunks": (6, 7), "fs_dense_fwd_combine": (7, 5),
    "fs_dense_bwd_suffix": (5, 5), "fs_dense_bwd_chunks": (9, 7),
}
_F32, _I32 = torch.float32, torch.int32


def _check_geometry(table, tile_size, B):
    """Raise on a table or tiling the kernels do not take."""
    if table.dim() != 3:
        raise ValueError(f"table must be (T, K, 8 + C), got {tuple(table.shape)}")
    _, K, W = table.shape
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


def _launch(fn, tensors, ints):
    launch("composite2", _FNS, fn, tensors, ints)


def fwd_chunks_cuda(table, counts, tile_ids, tiles_x, tile_size, B=128,
                    blend_bf16=False):
    """Stage 1 of K3 on the card; same returns as fwd_chunks_plain, left
    unwritten past ceil(count / B)."""
    _check_geometry(table, tile_size, B)
    T, K, W = table.shape
    C, P, nc = W - 8, tile_size * tile_size, K // B
    check(table.device, ("table", table, _F32, (T, K, W)),
          ("counts", counts, _I32, (T,)), ("tile_ids", tile_ids, _I32, (T,)))
    delta = torch.empty((T, nc, P), dtype=_F32, device=table.device)
    acc = torch.empty((T, nc, C, P), dtype=_F32, device=table.device)
    sacc = torch.empty_like(acc) if blend_bf16 else acc
    _launch("fs_dense_fwd_chunks", (table, counts, tile_ids, delta, acc, sacc),
            (T, tiles_x, tile_size, K, B, C, int(blend_bf16)))
    return delta, acc, sacc


def fwd_combine_cuda(delta, acc, counts, B=128):
    """Stage 2 of K3 on the card; same returns as fwd_combine_plain."""
    T, nc, C, P = acc.shape
    if C != _C_SUPPORTED:
        raise ValueError(f"the CUDA kernels take C = {_C_SUPPORTED} channels")
    check(acc.device, ("delta", delta, _F32, (T, nc, P)),
          ("acc", acc, _F32, (T, nc, C, P)), ("counts", counts, _I32, (T,)))
    out = torch.empty((T, C, P), dtype=_F32, device=acc.device)
    logt = torch.empty((T, P), dtype=_F32, device=acc.device)
    carries = torch.empty((T, nc, P), dtype=_F32, device=acc.device)
    nused = torch.empty((T,), dtype=_I32, device=acc.device)
    _launch("fs_dense_fwd_combine",
            (delta, acc, counts, out, logt, carries, nused), (T, P, nc, B, C))
    return out, logt, carries, nused


def bwd_suffix_cuda(acc, carries, nused, g_out, blend_bf16=False):
    """Stage 1 of K4 on the card; same returns as bwd_suffix_plain, left
    unwritten past nused."""
    T, nc, C, P = acc.shape
    if C != _C_SUPPORTED:
        raise ValueError(f"the CUDA kernels take C = {_C_SUPPORTED} channels")
    check(acc.device, ("acc", acc, _F32, (T, nc, C, P)),
          ("carries", carries, _F32, (T, nc, P)),
          ("nused", nused, _I32, (T,)), ("g_out", g_out, _F32, (T, C, P)))
    S = torch.empty((T, nc, P), dtype=_F32, device=acc.device)
    _launch("fs_dense_bwd_suffix", (acc, carries, nused, g_out, S),
            (T, P, nc, C, int(blend_bf16)))
    return S


def bwd_chunks_cuda(table, nused, tile_ids, g_out, g_logt, logt, carries, S,
                    tiles_x, tile_size, B=128, blend_bf16=False):
    """Stage 2 of K4 on the card; same returns as bwd_chunks_plain."""
    _check_geometry(table, tile_size, B)
    T, K, W = table.shape
    C, P, nc = W - 8, tile_size * tile_size, K // B
    check(table.device, ("table", table, _F32, (T, K, W)),
          ("nused", nused, _I32, (T,)), ("tile_ids", tile_ids, _I32, (T,)),
          ("g_out", g_out, _F32, (T, C, P)), ("g_logt", g_logt, _F32, (T, P)),
          ("logt", logt, _F32, (T, P)),
          ("carries", carries, _F32, (T, nc, P)), ("S", S, _F32, (T, nc, P)))
    dtab = torch.empty((T, K, W), dtype=_F32, device=table.device)
    _launch("fs_dense_bwd_chunks",
            (table, nused, tile_ids, g_out, g_logt, logt, carries, S, dtab),
            (T, tiles_x, tile_size, K, B, C, int(blend_bf16)))
    return dtab


def composite2_fwd_cuda(table, counts, tile_ids, tiles_x, tile_size, B=128,
                        blend_bf16=False):
    """K3 on the card: two launches; same returns as composite2_fwd_plain."""
    delta, acc, sacc = fwd_chunks_cuda(table, counts, tile_ids, tiles_x,
                                       tile_size, B, blend_bf16)
    out, logt, carries, nused = fwd_combine_cuda(delta, acc, counts, B)
    _count("composite2_fwd")
    return out, logt, carries, nused, sacc


def composite2_bwd_cuda(table, nused, tile_ids, g_out, g_logt, logt, carries,
                        acc, tiles_x, tile_size, B=128, blend_bf16=False):
    """K4 on the card: two launches; same returns as composite2_bwd_plain."""
    S = bwd_suffix_cuda(acc, carries, nused, g_out, blend_bf16)
    dtab = bwd_chunks_cuda(table, nused, tile_ids, g_out, g_logt, logt,
                           carries, S, tiles_x, tile_size, B, blend_bf16)
    _count("composite2_bwd")
    return dtab


def composite2_fwd(table, *args, **kw):
    """K3: the kernels for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return composite2_fwd_cuda(table, *args, **kw)
    return composite2_fwd_plain(table, *args, **kw)


def composite2_bwd(table, *args, **kw):
    """K4: the kernels for a CUDA table, the plain version for a CPU one."""
    if table.is_cuda:
        return composite2_bwd_cuda(table, *args, **kw)
    return composite2_bwd_plain(table, *args, **kw)


# ---------------------------------------------------------- autograd ------

class _Composite2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, counts, tile_ids, tiles_x, tile_size, B,
                blend_bf16):
        table = table.contiguous()
        counts = counts.to(torch.int32).contiguous()
        tile_ids = tile_ids.to(torch.int32).contiguous()
        out, logt, carries, nused, acc = composite2_fwd(
            table, counts, tile_ids, tiles_x, tile_size, B, blend_bf16)
        ctx.save_for_backward(table, nused, tile_ids, logt, carries, acc)
        ctx.geom = (tiles_x, tile_size, B, blend_bf16)
        return out.transpose(1, 2).contiguous(), 1.0 - torch.exp(logt)

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        table, nused, tile_ids, logt, carries, acc = ctx.saved_tensors
        tiles_x, tile_size, B, blend_bf16 = ctx.geom
        T, _, W = table.shape
        P = tile_size * tile_size
        f32 = dict(dtype=torch.float32, device=table.device)
        g_out_t = (torch.zeros((T, W - 8, P), **f32) if g_out is None
                   else g_out.transpose(1, 2).contiguous())
        g_logt = (torch.zeros((T, P), **f32) if g_alpha is None
                  else (-g_alpha).contiguous())
        dtab = composite2_bwd(table, nused, tile_ids, g_out_t, g_logt, logt,
                              carries, acc, tiles_x, tile_size, B, blend_bf16)
        return dtab, None, None, None, None, None, None


def composite2(table, counts, tile_ids, tiles_x, tile_size, B=128,
               blend_bf16=False):
    """Composite the dense per-tile table.

    Same returns as pallas_composite2: (out (T, P, C), alpha (T, P)); the
    gradient reaches the table only, with |d mx|, |d my| in columns 6, 7.
    Dead slots must carry log_op = -1e10; counts (T,) are the live slots per
    tile and tile_ids (T,) each row's global tile id (arange(T) for a whole
    image). blend_bf16 takes the reference's bf16 blend products."""
    return _Composite2.apply(table, counts, tile_ids, tiles_x, tile_size, B,
                             bool(blend_bf16))
