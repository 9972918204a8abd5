"""Random pair tables for the compositor tests: the flat layout's block maps
(K1/K2) and the dense (T, K) layout's tile tables (K3/K4). Shared by
test_torch_flat_composite.py, test_torch_composite2.py and
test_torch_kernels.py; imports no JAX, so the card's tests can run where JAX
is not installed.

The flat cases cover a saturated tile (whole blocks skipped), a tile that
owns no block, a live block with count 0, the dummy tail, a long run, a
tile that saturates in the middle of its run, and rows the compositor
culls (dead slots) beside a row with a NaN conic. The dense
cases cover a saturated tile (early termination), a tile with count 0, a
partly filled last chunk, an offset slice of global tile ids, a full tile
that saturates in its middle chunk (so the chunk pass composites a chunk
the reference never reaches), a NaN conic in that skipped chunk, and a NaN
conic in a chunk that is composited."""
import numpy as np
import torch

from fusionsense_tpu_torch.render import composite2 as C2
from fusionsense_tpu_torch.render import flat_composite as FC

B, TS, TILES_X, TILES_Y, C = 128, 16, 3, 2, 8
T, P, W = TILES_X * TILES_Y, TS * TS, 8 + C

CASES = {
    # tile 2 owns no block; tile 4 is saturated after its first block
    "mixed": dict(runs=[2, 1, 0, 3, 4, 1], saturate=(4,)),
    "zero_count_block": dict(runs=[1, 2, 1, 1, 1, 2], zero_count_block=1),
    # tile 1 owns 14 blocks of faint rows, all live: more than a run walker
    # of the kernels loads at once (8)
    "long_run": dict(runs=[1, 14, 0, 2, 1, 1], faint=(1,)),
    # tile 1's 10 blocks are faint but its block 4 saturates the tile, so
    # blocks 5-9 are skipped with the carry frozen
    "saturate_mid_run": dict(runs=[2, 10, 1, 0, 1, 1], faint=(1,),
                             saturate_block=(1, 4)),
    # tile 0: blocks 1 and 4 hold only dead-slot rows (log_op = log(1e-12),
    # a PSD conic), block 3 every other row; tile 2's block 1 starts with a
    # dead-slot row whose ca is NaN, which must reach out and dtab
    "culled_rows": dict(runs=[6, 1, 2, 0, 1, 1], faint=(0, 2),
                        dead_blocks=((0, 1), (0, 4)), mixed_block=(0, 3),
                        nan_row=(2, 1)),
}


def maps(runs, dummy=2, zero_count_block=None, seed=0):
    rng = np.random.RandomState(seed)
    blk_tile, blk_count = [], []
    for t, n in enumerate(runs):
        for k in range(n):
            blk_tile.append(t)
            blk_count.append(B if k < n - 1 else int(rng.randint(1, B + 1)))
    blk_tile += [T] * dummy
    blk_count += [0] * dummy
    blk_count = np.asarray(blk_count, np.int32)
    if zero_count_block is not None:
        blk_count[zero_count_block] = 0
    blk_tile = np.asarray(blk_tile, np.int32)
    blk_first = np.concatenate(
        [[1], (blk_tile[1:] != blk_tile[:-1]).astype(np.int32)]).astype(np.int32)
    return blk_tile, blk_first, blk_count


def _fill_rows(rows, n, tile, rng, sat, faint=False):
    """Random live rows [0, n) of a (>= n, W) block for global tile `tile`:
    wide and nearly opaque with `sat`, of opacity 0.005-0.03 with `faint`."""
    ox, oy = (tile % TILES_X) * TS, (tile // TILES_X) * TS
    sig = rng.uniform(12.0, 20.0, (n, 2)) if sat else rng.uniform(1.5, 6.0, (n, 2))
    rho = rng.uniform(-0.3, 0.3, n)
    sxx, syy = sig[:, 0] ** 2, sig[:, 1] ** 2
    sxy = rho * sig[:, 0] * sig[:, 1]
    det = sxx * syy - sxy ** 2
    rows[:n, 0] = ox + rng.uniform(-4, TS + 4, n)
    rows[:n, 1] = oy + rng.uniform(-4, TS + 4, n)
    rows[:n, 2] = syy / det
    rows[:n, 3] = -sxy / det
    rows[:n, 4] = sxx / det
    if sat:
        op = rng.uniform(0.9, 0.99, n)
    else:
        op = rng.uniform(0.005, 0.03, n) if faint else rng.uniform(0.05, 0.9, n)
    rows[:n, 5] = np.log(op)
    rows[:n, 8:15] = rng.uniform(0.0, 1.0, (n, 7))


def _dead_rows(rows, idx, tile, rng):
    """Dead-slot rows at `idx`: opacity 0 as the rasterizer writes it
    (log_op = log(1e-12)), a 2 px round footprint near the tile's centre."""
    n = len(range(*idx.indices(rows.shape[0])))
    ox, oy = (tile % TILES_X) * TS, (tile // TILES_X) * TS
    rows[idx, 0] = ox + TS / 2 + rng.uniform(-1, 1, n)
    rows[idx, 1] = oy + TS / 2 + rng.uniform(-1, 1, n)
    rows[idx, 2:5] = [0.25, 0.0, 0.25]
    rows[idx, 5] = np.log(np.float32(1e-12))


def table(blk_tile, blk_count, saturate=(), faint=(), saturate_block=None,
          dead_blocks=(), mixed_block=None, nan_row=None, seed=0):
    rng = np.random.RandomState(seed)
    nb = blk_tile.shape[0]
    tab = np.zeros((nb, B, W), np.float32)
    tab[..., 5] = -1e10
    for b in range(nb):
        t = blk_tile[b]
        if t >= T:
            continue
        k = b - int(np.searchsorted(blk_tile, t))      # position in the run
        sat = t in saturate or (t, k) == saturate_block
        _fill_rows(tab[b], blk_count[b], t, rng, sat, t in faint)
        if (t, k) in dead_blocks:
            _dead_rows(tab[b], slice(0, blk_count[b]), t, rng)
        if (t, k) == mixed_block:
            _dead_rows(tab[b], slice(0, blk_count[b], 2), t, rng)
        if (t, k) == nan_row:
            _dead_rows(tab[b], slice(0, 1), t, rng)
            tab[b, 0, 2] = np.nan
    return tab.reshape(nb * B, W)


def case(name):
    """(table, blk_tile, blk_first, blk_count, g_out, g_alpha) as numpy."""
    spec = CASES[name]
    blk_tile, blk_first, blk_count = maps(
        spec["runs"], zero_count_block=spec.get("zero_count_block"))
    tab = table(blk_tile, blk_count, **{
        k: v for k, v in spec.items() if k not in ("runs", "zero_count_block")})
    # cotangents at the scale a per-pixel mean loss gives (~1e-2 here): with
    # unit cotangents the conic columns sum terms of ~1e3 over the tile, and
    # float32 summation order alone moves them by more than 1e-5
    rng = np.random.RandomState(1)
    g_out = 0.01 * rng.normal(size=(T, P, C)).astype(np.float32)
    g_alpha = 0.01 * rng.normal(size=(T, P)).astype(np.float32)
    return tab, blk_tile, blk_first, blk_count, g_out, g_alpha


def torch_fwd_bwd(tab, blk_tile, blk_count, g_out, g_alpha, device="cpu",
                  blend_bf16=False, num_tiles=T, tile_lo=0):
    """Port's flat_composite forward + autograd backward on `device`."""
    t = torch.tensor(tab, device=device, requires_grad=True)
    ms = [torch.tensor(a, device=device) for a in (blk_tile, blk_count)]
    out, alpha = FC.flat_composite(t, *ms, num_tiles, TILES_X, TS, B,
                                   blend_bf16, tile_lo=tile_lo)
    torch.autograd.backward([out, alpha], [torch.tensor(g_out, device=device),
                                           torch.tensor(g_alpha, device=device)])
    return (out.detach().cpu().numpy(), alpha.detach().cpu().numpy(),
            t.grad.cpu().numpy())


def shard_case(name, n, me):
    """Shard `me` of `n` of a flat case, as a tile-sharded mesh lays it out:
    the tiles padded to a multiple of n, T_loc = T_pad / n of them from
    tile_lo = me * T_loc; the blocks of those tiles with local tile ids and
    two dummy blocks at T_loc; the cotangents of those tiles (zero past T).
    Returns (table, blk_tile, blk_first, blk_count, g_out, g_alpha, tile_lo,
    T_loc, the global blocks' slice)."""
    tab, bt, _, bc, g_out, g_alpha = case(name)
    T_loc = -(-T // n)
    lo = me * T_loc
    own = np.nonzero((bt >= lo) & (bt < min(lo + T_loc, T)))[0]
    blocks = slice(int(own[0]), int(own[-1]) + 1) if len(own) else slice(0, 0)
    dummy = np.zeros((2 * B, W), np.float32)
    dummy[:, 5] = -1e10
    tab_l = np.concatenate([tab.reshape(-1, B, W)[blocks].reshape(-1, W),
                            dummy])
    bt_l = np.concatenate([bt[blocks] - lo, [T_loc, T_loc]]).astype(np.int32)
    bc_l = np.concatenate([bc[blocks], [0, 0]]).astype(np.int32)
    bf_l = np.concatenate(
        [[1], (bt_l[1:] != bt_l[:-1]).astype(np.int32)]).astype(np.int32)
    g_o = np.zeros((T_loc, P, C), np.float32)
    g_a = np.zeros((T_loc, P), np.float32)
    n_real = max(0, min(T_loc, T - lo))
    g_o[:n_real] = g_out[lo:lo + n_real]
    g_a[:n_real] = g_alpha[lo:lo + n_real]
    return tab_l, bt_l, bf_l, bc_l, g_o, g_a, lo, T_loc, blocks


# ---------------------------------------------------------- dense ------

DENSE_K = 3 * B           # three 128-pair chunks per tile
TILES_Y_DENSE = 3         # the global grid of the offset-slice case

DENSE_CASES = {
    # tile 1 has count 0; tile 2 saturates in its first chunk; tile 0's and
    # tile 5's last chunks are partly filled; tile ids are 0..T-1
    "mixed": dict(counts=[300, 0, 384, 128, 250, 57], saturate=(2,),
                  tile_lo=0),
    # rows are tiles 3..8 of a 3 x 3 grid: the pixels follow tile_ids
    "offset_slice": dict(counts=[200, 384, 0, 129, 384, 17], saturate=(4,),
                         tile_lo=3),
    # tile 0 is full: a faint chunk 0, a chunk 1 that saturates every pixel,
    # and a faint chunk 2 that the chunk pass composites but the reference
    # never reaches
    "saturate_mid_tile": dict(counts=[384, 0, 300, 140, 384, 57],
                              saturate=(4,), faint=(0,),
                              saturate_chunk=(0, 1), tile_lo=0),
    # the same tile 0 with a NaN conic in a row of its skipped chunk 2 (out,
    # alpha and dtab stay finite there, chunk 2's dtab rows zero); tile 3's
    # chunk 1 opens with a NaN conic, which reaches out and dtab
    "nan_past_stop": dict(counts=[384, 0, 300, 129, 384, 57], saturate=(4,),
                          faint=(0, 3), saturate_chunk=(0, 1),
                          nan_rows=((0, 2 * B + 5), (3, B)), tile_lo=0),
}


def dense_stops(name):
    """{tile: chunks the reference composites} for the tiles of a dense case
    that saturate before their last chunk."""
    spec = DENSE_CASES[name]
    stops = {t: 1 for t in spec["saturate"]}
    if "saturate_chunk" in spec:
        t, c = spec["saturate_chunk"]
        stops[t] = c + 1
    return stops


def dense_case(name, seed=0):
    """(table (T, K, W), counts (T,), tile_ids (T,), g_out (T, P, C),
    g_alpha (T, P)) as numpy; dead slots carry log_op = -1e10."""
    spec = DENSE_CASES[name]
    rng = np.random.RandomState(seed)
    counts = np.asarray(spec["counts"], np.int32)
    tile_ids = np.arange(T, dtype=np.int32) + spec["tile_lo"]
    tab = np.zeros((T, DENSE_K, W), np.float32)
    tab[..., 5] = -1e10
    for i in range(T):
        _fill_rows(tab[i], counts[i], int(tile_ids[i]), rng,
                   i in spec["saturate"], i in spec.get("faint", ()))
    if "saturate_chunk" in spec:
        t, c = spec["saturate_chunk"]
        _fill_rows(tab[t, c * B:(c + 1) * B], B, int(tile_ids[t]), rng, True)
    for t, slot in spec.get("nan_rows", ()):
        tab[t, slot, 2] = np.nan
    rng = np.random.RandomState(1)
    g_out = 0.01 * rng.normal(size=(T, P, C)).astype(np.float32)
    g_alpha = 0.01 * rng.normal(size=(T, P)).astype(np.float32)
    return tab, counts, tile_ids, g_out, g_alpha


def torch_dense_fwd_bwd(tab, counts, tile_ids, g_out, g_alpha, device="cpu",
                        blend_bf16=False):
    """Port's composite2 forward + autograd backward on `device`."""
    t = torch.tensor(tab, device=device, requires_grad=True)
    out, alpha = C2.composite2(t, torch.tensor(counts, device=device),
                               torch.tensor(tile_ids, device=device),
                               TILES_X, TS, B, blend_bf16)
    torch.autograd.backward([out, alpha], [torch.tensor(g_out, device=device),
                                           torch.tensor(g_alpha, device=device)])
    return (out.detach().cpu().numpy(), alpha.detach().cpu().numpy(),
            t.grad.cpu().numpy())


# blend_bf16 (ROADMAP N5). The plain twins round both operands of each
# blend product to bf16 as Pallas does, and read their suffix S from a
# blend with w left float32 as Pallas does; but a block or chunk forms w
# from T = 1, where Pallas forms it from the tile's running T, so a rounded
# w may land on the neighbouring bf16 value. Against Pallas interpret mode
# (CPU, these cases): out is held to one bf16 ulp of a unit channel (2^-8;
# the twins read up to 3.2e-3) with its mean |d| under a third of the
# float32 blend's (the twins read at least 3.8x less); dtab column by
# column within 2e-5 of the column's largest |d| (the twins read up to
# 8.1e-6, the float32 dtab at least 7.9e-4 in every column).
TOL_BF16_OUT, TOL_BF16_DTAB_REL, BF16_MEAN_GAP = 4e-3, 2e-5, 3.0


def column_errors(got, want):
    """Each column's (last dimension's) max |got - want| over its max |want|,
    over the entries where want is finite; got must be NaN exactly there."""
    got, want = (np.asarray(a).reshape(-1, np.shape(a)[-1])
                 for a in (got, want))
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    got, want = np.where(bad, 0.0, got), np.where(bad, 0.0, want)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    return np.abs(got - want).max(axis=0) / scale


def assert_bf16_rounds(out_t, dtab_t, out_f, dtab_f, out_j, dtab_j):
    """The bf16 twin (t) against Pallas's bf16 (j) at the limits above, and
    the float32 blend (f) farther off: the rounding is really taken, in the
    forward and in every column of dtab."""
    np.testing.assert_allclose(out_t, out_j, atol=TOL_BF16_OUT)
    gap = np.nanmean(np.abs(out_f - out_j)) / np.nanmean(np.abs(out_t - out_j))
    assert gap > BF16_MEAN_GAP, gap
    assert column_errors(dtab_t, dtab_j).max() <= TOL_BF16_DTAB_REL
    assert (column_errors(dtab_f, dtab_j) > TOL_BF16_DTAB_REL).all()
