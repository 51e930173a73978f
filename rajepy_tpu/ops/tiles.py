"""Jet-occupied tile compaction and the per-epoch RT products on it.

The jet silhouette covers a few per cent of the voxel grid (about 3% of
the cells of the bundled example jet at 512^3), and the per-epoch
products are reductions along the line of sight that read every cell they
cover.  Compaction gathers once per model the (block_x, y_chunk, block_z)
tiles that hold any jet cell; every later epoch then reads only those
tiles.  Tiles with no jet cell have zero opacity and emission, so dropping
them leaves every product exact.

Everything here is plain ``jax.numpy``/``lax``: XLA fuses each product
into a reduction over the compacted tile streams.  The one hand-written
kernel over these tiles, the RRL Voigt cube, lives in
:mod:`rajepy_tpu.ops.rrl_tiles`.

Launch time and jet side travel packed in ONE tile stream (see
:func:`pack_launch_time`), so an epoch pass reads one packed stream plus
the base stream(s) it collapses.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_offset_for(ts_min: float) -> float:
    """Packing offset for :func:`pack_launch_time` that keeps the packed
    magnitude |ts + offset| strictly positive IN FLOAT32 for every
    ts >= ts_min: a fixed +1 margin falls below f32 rounding once
    |ts_min| exceeds ~2^24 s, so the margin scales with |ts_min|
    (1e-5 relative, ~2 f32 ulps of headroom)."""
    ts_min = float(ts_min)
    return 1.0 + 1e-5 * abs(ts_min) - min(0.0, ts_min)


def pack_launch_time(ts, red, dtype=jnp.float32, offset=1.0):
    """Pack launch time + jet side into one cube:
    +(ts + offset) on the blue side, -(ts + offset) on the red side.

    ``offset`` MUST exceed ``-min(ts)`` so the packed magnitude stays
    positive — travel times from the closed-form integral can be
    NEGATIVE near the launch surface for off-axis geometries, and a
    too-small offset silently corrupts both the side bit and the
    recovered time.  Unpack with the SAME offset (:func:`burst_factor`
    recovers ``|tss| - offset`` directly, with no epoch-time shift)."""
    ts1 = jnp.asarray(ts, dtype) + jnp.asarray(offset, dtype)
    return jnp.where(red, -ts1, ts1)


def burst_factor(tss, t, bursts: tuple, pack_offset: float):
    """Burst factor chi(t - ts) of models/ejection.chi_field, evaluated
    from packed launch-time tiles with the bursts unrolled statically.

    ``bursts`` is a tuple of (t0 [s], 1/(2 sigma^2), relative amplitude,
    is_red) Python scalars (JetModel._burst_tuple); an empty tuple gives
    chi = 1.  Unrolling keeps the whole chain one elementwise fusion over
    the tile stream; chi_field's lax.scan exists to bound full-grid
    temporaries, which tiles do not need."""
    lt = t - (jnp.abs(tss) - pack_offset)
    red = tss < 0.0
    chi = jnp.ones_like(lt)
    for t0, inv2s2, amp, is_red in bursts:
        g = amp * jnp.exp(-(lt - t0) ** 2 * inv2s2)
        sel = red if is_red else jnp.logical_not(red)
        chi = chi + jnp.where(sel, g, 0.0)
    return chi


def _tile_grid(n, b):
    return -(-n // b)


def _pad_to_tiles(cube, bx, yc, bz, fill):
    nx, ny, nz = cube.shape
    pads = ((0, (-nx) % bx), (0, (-ny) % yc), (0, (-nz) % bz))
    if any(p[1] for p in pads):
        cube = jnp.pad(cube, pads, constant_values=fill)
    return cube


@functools.partial(jax.jit, static_argnames=('block_x', 'block_z',
                                              'y_chunk'))
def _tile_activity(inside, block_x: int = 8, block_z: int = 128,
                   y_chunk: int = 64):
    """(nX, nY, nZ) bool: which (block_x, y_chunk, block_z) tiles contain
    any jet cell."""
    p = _pad_to_tiles(inside, block_x, y_chunk, block_z, False)
    nx, ny, nz = p.shape
    return p.reshape(nx // block_x, block_x, ny // y_chunk, y_chunk,
                     nz // block_z, block_z).any(axis=(1, 3, 5))


def active_tiles(inside, block_x: int = 8, block_z: int = 128,
                 y_chunk: int = 64):
    """Host-side one-off: flat ids of jet-occupied tiles plus their
    (x, z)-tile segment ids for the collapsed-map reassembly.

    Returns ``(ids, seg)`` int32 numpy arrays of shape (n_act,); empty
    when the grid holds no jet cells.
    """
    act = np.asarray(_tile_activity(inside, block_x, block_z, y_chunk))
    n_xt, n_yt, n_zt = act.shape
    ids = np.flatnonzero(act.reshape(-1)).astype(np.int32)
    i = ids // (n_yt * n_zt)
    k = ids % n_zt
    seg = (i * n_zt + k).astype(np.int32)
    return ids, seg


def active_tiles_scan_order(inside_flipped, block_x: int = 8,
                            block_z: int = 128, y_chunk: int = 64):
    """Host-side one-off for the compacted ordered scan.

    ``inside_flipped`` must already be flipped along y into observer
    ordering (y=0 nearest the observer).  Tiles are sorted by (x-tile,
    z-tile) segment, then by y.

    Returns ``(ids, seg_dense, jt, it, kt)``: flat tile ids into the
    padded tile grid, the dense [0, n_seg) segment index and the y-tile
    index of each tile, and each segment's (x, z) tile coordinates (for
    scattering the per-segment maps back onto the image plane).
    """
    act = np.asarray(_tile_activity(inside_flipped, block_x, block_z,
                                    y_chunk))
    n_xt, n_yt, n_zt = act.shape
    ids = np.flatnonzero(act.reshape(-1)).astype(np.int32)
    i = ids // (n_yt * n_zt)
    j = (ids // n_zt) % n_yt
    k = ids % n_zt
    order = np.lexsort((j, k, i))         # primary i, then k, then j
    ids, i, j, k = ids[order], i[order], j[order], k[order]
    seg_key = i * n_zt + k
    uniq, seg_dense = np.unique(seg_key, return_inverse=True)
    return (ids, seg_dense.astype(np.int32), j.astype(np.int32),
            (uniq // n_zt).astype(np.int32), (uniq % n_zt).astype(np.int32))


@functools.partial(jax.jit, static_argnames=('block_x', 'block_z',
                                              'y_chunk', 'fill'))
def gather_tiles(cube, ids, block_x: int = 8, block_z: int = 128,
                 y_chunk: int = 64, fill: float = 0.0):
    """(n_act, block_x, y_chunk, block_z) compacted copy of ``cube`` at the
    active tile ids (one full-cube shuffle, once per model)."""
    p = _pad_to_tiles(cube, block_x, y_chunk, block_z, fill)
    nx, ny, nz = p.shape
    t = p.reshape(nx // block_x, block_x, ny // y_chunk, y_chunk,
                  nz // block_z, block_z)
    t = t.transpose(0, 2, 4, 1, 3, 5).reshape(-1, block_x, y_chunk,
                                              block_z)
    return t[ids]


@functools.partial(jax.jit, static_argnames=('nx', 'nz'))
def segment_tile_maps(parts, seg, nx: int, nz: int):
    """(n_act, n_chan, bx, bz) per-tile partials -> (n_chan, nx, nz) via
    segment-sum over the tiles' (x, z) positions (seg from active_tiles)."""
    n_act, n_chan, bx, bz = parts.shape
    n_xt = _tile_grid(nx, bx)
    n_zt = _tile_grid(nz, bz)
    m = jax.ops.segment_sum(parts, seg, num_segments=n_xt * n_zt)
    m = m.reshape(n_xt, n_zt, n_chan, bx, bz).transpose(2, 0, 3, 1, 4)
    return m.reshape(n_chan, n_xt * bx, n_zt * bz)[:, :nx, :nz]


@functools.partial(jax.jit, static_argnames=('n_xt', 'n_zt', 'nx', 'nz'))
def scatter_tile_maps(parts, it, kt, n_xt: int, n_zt: int, nx: int,
                      nz: int):
    """(n_seg, n_chan, bx, bz) per-segment maps -> (n_chan, nx, nz), zero
    where no segment exists (no jet along that line of sight)."""
    n_seg, n_chan, bx, bz = parts.shape
    grid = jnp.zeros((n_chan, n_xt, n_zt, bx, bz), parts.dtype)
    grid = grid.at[:, it, kt].set(parts.transpose(1, 0, 2, 3))
    m = grid.transpose(0, 1, 3, 2, 4).reshape(n_chan, n_xt * bx,
                                              n_zt * bz)
    return m[:, :nx, :nz]


def epoch_base_maps_tiles(bases_t: tuple, tss_t, seg, t, bursts: tuple,
                          nx: int, nz: int, pack_offset: float = 1.0):
    """LOS-collapsed sum_y base * chi(t - ts)^2 for each compacted base
    stream in ``bases_t``, sharing one burst-factor evaluation.

    Args:
      bases_t: tuple of (n_act, bx, yc, bz) compacted epoch-independent
               bases (opacity tau_ff_base and/or the EM base)
      tss_t:   (n_act, bx, yc, bz) compacted packed launch time/side
               (gathered with fill=1.0)
      seg:     (n_act,) int32 x,z-tile segment id (from active_tiles)
      t:       scalar model time [s] (traced)
      bursts:  static burst tuple (see :func:`burst_factor`)

    Returns a tuple of (nx, nz) maps, one per base.
    """
    chi = burst_factor(tss_t, t, bursts, pack_offset)
    chi2 = chi * chi
    return tuple(
        segment_tile_maps(jnp.sum(b * chi2, axis=2)[:, None], seg,
                          nx, nz)[0]
        for b in bases_t)


def emergent_ff_tiles(cnu, hnuk, tau_scale, temp_t, a_t, tss_t, seg, jt,
                      t, bursts: tuple, n_seg: int, n_yt: int,
                      pack_offset: float = 1.0):
    """Ordered emergent free-free intensity and total optical depth over
    compacted observer-ordered tiles: per-segment maps
    (n_seg, n_chan, bx, bz) each.

    Inside a tile the attenuation is the exclusive prefix sum of dtau
    along y.  Across a segment's tiles (the same (x, z) column, in LOS
    order) each tile's intensity is attenuated by the total optical depth
    of the tiles in front of it: the (attenuation, intensity) monoid of
    parallel.sharding.sharded_transfer_scan.  The tiles' totals are laid
    out on a dense (n_seg, n_yt) grid, so the in-front sum is one short
    cumulative sum per segment; skipped y ranges have zero opacity and
    contribute nothing to it.

    Args:
      cnu, hnuk, tau_scale: (n_chan,) 2 h nu^3 / c^2 [cgs], h nu / k_B [K]
                 and the per-channel opacity multiplier
      temp_t:    (n_act, bx, yc, bz) temperature tiles, safe (>0) off-jet
      a_t:       (n_act, bx, yc, bz) frequency-independent opacity tiles
      tss_t:     (n_act, bx, yc, bz) packed launch-time tiles
      seg, jt:   (n_act,) dense segment index and y-tile index per tile
                 (from :func:`active_tiles_scan_order`)
    """
    d_base = a_t * jnp.square(burst_factor(tss_t, t, bursts, pack_offset))
    d = tau_scale[None, :, None, None, None] * d_base[:, None]
    src = cnu[None, :, None, None, None] / jnp.expm1(
        hnuk[None, :, None, None, None] / temp_t[:, None])
    tau_in = jnp.cumsum(d, axis=3) - d                  # exclusive, in-tile
    inten = jnp.sum(src * -jnp.expm1(-d) * jnp.exp(-tau_in), axis=3)
    tau_tile = jnp.sum(d, axis=3)                       # (n_act, n_chan, ..)
    dense = jnp.zeros((n_seg, n_yt) + tau_tile.shape[1:], tau_tile.dtype)
    dense = dense.at[seg, jt].set(tau_tile)
    front = (jnp.cumsum(dense, axis=1) - dense)[seg, jt]
    inten = jax.ops.segment_sum(inten * jnp.exp(-front), seg,
                                num_segments=n_seg)
    tau = jax.ops.segment_sum(tau_tile, seg, num_segments=n_seg)
    return inten, tau
