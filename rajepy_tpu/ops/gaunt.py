"""Free-free Gaunt factors of van Hoof et al. (2014) as a device-resident
table with an on-device bicubic interpolation kernel.

The reference (maths/physics.py:626-698) re-reads and re-parses the data file
and rebuilds a local scipy ``interp2d`` on *every call*, which it tolerates
only because it restricts grid-wide use ("takes too long", classes.py:
1385-1387) to the constant-temperature case.  Here the 81x146 log-log table
is parsed once at import of the first user, pushed to device, and evaluated
anywhere on the grid with a vectorised Catmull-Rom bicubic — O(cells) fused
work, so the van Hoof factors are affordable for the whole grid at every
frequency (removing the reference's q_T != 0 fallback to the Reynolds
approximation is therefore *possible*; we keep the fallback switchable for
parity).

Axes (physics.py:666-675):
    log g2 = log10(Z^2 * Ry_inf / (k_B T))   (column axis, 81 values)
    log u  = log10(h nu / (k_B T))           (row axis, 146 values)
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .. import constants as cnsts

_DATA_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "vanHoofetal2014.data")

# Infinite-mass Rydberg energy [J] (physics.py:671-672)
_RY_INF = cnsts.M_E * cnsts.E_CHARGE ** 4 / (
    8.0 * cnsts.EPSILON_0 ** 2 * cnsts.H ** 2)


@lru_cache(maxsize=1)
def load_vanhoof_table():
    """Parse the bundled van Hoof et al. (2014) table once.

    Returns (loggam2_start, logu_start, step, gff[n_logu, n_loggam2]) —
    the header layout is documented at lines 30-41 of the data file
    (parsed by the reference at physics.py:626-663).
    """
    with open(_DATA_FILE, "rt") as f:
        lines = f.readlines()
    loggam2_start = float(lines[30].split('#')[0])
    logu_start = float(lines[31].split('#')[0])
    step = float(lines[32].split('#')[0])
    n_gam2, n_u = (int(v) for v in lines[29].split('#')[0].split())
    data = np.array([[float(v) for v in ln.split()]
                     for ln in lines[42:42 + n_u]])
    assert data.shape == (n_u, n_gam2), data.shape
    return loggam2_start, logu_start, step, data


def _catmull_rom_weights(t):
    """Catmull-Rom cubic weights for the 4 support points around fraction t."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def interp_bicubic(table, x0, y0, step, x, y):
    """Catmull-Rom bicubic interpolation of ``table[y_idx, x_idx]`` on the
    uniform grid starting at (x0, y0) with spacing ``step``.  Queries are
    clamped to the valid interior (mirroring the reference's index clamping
    at physics.py:683-690)."""
    table = jnp.asarray(table)
    ny, nx = table.shape

    fx = (jnp.asarray(x) - x0) / step
    fy = (jnp.asarray(y) - y0) / step
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 1, nx - 3)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 1, ny - 3)
    tx = jnp.clip(fx - ix, -1.0, 2.0)
    ty = jnp.clip(fy - iy, -1.0, 2.0)

    wx = _catmull_rom_weights(tx)
    wy = _catmull_rom_weights(ty)

    out = 0.0
    for j in range(4):
        row = 0.0
        for i in range(4):
            row = row + wx[i] * table[iy + j - 1, ix + i - 1]
        out = out + wy[j] * row
    return out


def _log_axes(freq, temp, z):
    # log-sum form, not log-of-ratio: the ratio's reverse-mode JVP squares
    # k_B*T (~1.9e-38), which sits at the edge of the float32 normal range
    # and blows the gradient up to inf on the f32 fitting path
    log_t = jnp.log10(jnp.asarray(temp))
    logg2 = float(np.log10(z ** 2 * _RY_INF / cnsts.K_B)) - log_t
    logu = (float(np.log10(cnsts.H / cnsts.K_B)) +
            jnp.log10(jnp.asarray(freq)) - log_t)
    return jnp.broadcast_arrays(logg2, logu)


def gff(freq, temp, z: float = 1.0):
    """Thermally averaged free-free Gaunt factor (physics.py:666-698).

    ``freq`` [Hz] and ``temp`` [K] broadcast; fully vectorised and
    jit-compatible (device gather over the resident table).
    """
    x0, y0, step, table = load_vanhoof_table()
    logg2, logu = _log_axes(freq, temp, z)
    return interp_bicubic(table, x0, y0, step, logg2, logu)


@lru_cache(maxsize=1)
def load_vanhoof_uncertainties():
    """Parse the table's companion uncertainty block (same layout, data
    file lines 193+; the reference reads it at physics.py:640-641 via
    ``import_vanHoof2014(errors=True)``)."""
    with open(_DATA_FILE, "rt") as f:
        lines = f.readlines()
    n_gam2, n_u = (int(v) for v in lines[29].split('#')[0].split())
    unc = np.array([[float(v) for v in ln.split()]
                    for ln in lines[192:192 + n_u]])
    assert unc.shape == (n_u, n_gam2), unc.shape
    return unc


def gff_uncertainty(freq, temp, z: float = 1.0):
    """1-sigma uncertainty of the van Hoof et al. (2014) Gaunt factor at
    the query point (nearest-node lookup of the companion uncertainty
    table — the published uncertainties are themselves node estimates,
    so interpolating them adds nothing)."""
    x0, y0, step, _ = load_vanhoof_table()
    unc = jnp.asarray(load_vanhoof_uncertainties())
    ny, nx = unc.shape
    logg2, logu = _log_axes(freq, temp, z)
    ix = jnp.clip(jnp.round((logg2 - x0) / step).astype(jnp.int32),
                  0, nx - 1)
    iy = jnp.clip(jnp.round((logu - y0) / step).astype(jnp.int32),
                  0, ny - 1)
    return unc[iy, ix]


def gff_with_uncertainty(freq, temp, z: float = 1.0):
    """(gff, sigma_gff): the reference's value-with-uncertainty form of
    the van Hoof table (physics.py:659, ``uf(gff, unc_lines...)``) as a
    plain array pair — the ``uncertainties``-package scalars cannot be
    traced, so downstream propagation is linear: a relative gaunt error
    propagates one-to-one into tau_ff and the optically-thin flux."""
    return gff(freq, temp, z), gff_uncertainty(freq, temp, z)
