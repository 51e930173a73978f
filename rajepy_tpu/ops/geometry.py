"""Jet geometry kernels — pure JAX, fully vectorised, jit/vmap/shard friendly.

Implements the Reynolds (1986) + disc-wind jet geometry of the reference
(/root/reference/maths/geometry.py) as branch-free array programs:

* ``mod_r_0``           — geometry.py:12-31
* ``rho``               — geometry.py:34-61
* ``cell_value``        — geometry.py:64-93
* ``w_r``               — geometry.py:96-118
* ``xyz_rotate``        — geometry.py:212-263
* ``cartesian_to_cylindrical`` — geometry.py:266-302
* ``xyz_to_rwp``        — geometry.py:181-209
* ``r_eff``             — geometry.py:305-336
* ``t_rw``              — geometry.py:121-178 (travel time; the ₂F₁ factor
  lives in :mod:`rajepy_tpu.ops.hyp2f1` and here is evaluated as the combined
  Pfaff-transformed series, see ``_travel_time_integrand`` docstring)

Design notes:
 - every function takes/returns ``jnp`` arrays and traces to a single fused
   XLA computation; no data-dependent python control flow;
 - angles are accepted in degrees (like the reference API) but converted once,
   outside any inner loop;
 - ``t_rw`` is exact (closed form with Gauss ₂F₁) and evaluated for the whole
   grid in one pass — the reference evaluates a np.vectorize'd scalar ₂F₁ per
   cell (geometry.py:175), its slowest kernel (SURVEY §3.2 hot loop C).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .hyp2f1 import hyp2f1_a1_series


def mod_r_0(opang_deg, epsilon, w_0):
    """Modified launching radius: radius at which a Reynolds (1986) jet of
    half-width ``w_0`` maintains opening angle ``opang`` (geometry.py:12-31).
    Returned in the units of ``w_0``."""
    return epsilon * w_0 / jnp.tan(jnp.radians(opang_deg) / 2.0)


def rho(r, r_0, mr0=None):
    """Distance along the jet axis in units of (modified) launching radius
    (geometry.py:34-61).  With ``mr0`` given, r is translated by
    ``mr0 - r_0`` and normalised by ``mr0``."""
    r = jnp.abs(r)
    if mr0 is None:
        return r / r_0
    return (r + mr0 - r_0) / mr0


def cell_value(zero_val, rho_, r_eff_, r1, q, qd):
    """Power-law cell value ``zero_val * rho^q * (r_eff/r1)^qd``
    (geometry.py:64-93)."""
    return zero_val * rho_ ** q * (r_eff_ / r1) ** qd


def w_r(r, w_0, mr0, r_0, eps):
    """Jet half-width w(r) (geometry.py:96-118)."""
    return w_0 * rho(r, r_0, mr0) ** eps


def _rot_x(x, y, z, cos_a, sin_a):
    """Right-handed rotation about the x-axis."""
    return x, cos_a * y - sin_a * z, sin_a * y + cos_a * z


def _rot_y(x, y, z, cos_b, sin_b):
    """Right-handed rotation about the y-axis."""
    return cos_b * x + sin_b * z, y, cos_b * z - sin_b * x


def xyz_rotate(x, y, z, alpha_deg, beta_deg, order: str = "xy"):
    """Compose x-axis (by ``alpha``) and y-axis (by ``beta``) rotations in the
    given static ``order`` ('xy' or 'yx'), angles in degrees
    (geometry.py:212-263)."""
    a = jnp.radians(alpha_deg)
    b = jnp.radians(beta_deg)
    cos_a, sin_a = jnp.cos(a), jnp.sin(a)
    cos_b, sin_b = jnp.cos(b), jnp.sin(b)
    if order.lower() == "xy":
        return _rot_y(*_rot_x(x, y, z, cos_a, sin_a), cos_b, sin_b)
    if order.lower() == "yx":
        return _rot_x(*_rot_y(x, y, z, cos_b, sin_b), cos_a, sin_a)
    raise ValueError(f"rotation order {order!r} not recognised")


def cartesian_to_cylindrical(x, y, z):
    """(x, y, z) -> (rho, phi, z) with the reference's arcsin+quadrant-fix
    convention (geometry.py:266-302).  phi in radians."""
    rho_ = jnp.sqrt(x * x + y * y)
    phi_ = jnp.arcsin(y / rho_)
    phi_ = jnp.where(x < 0, -phi_ + jnp.pi, phi_)
    return rho_, phi_, z


def xyz_to_rwp(x, y, z, inc_deg, pa_deg) -> Tuple[jnp.ndarray, jnp.ndarray,
                                                  jnp.ndarray]:
    """Observer-frame (x, y, z) -> jet-frame (r, w, phi)
    (geometry.py:181-209): derotate by (inc - 90, pa) in 'yx' order, then go
    cylindrical; the cylindrical z is the jet's r axis."""
    xd, yd, zd = xyz_rotate(x, y, z, inc_deg - 90.0, pa_deg, order="yx")
    w, p, r = cartesian_to_cylindrical(xd, yd, zd)
    return r, w, p


def r_eff(w, r_1, r_2, w_0, r, mr0, r_0, eps):
    """Disc radius from which material at jet coordinates (w, r) was launched
    (geometry.py:305-336)."""
    return r_1 + ((r_2 - r_1) * w) / w_r(r, w_0, mr0, r_0, eps)


def t_rw(r_au, w_au, *, w_0, r_0, v_0, mr0, eps, r_1, r_2, q_v, q_vd,
         max_terms: int = 4096, rtol: float = 1e-14):
    """Travel time (years) of material from launch to jet coordinate (r, w).

    Closed form of the reference's geometry.py:121-178: with SI quantities
    (au -> m, km/s -> m/s),

        t(r, w) = I(|r|, w) - I(r_0, w),

        I(r_, w_) = C * rad^(1-q_v) * (r_eff/r_1)^(-q_vd) * P(r_, w_)

    where ``rad = r_ + mr0 - r_0``, ``C = mr0^q_v / (v_0 (1 - q_v + eps
    q_vd))`` and ``P = p3*p4`` combines the reference's
    ``((1 - z)^q_vd) * hyp2f1(q_vd, b; b+1; z)`` factor with
    ``z = r_1 w_0 rad^eps / (w_ mr0^eps (r_1 - r_2))`` (non-positive) and
    ``b = (1 - q_v + eps*q_vd)/eps``.  By the Pfaff transformation
    ``(1-z)^a 2F1(a, b; b+1; z) = 2F1(a, 1; b+1; z/(z-1))`` this product is a
    single Gauss series with unit numerator parameter and argument
    ``u = z/(z-1) ∈ [0, 1)`` — evaluated for the whole grid at once by
    :func:`rajepy_tpu.ops.hyp2f1.hyp2f1_a1_series`.

    At w == 0 the reference substitutes p3 = 1 and
    p4 = 1 + q_vd/(1 - q_v) (geometry.py:159-164); reproduced exactly.

    Parameters are scalars except ``r_au``/``w_au`` (any broadcastable
    shapes, in au).  Returns time in **years**.
    """
    AU = 149597870700.0
    YEAR = 31536000.0

    w0_m = w_0 * AU
    r0_m = r_0 * AU
    v0_m = v_0 * 1e3
    mr0_m = mr0 * AU
    r1_m = r_1 * AU
    r2_m = r_2 * AU

    a = q_vd
    b = (1.0 - q_v + eps * q_vd) / eps
    const = mr0_m ** q_v / (v0_m * (1.0 - q_v + eps * q_vd))

    r_m = jnp.abs(r_au) * AU
    w_m = w_au * AU

    def indef_m(r_):
        rad = r_ + mr0_m - r0_m
        p1 = rad ** (1.0 - q_v)
        wr = w0_m * (rad / mr0_m) ** eps
        reff = r1_m + (r2_m - r1_m) * w_m / wr
        p2 = (reff / r1_m) ** (-q_vd)
        z = jnp.where(
            w_m == 0.0, 0.0,
            (r1_m * w0_m * rad ** eps) /
            jnp.where(w_m == 0.0, 1.0, w_m * mr0_m ** eps * (r1_m - r2_m)))
        u = z / (z - 1.0)
        p34 = hyp2f1_a1_series(a, b + 1.0, u, max_terms=max_terms, rtol=rtol)
        p34_w0 = 1.0 + q_vd / (1.0 - q_v)
        p34 = jnp.where(w_m == 0.0, p34_w0, p34)
        return const * p1 * p2 * p34

    # full_like keeps the coordinate dtype (a broadcast python float would
    # promote the launch-surface term to float64 under x64)
    return (indef_m(r_m) - indef_m(jnp.full_like(r_m, r0_m))) / YEAR
