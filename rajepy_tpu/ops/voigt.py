"""Faddeeva function and Voigt profile in pure JAX.

The reference computes Voigt profiles with ``scipy.special.wofz``
(maths/rrls.py:329-359), unavailable on device.  Here ``w(z)`` for the upper
half-plane is built from:

* Weideman (1994, SIAM J. Numer. Anal. 31, 1497) rational approximation of
  degree N (coefficients precomputed on host at import), and
* a Laplace continued fraction for ``|x| + y`` beyond the rational region,
  which avoids the cancellation that limits the rational form near the real
  axis at large |x|, and
* (float64 only) a small-``y`` branch that Taylor-expands from the real
  axis, where ``Re w(x) = exp(-x**2)`` is exact — the rational form loses
  all relative accuracy there because ``Re w`` is exponentially small while
  its roundoff floor is absolute.

Composite float64 accuracy vs scipy.special.wofz over x in [0, 1e3],
y in [0, 1e3] (incl. y = 0 and y down to 1e-10): max relative error
3.4e-10 on Re, 2e-13 on Im (measured, tests/test_rrl_extras.py) — inside
the framework's 1e-6 end-to-end flux-parity contract with three orders of
margin.  The float32 path keeps the cheaper N=32 rational (~1.6e-4 worst /
5e-6 p99, at the f32 resolution limit).

Only the real part (the Voigt function) is needed by the RRL opacity kernel,
but both parts are returned for completeness.  Complex arithmetic is written
out in real/imaginary pairs, so the same expressions also run inside a
Pallas kernel, which has no complex type.

:func:`voigt_re_mixed` is the float32 real-part evaluator of the
compacted-tile RRL path (ops.rrl_tiles): Weideman N=16 in the core and a
3-term asymptotic series in the wings, one division each.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

_SQRT_PI = 1.7724538509055159
_N_WEIDEMAN = 128          # float64 rational degree (roundoff-floor accurate)
_CF_LEVELS_F64 = 15        # float64 continued-fraction depth
_CF_LEVELS_F32 = 9
_Y_TAYLOR_F64 = 3e-5       # below this, Taylor from the exact real-axis value


@lru_cache(maxsize=4)
def _weideman_coeffs(n: int = _N_WEIDEMAN):
    """Host-side FFT computation of the Weideman (1994) expansion
    coefficients and scale L."""
    m = 2 * n
    m2 = 2 * m
    ell = np.sqrt(n / np.sqrt(2.0))
    k = np.arange(-m + 1, m)
    theta = k * np.pi / m
    t = ell * np.tan(theta / 2.0)
    f = np.exp(-t ** 2) * (ell ** 2 + t ** 2)
    f = np.append(0.0, f)
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = np.flipud(a[1:n + 1])
    return ell, a


def _wofz_core(x, y, n_weideman, cf_levels, s_cut):
    """Weideman-rational (interior) / continued-fraction (wings) composite.

    ``x``/``y`` arrays of a common float dtype, ``y >= 0``.  Branch-free.
    """
    dtype = jnp.result_type(x, y)
    ell, a_np = _weideman_coeffs(n_weideman)
    a = jnp.asarray(a_np, dtype)

    s = jnp.abs(x) + y
    far = s > s_cut

    # ---- Weideman: Z = (L + iz)/(L - iz) with z = x + iy ------------------
    # L - iz = (L + y) - i x ; L + iz = (L - y) + i x
    # Far entries are evaluated at a harmless interior point to keep the
    # rational form pole-free where its result is discarded.
    xi = jnp.where(far, jnp.zeros_like(x), x)
    yi = jnp.where(far, jnp.zeros_like(y), y)
    dr, di = ell + yi, -xi
    nr, ni = ell - yi, xi
    den = dr * dr + di * di
    zr = (nr * dr + ni * di) / den
    zi = (ni * dr - nr * di) / den

    # Horner evaluation of p(Z) = sum a_k Z^k (a in descending order)
    pr = jnp.zeros_like(zr) + a[0]
    pi = jnp.zeros_like(zr)
    for k in range(1, a_np.shape[0]):
        pr, pi = pr * zr - pi * zi + a[k], pr * zi + pi * zr

    # w = 2 p / (L - iz)^2 + (1/sqrt(pi)) / (L - iz)
    inv_r, inv_i = dr / den, -di / den               # 1/(L - iz)
    inv2_r = inv_r * inv_r - inv_i * inv_i           # 1/(L - iz)^2
    inv2_i = 2.0 * inv_r * inv_i
    w_re = 2.0 * (pr * inv2_r - pi * inv2_i) + inv_r / _SQRT_PI
    w_im = 2.0 * (pr * inv2_i + pi * inv2_r) + inv_i / _SQRT_PI

    # ---- far wings: Laplace continued fraction ----------------------------
    # w(z) = (i/sqrt(pi)) / (z - (1/2)/(z - 1/(z - (3/2)/(z - ...))))
    xf = jnp.where(far, x, jnp.full_like(x, 10.0))
    yf = jnp.where(far, y, jnp.full_like(y, 10.0))
    rr = jnp.zeros_like(xf)
    ri = jnp.zeros_like(xf)
    for k in range(cf_levels, 0, -1):
        # r = (k/2) / (z - r)
        den_r = xf - rr
        den_i = yf - ri
        den = den_r * den_r + den_i * den_i
        rr = (k / 2.0) * den_r / den
        ri = -(k / 2.0) * den_i / den
    den_r = xf - rr
    den_i = yf - ri
    den = den_r * den_r + den_i * den_i
    # w = (i/sqrt(pi)) * conj-style division: i/(den_r + i*den_i)
    asym_re = den_i / (den * _SQRT_PI)
    asym_im = den_r / (den * _SQRT_PI)

    return (jnp.where(far, asym_re, w_re),
            jnp.where(far, asym_im, w_im))


@jax.custom_jvp
def wofz(x, y):
    """Faddeeva function ``w(x + iy)`` for ``y >= 0``.

    Returns ``(re, im)``.  The scheme follows the input dtype:

    * **float64** — Weideman N=128 interior, 15-level continued fraction for
      ``|x| + y > 9``, and for ``y < 3e-5`` a third-order Taylor expansion
      from the real axis where ``Re w(x) = exp(-x**2)`` is exact (the
      derivatives follow from ``w' = -2 z w + 2i/sqrt(pi)``).  Measured
      worst-case relative error vs ``scipy.special.wofz``: 3.4e-10 on Re,
      2e-13 on Im over x,y in [0, 1e3] including y = 0.
    * **float32** — Weideman N=32 / 9-level fraction (~1.6e-4 worst,
      5e-6 p99 — the f32 resolution limit at half the cost), so float32
      production models automatically take the fast path.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    dtype = jnp.result_type(x, y)
    if dtype == jnp.float32:
        return _wofz_core(x, y, 32, _CF_LEVELS_F32, 8.0)

    tiny = y < _Y_TAYLOR_F64
    y_eff = jnp.where(tiny, jnp.zeros_like(y), y)
    w_re, w_im = _wofz_core(x, y_eff, _N_WEIDEMAN, _CF_LEVELS_F64, 9.0)

    # Small-y branch: the composite's Im part at y=0 keeps full relative
    # accuracy (Im w ~ 1/(sqrt(pi) x), never exponentially small), but its
    # Re part has an absolute roundoff floor ~1e-15 while the true
    # Re w(x) = exp(-x^2) can be far below it.  Rebuild Re exactly on the
    # axis and Taylor both parts up to y^3 (error ~ y^4 |w''''| / 24,
    # < 1e-14 absolute at the 3e-5 threshold).
    w0r = jnp.exp(-x * x)
    w0i = w_im
    d1r = -2.0 * x * w0r                                  # w' = -2 z w + 2i/sqrt(pi)
    d1i = -2.0 * x * w0i + 2.0 / _SQRT_PI
    d2r = -2.0 * w0r - 2.0 * x * d1r                      # w'' = -2 w - 2 z w'
    d2i = -2.0 * w0i - 2.0 * x * d1i
    d3r = -4.0 * d1r - 2.0 * x * d2r                      # w''' = -4 w' - 2 z w''
    d3i = -4.0 * d1i - 2.0 * x * d2i
    y2 = y * y
    taylor_re = w0r - y * d1i - 0.5 * y2 * d2r + (y2 * y / 6.0) * d3i
    taylor_im = w0i + y * d1r - 0.5 * y2 * d2i - (y2 * y / 6.0) * d3r

    return (jnp.where(tiny, taylor_re, w_re),
            jnp.where(tiny, taylor_im, w_im))


@wofz.defjvp
def _wofz_jvp(primals, tangents):
    """Exact derivative via the Faddeeva ODE ``w'(z) = -2 z w(z) +
    2i/sqrt(pi)`` — one complex multiply on the already-computed primal
    instead of differentiating through the 128-term Horner recurrence
    (whose unrolled VJP costs ~100x the forward and dominates RRL fit
    gradients).  With ``z = x + iy``: d/dx w = w', d/dy w = i w'."""
    x, y = primals
    dx, dy = tangents
    wr, wi = wofz(x, y)
    dpr = -2.0 * (x * wr - y * wi)                    # Re w'
    dpi = -2.0 * (x * wi + y * wr) + 2.0 / _SQRT_PI   # Im w'
    return (wr, wi), (dpr * dx - dpi * dy, dpi * dx + dpr * dy)


def voigt_re_far(x, y):
    """Re[w(x + iy)] by the 3-term asymptotic series
    w(z) ~ i/(sqrt(pi) z) sum_k (2k-1)!!/(2 z^2)^k — 4.4e-7 max abs err
    over |x|+y > 8 (vs the f32 floor ~3e-8), ONE division instead of the
    Laplace continued fraction's ten.  Inputs must already satisfy
    |x|+y > 8."""
    inv = 1.0 / (x * x + y * y)
    wr2 = 0.5 * (x * x - y * y) * inv * inv   # Re 1/(2 z^2)
    wi2 = -x * y * inv * inv                  # Im 1/(2 z^2)
    sr = wr2 * 15.0 + 3.0
    si = wi2 * 15.0
    sr, si = sr * wr2 - si * wi2 + 1.0, sr * wi2 + si * wr2
    sr, si = sr * wr2 - si * wi2 + 1.0, sr * wi2 + si * wr2
    return (y * sr - x * si) * inv / _SQRT_PI


def voigt_re_weideman(x, y, *, ell: float, coeffs: tuple):
    """Re[w(x + iy)] by the Weideman rational alone (valid to 1.2e-7 abs
    for |x| + y <= 8 at N=16; callers select the asymptotic form beyond).

    The real-coefficient polynomial p(Z) at the complex Z = (L+iz)/(L-iz)
    is evaluated by the GOERTZEL second-order recurrence
    (b_k = c_k + 2 Re(Z) b_{k+1} - |Z|^2 b_{k+2};
    p = b_0 - b_1 conj(Z)) — 2 real FMAs per step instead of the complex
    Horner's 4 mul + 3 add, at identical f32 accuracy (6.3e-7 vs 6.1e-7
    max abs over the domain, both at the N=16 truncation floor).  One
    reciprocal serves every quotient."""
    dr = ell + y
    di = -x
    nr = ell - y
    ni = x
    inv_den = 1.0 / (dr * dr + di * di)
    zr = (nr * dr + ni * di) * inv_den
    zi = (ni * dr - nr * di) * inv_den
    r = 2.0 * zr
    s = zr * zr + zi * zi
    b1 = jnp.zeros_like(zr)
    b2 = jnp.zeros_like(zr)
    # highest power first — which is exactly the descending coeffs order
    for c in coeffs:
        b1, b2 = c + r * b1 - s * b2, b1
    pr = b1 - b2 * zr
    pi = b2 * zi
    inv_r = dr * inv_den
    inv_i = -di * inv_den
    inv2_r = inv_r * inv_r - inv_i * inv_i
    inv2_i = 2.0 * inv_r * inv_i
    return 2.0 * (pr * inv2_r - pi * inv2_i) + inv_r / _SQRT_PI


def voigt_re_mixed(x, y, *, ell: float, coeffs: tuple):
    """Re[w(x + iy)]: Weideman rational (centre) / asymptotic series
    (wings), selected per element."""
    w_re = voigt_re_weideman(x, y, ell=ell, coeffs=coeffs)
    far = (jnp.abs(x) + y) > 8.0
    xf = jnp.where(far, x, 10.0)   # clamp near elements out of the
    yf = jnp.where(far, y, 10.0)   # asymptotic's singular region
    return jnp.where(far, voigt_re_far(xf, yf), w_re)


def weideman16():
    """(L, coefficients) of the N=16 Weideman rational as Python floats.
    At f32 the N=16 truncation error (1.4e-7 max on |x|<=8,
    1e-5<=y<=8 vs scipy wofz) already sits at the f32 roundoff floor;
    N=32 buys nothing but doubles the recurrence."""
    ell, a_np = _weideman_coeffs(16)
    return float(ell), tuple(float(v) for v in a_np)


def voigt_profile(dnu, fwhm_gauss, fwhm_lorentz):
    """Area-normalised Voigt profile ``phi_V(nu0 + dnu)`` [Hz^-1].

    Matches the reference's ``phi_voigt_nu`` (rrls.py:329-359):
    ``Re w((dnu + i G/2) / (sigma sqrt 2)) / (sigma sqrt(2 pi))`` with
    ``sigma = fwhm_gauss / (2 sqrt(2 ln 2))`` and ``G = fwhm_lorentz``.
    """
    sigma = fwhm_gauss / (2.0 * jnp.sqrt(2.0 * jnp.log(2.0)))
    scale = 1.0 / (sigma * jnp.sqrt(2.0))
    x = dnu * scale
    y = 0.5 * fwhm_lorentz * scale
    re, _ = wofz(x, y)
    return re / (sigma * jnp.sqrt(2.0 * jnp.pi))
