"""Derived science products: SEDs, spectral-index and turnover maps.

BASELINE config 4 asks for "multi-frequency SED + spectral-index/turnover
maps (0.3-300 GHz)" at high grid resolution.  The continuum factorisation
in :mod:`rajepy_tpu.ops.radtrans` makes the whole frequency axis nearly
free — one LOS reduction serves every channel — so these are thin fused
wrappers over the RT kernels.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import radtrans as rt


def sed(model, freqs) -> np.ndarray:
    """Spatially integrated free-free SED S_nu [Jy] over ``freqs`` [Hz]."""
    fluxes = model.flux_ff(np.atleast_1d(np.asarray(freqs, dtype=float)))
    return np.nansum(fluxes, axis=(1, 2))


def spectral_index_map(model, freq_lo: float, freq_hi: float,
                       min_flux_jy: float = 0.0) -> np.ndarray:
    """Two-point spectral-index map alpha = dlog S / dlog nu between two
    frequencies; NaN where either flux is at/below ``min_flux_jy``."""
    fluxes = model.flux_ff(np.asarray([freq_lo, freq_hi], dtype=float))
    lo, hi = fluxes[0], fluxes[1]
    with np.errstate(divide='ignore', invalid='ignore'):
        alpha = (np.log10(hi) - np.log10(lo)) / \
            (np.log10(freq_hi) - np.log10(freq_lo))
    return np.where((lo > min_flux_jy) & (hi > min_flux_jy), alpha, np.nan)


def sed_spectral_indices(freqs, seds) -> Tuple[np.ndarray, np.ndarray]:
    """Neighbouring-frequency spectral indices of an integrated SED and the
    log-mean frequencies they apply at (classes.py:2876+ / sed_plot)."""
    freqs = np.asarray(freqs, dtype=float)
    seds = np.asarray(seds, dtype=float)
    alphas = np.diff(np.log10(seds)) / np.diff(np.log10(freqs))
    fmid = 10 ** (0.5 * (np.log10(freqs[1:]) + np.log10(freqs[:-1])))
    return fmid, alphas


def light_curve(model, times_yr, freqs) -> np.ndarray:
    """Multi-epoch continuum light curve: integrated flux [Jy] of shape
    (n_times, n_chan) — BASELINE config 2.

    The only time-dependent factor in the RT chain is the ejection burst
    factor chi(t - travel_time) modulating the density
    (classes.py:861-899), so the static fields are computed once and a
    single jitted `lax.map` over epochs re-evaluates just
    chi -> tau -> flux.  The reference re-walks the entire lazy property
    chain per epoch (classes.py:2358-2424).
    """
    f = model._ensure_fields()
    freqs = jnp.atleast_1d(jnp.asarray(freqs, dtype=model._dtype))
    times = jnp.atleast_1d(jnp.asarray(times_yr, dtype=model._dtype)) * \
        31536000.0
    # the model's own per-epoch flux kernel: the cached static base cube
    # is passed as a runtime argument (a closure would capture O(N^3)
    # constants into the compiled program)
    flux_kernel = model._continuum_kernel('flux')

    # the jitted integrators live in the model's kernel cache — a fresh
    # @jax.jit closure per light_curve call would retrace and recompile
    # on every invocation
    if model._tiled():
        # compacted-tile epoch path: the per-epoch body is tiny, so the
        # whole light curve runs as ONE device program instead of one
        # dispatch and host pull per epoch
        from jax import lax

        def build_batch():
            def integrate_all(f, st, times, freqs):
                return lax.map(
                    lambda t: jnp.sum(flux_kernel.inner(f, st, t, freqs),
                                      axis=(1, 2)), times)
            return integrate_all

        fn = model._jitted('light_curve_batch', build_batch)
        return np.asarray(fn(f, flux_kernel.statics[0], times, freqs))

    def build_single():
        def integrate(f, st, t, freqs):
            fluxes = flux_kernel.inner(f, st, t, freqs)
            return jnp.sum(fluxes, axis=(1, 2))
        return integrate

    integrate = model._jitted('light_curve_single', build_single)
    # one compiled kernel called per epoch: each call returns only a
    # (n_chan,) vector, so dispatch is cheap, and the single-epoch body
    # compiles far faster than a lax.map/scan over epochs at 512^3 (the
    # f64/CPU full-grid body is the expensive thing to compile there)
    return np.stack([np.asarray(integrate(f, *flux_kernel.statics, t,
                                          freqs)) for t in times])


def moment_maps(cube, freqs, rest_freq: float) -> dict:
    """Velocity moment maps of an RRL cube.

    ``cube`` is (n_chan, nx, nz) — flux or optical depth; channel
    velocities come from the Doppler relation v = c (1 - nu/nu0).
    Returns {'mom0', 'mom1', 'mom2'}: integrated intensity
    [cube-units * km/s], intensity-weighted velocity [km/s] and velocity
    dispersion [km/s].
    """
    cube = np.asarray(cube, dtype=float)
    freqs = np.asarray(freqs, dtype=float)
    if freqs.size < 2:
        raise ValueError("moment_maps needs >= 2 channels to define a "
                         f"velocity axis (got {freqs.size})")
    v = 299792.458 * (1.0 - freqs / rest_freq)   # km/s
    dv = np.gradient(v)
    w = cube * np.abs(dv)[:, None, None]
    mom0 = w.sum(axis=0)
    safe = np.where(mom0 > 0, mom0, 1.0)
    mom1 = (w * v[:, None, None]).sum(axis=0) / safe
    mom2 = np.sqrt(np.maximum(
        (w * (v[:, None, None] - mom1[None]) ** 2).sum(axis=0) / safe,
        0.0))
    nanmask = mom0 <= 0
    mom1 = np.where(nanmask, np.nan, mom1)
    mom2 = np.where(nanmask, np.nan, mom2)
    return {'mom0': mom0, 'mom1': mom1, 'mom2': mom2}


def turnover_map(model, freqs, tau_unity: float = 1.0) -> np.ndarray:
    """Turnover-frequency map: the frequency at which the line-of-sight
    free-free optical depth crosses ``tau_unity`` per pixel.

    Uses the factorised opacity: tau(nu) = tau_base * s(nu) with s a known
    monotone decreasing function of frequency, so the crossing can be
    solved per pixel by log interpolation over the sampled ``freqs``
    rather than a search.  Pixels never optically thick return NaN;
    always-thick pixels return the highest sampled frequency.
    """
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    taus = model.optical_depth_ff(freqs)  # (n_chan, nx, nz)
    log_nu = np.log10(freqs)
    out = np.full(taus.shape[1:], np.nan)

    thick_any = taus[0] > tau_unity           # thickest at lowest nu
    always_thick = taus[-1] > tau_unity
    # per-pixel crossing via interpolation of log tau vs log nu
    with np.errstate(divide='ignore'):
        log_tau = np.where(taus > 0,
                           np.log10(np.maximum(taus, 1e-300)), -np.inf)
    for i in range(len(freqs) - 1):
        lo, hi = log_tau[i], log_tau[i + 1]
        crossing = (taus[i] > tau_unity) & (taus[i + 1] <= tau_unity)
        with np.errstate(divide='ignore', invalid='ignore'):
            frac = (np.log10(tau_unity) - lo) / (hi - lo)
        nu_c = 10 ** (log_nu[i] + frac * (log_nu[i + 1] - log_nu[i]))
        out = np.where(crossing & np.isnan(out), nu_c, out)
    out = np.where(always_thick, freqs[-1], out)
    out = np.where(~thick_any, np.nan, out)
    return out
