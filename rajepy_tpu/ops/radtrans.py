"""Radiative-transfer kernels: free-free continuum, RRL cubes, LOS scans.

Replaces the reference's per-channel Python loops over full-grid numpy
algebra (classes.py:1353-1541 continuum, classes.py:1130-1351 RRL — SURVEY
§3.2 hot loops B/C) with fused, channel-batched XLA programs.

Key restructuring for the continuum: the free-free opacity

    tau(nu) = 0.018 T^-1.5 nu^-2 (n_e x)^2 ds g_ff          (classes.py:1395)

has frequency dependence that *factorises out of the grid*:
 - Reynolds (1986) eq. 1 gaunt approximation: g_ff = 11.95 T^0.15 nu^-0.1
   (classes.py:1393)  =>  tau = [0.2151 T^-1.35 (n_e x)^2 ds] * nu^-2.1
 - van Hoof et al. (2014) gaunt at uniform T (q_T = 0, classes.py:1388-1389)
   =>  tau = [0.018 T^-1.5 (n_e x)^2 ds] * nu^-2 * g_ff(nu, T_0)

so ONE line-of-sight reduction serves every channel; per-channel work is a
scalar multiply on an (nx, nz) map.  The reference instead re-walks the full
grid per channel (and `flux_ff` re-computes `optical_depth_ff` per channel a
second time, classes.py:1470-1475).

The LOS axis is y (axis 1, 'ij' indexing, classes.py:363-372).  All
reductions are masked sums — NaN-free — and associative, so they shard
cleanly over a device mesh with a trailing psum (see rajepy_tpu.parallel).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax

from .. import constants as cnsts
from . import gaunt as _gaunt
from . import physics as phys
from . import rrls as mrrl

LOS_AXIS = 1


# --------------------------------------------------------------------------- #
# Path length and emission measure
# --------------------------------------------------------------------------- #
def path_length_cm(ff, area, csize_au):
    """Per-cell LOS path element ds [cm]: csize * ff / area, zero outside
    (the reference's `csize * con.au * 1e2 * (ff/areas)` with NaNs,
    classes.py:1396-1397)."""
    safe_area = jnp.where(area > 0, area, 1.0)
    return jnp.where(area > 0, csize_au * cnsts.AU2CM * ff / safe_area, 0.0)


def emission_measure_map(n_e, x_i, ff, area, csize_au):
    """EM = sum_los (n_e x)^2 ds [pc cm^-6] (classes.py:1101-1128)."""
    return jnp.sum(emission_measure_base(n_e, x_i, ff, area, csize_au),
                   axis=LOS_AXIS)


def emission_measure_base(n_e, x_i, ff, area, csize_au):
    """Per-cell EM contribution (n_e x)^2 ds [pc cm^-6]; the LOS sum of
    this, optionally re-weighted by the burst factor squared, gives the EM
    map — the epoch-independent half of the time-dependent product."""
    safe_area = jnp.where(area > 0, area, 1.0)
    ds_pc = jnp.where(area > 0, csize_au * cnsts.AU / cnsts.PARSEC *
                      ff / safe_area, 0.0)
    return (n_e * x_i) ** 2 * ds_pc


# --------------------------------------------------------------------------- #
# Free-free continuum
# --------------------------------------------------------------------------- #
def tau_ff_base(temp, n_es, ds_cm, inside, reynolds_gaunt: bool):
    """Frequency-independent part of the free-free opacity per cell.

    reynolds_gaunt=True: cell factor for tau = base * nu^-2.1
    reynolds_gaunt=False (van Hoof): cell factor for
        tau = base * nu^-2 * gff(nu, T_0).
    """
    safe_t = jnp.where(inside, temp, 1.0)
    if reynolds_gaunt:
        base = 0.018 * 11.95 * safe_t ** -1.35 * n_es ** 2 * ds_cm
    else:
        base = 0.018 * safe_t ** -1.5 * n_es ** 2 * ds_cm
    return jnp.where(inside, base, 0.0)


def tau_ff_channel_scale(freqs, t_0: float, reynolds_gaunt: bool):
    """Per-channel scalar multiplier for the factorised free-free opacity."""
    freqs = jnp.asarray(freqs)
    if reynolds_gaunt:
        return freqs ** -2.1
    # keep the caller's dtype: the gaunt table is float64
    return freqs ** -2.0 * _gaunt.gff(freqs, t_0).astype(freqs.dtype)


def tau_ff_maps(freqs, temp, n_es, ds_cm, inside, t_0: float,
                reynolds_gaunt: bool):
    """Collapsed free-free optical-depth maps, all channels at once:
    (n_chan, nx, nz).  One grid pass total (classes.py:1353-1447
    recomputed per channel in the reference)."""
    base_map = jnp.sum(tau_ff_base(temp, n_es, ds_cm, inside,
                                   reynolds_gaunt), axis=LOS_AXIS)
    scale = tau_ff_channel_scale(freqs, t_0, reynolds_gaunt)
    return scale[:, None, None] * base_map[None, :, :]


def tau_ff_maps_from_static(freqs, base_static, chi2, t_0: float,
                            reynolds_gaunt: bool):
    """Collapsed tau maps from the epoch-independent base-opacity cube.

    Since the burst factor enters the opacity only through n_e^2
    (classes.py:872-899: number_density is chi-modulated, then squared at
    classes.py:1395), tau(t) = scale(nu) * sum_los A * chi(t)^2 with
    A = tau_ff_base(nd * xi).  The per-epoch chain then reads 3 cubes
    (A, ts, red) instead of ~8 — the time-dependent hot path at its HBM
    speed-of-light.  ``chi2`` may be a cube or the scalar 1 (no bursts).
    """
    base_map = jnp.sum(base_static * chi2, axis=LOS_AXIS)
    scale = tau_ff_channel_scale(freqs, t_0, reynolds_gaunt)
    return scale[:, None, None] * base_map[None, :, :]


def tau_ff_cube(freqs, temp, n_es, ds_cm, inside, t_0: float,
                reynolds_gaunt: bool):
    """Uncollapsed per-cell optical depths (n_chan, nx, ny, nz) — the
    reference's collapse=False path (classes.py:1366-1368)."""
    base = tau_ff_base(temp, n_es, ds_cm, inside, reynolds_gaunt)
    scale = tau_ff_channel_scale(freqs, t_0, reynolds_gaunt)
    return scale[:, None, None, None] * base[None]


def mean_temperature_map(temp, inside):
    """LOS-mean temperature over jet cells (nanmean of classes.py:1471-1472,
    as a masked mean)."""
    n = jnp.sum(inside, axis=LOS_AXIS)
    s = jnp.sum(jnp.where(inside, temp, 0.0), axis=LOS_AXIS)
    return jnp.where(n > 0, s / jnp.maximum(n, 1), 0.0), n > 0


def intensity_ff_maps(freqs, tau_maps, tbar_map, any_inside):
    """I_ff = 2 nu^2 k_B T_B / c^2 with T_B = mean(T) (1 - e^-tau)
    (classes.py:1449-1496).  Outside the jet silhouette the map is exactly 0
    (reference yields NaN there)."""
    freqs = jnp.asarray(freqs)
    t_b = tbar_map[None] * (-jnp.expm1(-tau_maps))
    ints = 2.0 * freqs[:, None, None] ** 2 * cnsts.K_B * t_b / cnsts.C ** 2
    return jnp.where(any_inside[None], ints, 0.0)


def flux_scale_jy(csize_au: float, dist_pc: float):
    """Pixel solid-angle factor arctan(csize/d)^2 / 1e-26 turning intensity
    into Jy/pixel (classes.py:1519-1521)."""
    return jnp.arctan((csize_au * cnsts.AU) /
                      (dist_pc * cnsts.PARSEC)) ** 2 / 1e-26


def flux_ff_maps(freqs, tau_maps, tbar_map, any_inside, csize_au, dist_pc):
    """Free-free flux maps [Jy/pixel] for all channels
    (classes.py:1498-1541)."""
    ints = intensity_ff_maps(freqs, tau_maps, tbar_map, any_inside)
    return ints * flux_scale_jy(csize_au, dist_pc)


# --------------------------------------------------------------------------- #
# Radio recombination lines
# --------------------------------------------------------------------------- #
class RRLCoeffs:
    """Static per-line constants resolved once per run
    (classes.py:1158-1171)."""

    def __init__(self, line: str):
        element, n, dn = mrrl.rrl_parser(line)
        self.line = line
        self.element = element
        self.n = n
        self.dn = dn
        self.nu0 = mrrl.rrl_nu_0(element, n, dn)
        self.fn1n2 = mrrl.f_n1n2(n, dn)
        self.energy_n = mrrl.energy_n(n, element)
        self.z = cnsts.z_number(element)


def tau_rrl_maps(coeffs: RRLCoeffs, freqs, temp, n_es, vy, ds_cm, inside,
                 remat: bool = False):
    """Collapsed RRL optical-depth maps for all channels: (n_chan, nx, nz).

    Per channel (classes.py:1130-1229): Doppler-shift the rest frequency by
    the cell's LOS velocity, thermal + Stark FWHMs, Voigt profile at the
    channel frequency, kappa_L (G&S 2.114), tau = kappa ds, masked-sum along
    y.  Channels are processed by ``lax.map`` so only one grid-shaped
    temporary set is live at a time (a (n_chan, nx, ny, nz) cube at 512^3
    would not fit HBM).

    ``remat=True`` wraps the per-channel body in ``jax.checkpoint`` for
    reverse-mode callers (the fit forwards): without it the lax.map VJP
    stacks every grid-shaped Voigt/kappa temporary per channel — ~20 GB
    of HLO temps at 256^3 x 17 channels, over HBM — with it only the
    collapsed (nx, nz) maps are stored and the channel body recomputes
    in the backward pass.  Forward-only callers leave it off.
    """
    safe_t = jnp.where(inside, temp, 1.0)
    safe_ne = jnp.where(inside, n_es, 0.0)
    rest = phys.doppler_shift(coeffs.nu0, vy)
    fwhm_g = mrrl.deltanu_g(rest, safe_t, coeffs.element)
    fwhm_l = mrrl.deltanu_l(safe_ne, coeffs.n, coeffs.dn)
    n_i = mrrl.ni_from_ne(safe_ne, coeffs.element)

    def one_channel(f):
        phi = mrrl.phi_voigt_nu(rest, fwhm_l, fwhm_g, f)
        kap = mrrl.kappa_l(f, coeffs.n, coeffs.fn1n2, phi, safe_ne, n_i,
                           safe_t, coeffs.z, coeffs.energy_n)
        tau = jnp.where(inside, kap * ds_cm, 0.0)
        return jnp.sum(tau, axis=LOS_AXIS)

    body = jax.checkpoint(one_channel) if remat else one_channel
    return lax.map(body, jnp.asarray(freqs))


def tau_rrl_precompute(coeffs: RRLCoeffs, temp, n_es, vy, ds_cm, inside):
    """Channel-independent per-cell factors of the RRL opacity, feeding
    the compacted-tile RRL path (:func:`tau_rrl_maps_tiles`):

        amp    = kappa_L prefactor x ds / (sigma_G sqrt(2 pi)): everything
                 but the profile's Re[w] and the stimulated-emission factor
        rest   = Doppler-shifted line centre per cell [Hz]
        scale  = 1/(sigma_G sqrt(2)) per cell [1/Hz]
        y_voigt= (fwhm_L/2) * scale per cell
        hkT    = h/(k_B T) per cell [1/Hz]
    """
    safe_t = jnp.where(inside, temp, 1.0)
    safe_ne = jnp.where(inside, n_es, 0.0)
    rest = phys.doppler_shift(coeffs.nu0, vy)
    fwhm_g = mrrl.deltanu_g(rest, safe_t, coeffs.element)
    fwhm_l = mrrl.deltanu_l(safe_ne, coeffs.n, coeffs.dn)
    n_i = mrrl.ni_from_ne(safe_ne, coeffs.element)

    sigma = fwhm_g / (2.0 * jnp.sqrt(2.0 * jnp.log(2.0)))
    sigma = jnp.where(inside, sigma, 1.0)
    scale = 1.0 / (sigma * jnp.sqrt(2.0))
    y_voigt = 0.5 * fwhm_l * scale

    amp = (mrrl._KAPPA_L_P0 * coeffs.n ** 2.0 * coeffs.fn1n2 *
           safe_ne * n_i / safe_t ** 1.5 *
           jnp.exp((coeffs.z ** 2.0 * coeffs.energy_n) /
                   (cnsts.K_CGS * safe_t)) *
           ds_cm / (sigma * jnp.sqrt(2.0 * jnp.pi)))
    amp = jnp.where(inside, amp, 0.0)
    hkT = cnsts.H_CGS / (cnsts.K_CGS * safe_t)
    return amp, rest, scale, y_voigt, hkT


def tau_rrl_tile_factors(coeffs: RRLCoeffs, freqs, temp_t, n_es_t, vy_t,
                         ds_t, inside_t):
    """float32 inputs of the RRL tile partials (ops.rrl_tiles) from
    compacted field tiles: ``(freqs_off, amp, rest_off, scale, y_voigt,
    hkT)``, with frequencies and line centres as offsets from nu0.

    The factors are computed in float64 and only then cast: a float32
    Doppler-shifted line centre quantises at ~1 kHz, which alone costs
    ~1e-4 of the map maximum (2e-7 with this order).  The tiles are a
    few per cent of the grid, so the float64 pass is cheap."""
    f64 = jnp.float64
    amp, rest, scale, y_voigt, hkT = tau_rrl_precompute(
        coeffs, temp_t.astype(f64), n_es_t.astype(f64), vy_t.astype(f64),
        ds_t.astype(f64), inside_t)
    f32 = jnp.float32
    nu0 = float(coeffs.nu0)
    return ((jnp.asarray(freqs) - nu0).astype(f32), amp.astype(f32),
            (rest - nu0).astype(f32), scale.astype(f32),
            y_voigt.astype(f32), hkT.astype(f32))


def tau_rrl_maps_tiles(coeffs: RRLCoeffs, freqs, temp_t, n_es_t, vy_t,
                       ds_t, inside_t, seg, nx: int, nz: int,
                       partials=None):
    """Collapsed RRL optical-depth maps (n_chan, nx, nz) from COMPACTED
    jet-occupied field tiles (ops.tiles.gather_tiles): the
    channel-independent opacity factors are evaluated only on the few
    per cent of the grid the jet occupies, the Voigt sums run per tile
    (ops.rrl_tiles), and the maps are reassembled with a segment-sum over
    (x, z)-tile ids.  ``partials`` computes the per-tile Voigt sums
    (default: ops.rrl_tiles.rrl_tile_partials, the platform's choice)."""
    from .rrl_tiles import rrl_tile_partials
    from .tiles import segment_tile_maps
    parts = (partials or rrl_tile_partials)(
        *tau_rrl_tile_factors(coeffs, freqs, temp_t, n_es_t, vy_t, ds_t,
                              inside_t), nu0=float(coeffs.nu0))
    return segment_tile_maps(parts, seg, nx, nz)


def tau_rrl_cube(coeffs: RRLCoeffs, freqs, temp, n_es, vy, ds_cm, inside):
    """Uncollapsed RRL optical depths (n_chan, nx, ny, nz) — collapse=False
    parity path."""
    safe_t = jnp.where(inside, temp, 1.0)
    safe_ne = jnp.where(inside, n_es, 0.0)
    rest = phys.doppler_shift(coeffs.nu0, vy)
    fwhm_g = mrrl.deltanu_g(rest, safe_t, coeffs.element)
    fwhm_l = mrrl.deltanu_l(safe_ne, coeffs.n, coeffs.dn)
    n_i = mrrl.ni_from_ne(safe_ne, coeffs.element)

    def one_channel(f):
        phi = mrrl.phi_voigt_nu(rest, fwhm_l, fwhm_g, f)
        kap = mrrl.kappa_l(f, coeffs.n, coeffs.fn1n2, phi, safe_ne, n_i,
                           safe_t, coeffs.z, coeffs.energy_n)
        return jnp.where(inside, kap * ds_cm, 0.0)

    return lax.map(one_channel, jnp.asarray(freqs))


def intensity_rrl_maps(freqs, tbar_map, tau_ff_maps_, tau_rrl_maps_,
                       any_inside):
    """LTE RRL intensity maps: B_nu(T) e^-tau_c (1 - e^-tau_L)
    (classes.py:1231-1290; rrls.py:428-449)."""
    freqs = jnp.asarray(freqs)
    safe_t = jnp.where(any_inside, tbar_map, 1.0)[None]
    ints = mrrl.line_intensity_lte(freqs[:, None, None], safe_t,
                                   tau_ff_maps_, tau_rrl_maps_)
    return jnp.where(any_inside[None], ints, 0.0)


def tau_rrl_maps_nonlte(freqs, tbar_map, any_inside, tau_rrl_maps_,
                        b_n1, b_n2):
    """Stimulated-corrected non-LTE line opacity b_n1 beta tau_L*
    (G&S eq. 2.141) — the ONE definition shared by JetModel._nonlte_tau
    (tau products, rrl_rt_products) and parallel.fanout's sharded RRL
    runs: a composition fix must reach every path exactly once."""
    freqs = jnp.asarray(freqs)
    safe_t = jnp.where(any_inside, tbar_map, 1.0)[None]
    beta = mrrl.beta_coeff(freqs[:, None, None], safe_t, b_n1, b_n2)
    return b_n1 * beta * tau_rrl_maps_


def intensity_rrl_maps_nonlte(freqs, tbar_map, tau_ff_maps_, tau_rrl_maps_,
                              any_inside, b_n1, b_n2):
    """Non-LTE RRL intensity maps from departure coefficients
    (beyond-reference: the reference raises on lte=False,
    classes.py:1258-1262; see ops.rrls.line_intensity_nonlte)."""
    freqs = jnp.asarray(freqs)
    safe_t = jnp.where(any_inside, tbar_map, 1.0)[None]
    ints = mrrl.line_intensity_nonlte(freqs[:, None, None], safe_t,
                                      tau_ff_maps_, tau_rrl_maps_,
                                      b_n1, b_n2)
    return jnp.where(any_inside[None], ints, 0.0)


# --------------------------------------------------------------------------- #
# Ordered radiative transfer along the line of sight (beyond-reference mode)
# --------------------------------------------------------------------------- #
def transfer_scan(source_fn_cgs, dtau, observer_near_y0: bool = False):
    """Emergent intensity from the ordered transfer integral
    I = sum_i S_i e^{-tau_acc,i} (1 - e^{-dtau_i}) along the LOS (y).

    The reference only supports the isothermal-slab form T_bar (1 - e^-tau)
    (classes.py:1471-1473); this is the full attenuated sum the BASELINE
    north-star asks for, expressed with an exclusive cumulative sum (an
    associative scan XLA maps onto a parallel prefix).

    ``observer_near_y0``: the observer sits at y -> -infinity when True
    (material at smaller y is in front), else at y -> +infinity.  The
    reference's +y axis points away from the observer for the blue jet.
    """
    if observer_near_y0:
        dtau_o = dtau
        src_o = source_fn_cgs
    else:
        dtau_o = jnp.flip(dtau, axis=LOS_AXIS)
        src_o = jnp.flip(source_fn_cgs, axis=LOS_AXIS)
    tau_acc = jnp.cumsum(dtau_o, axis=LOS_AXIS) - dtau_o  # exclusive prefix
    contrib = src_o * jnp.exp(-tau_acc) * (-jnp.expm1(-dtau_o))
    return jnp.sum(contrib, axis=LOS_AXIS)


def cumulative_tau(dtau):
    """Cumulative optical depth along the LOS (inclusive prefix scan)."""
    return jnp.cumsum(dtau, axis=LOS_AXIS)
