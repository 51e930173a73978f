"""Antenna-based gain corruption and self-calibration.

The reference's synthetic observations corrupt with thermal noise only
(CASA simobserve, /root/reference/casa/tasks.py:196-206); real reductions
of such data additionally suffer — and then solve for — antenna-based
complex gain errors (tropospheric phase, electronic amplitude drifts).
This module supplies the missing half of that workflow, the analogue of
CASA's ``sm.setgain`` / ``gaincal(gaintype='G')`` / ``applycal``:

* :func:`simulate_gain_errors` — per-antenna complex gain tracks
  (amplitude and phase AR(1) random walks with a coherence time);
* :func:`apply_gains` — corrupt (or, with ``invert=True``, correct)
  visibilities with per-time per-antenna gains;
* :func:`solve_gains` — StEFCal (Salvini & Wijnholds 2014, A&A 571 A97)
  antenna-gain solutions against a model visibility set, vectorised over
  solution intervals with ``vmap`` — the per-interval working set is a
  dense (n_ant, n_ant) visibility matrix, so the whole multi-interval
  solve is one small batched device program;
* :func:`correct_vis` — expand interval solutions to the time axis and
  apply their inverse (``applycal``).

Array conventions match the rest of :mod:`rajepy_tpu.synthobs`: all
endpoints take and return (re, im) float pairs, and complex arithmetic
exists only inside the jitted programs (f32 in -> c64).
Visibilities are shaped ``(..., n_vis)`` (leading channel axes allowed)
with per-visibility ``ant1``/``ant2``/``t_index`` integer metadata, the
flattening produced by :func:`simulate_observation` (time-major,
baseline-minor).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import sampler


def simulate_gain_errors(seed: int, n_t: int, n_ant: int,
                         amp_rms: float = 0.0,
                         phase_rms_deg: float = 0.0,
                         coherence_s: Optional[float] = None,
                         t_int_s: Optional[float] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-antenna complex gain error tracks, shape (n_t, n_ant) each.

    Phases (and fractional amplitude offsets) follow stationary AR(1)
    processes with marginal standard deviations ``phase_rms_deg`` /
    ``amp_rms``: when ``coherence_s`` and ``t_int_s`` are given the
    lag-1 correlation is ``exp(-t_int_s / coherence_s)`` (a discretised
    Ornstein-Uhlenbeck track — adjacent integrations share the same
    atmosphere); otherwise samples are independent per integration.

    Host-side numpy by design: the track is a few-kB array generated once
    per observation.
    """
    rng = np.random.default_rng(seed)
    if coherence_s is not None and t_int_s is not None and coherence_s > 0:
        rho = float(np.exp(-float(t_int_s) / float(coherence_s)))
    else:
        rho = 0.0

    def ar1(rms):
        if rms == 0.0 or n_t == 0:
            return np.zeros((n_t, n_ant))
        x = np.empty((n_t, n_ant))
        x[0] = rng.standard_normal(n_ant)
        innov = np.sqrt(1.0 - rho ** 2)
        for t in range(1, n_t):
            x[t] = rho * x[t - 1] + innov * rng.standard_normal(n_ant)
        return x * rms

    phase = ar1(np.radians(phase_rms_deg))
    amp = 1.0 + ar1(amp_rms)
    return amp * np.cos(phase), amp * np.sin(phase)


@partial(jax.jit, static_argnames=('invert',))
def _apply_gains(vr, vi, g_re, g_im, ant1, ant2, t_index, invert):
    g = jax.lax.complex(g_re, g_im)
    f = g[t_index, ant1] * jnp.conj(g[t_index, ant2])
    v = jax.lax.complex(vr, vi)
    out = v / f if invert else v * f
    return out.real, out.imag


def apply_gains(vis_re, vis_im, g_re, g_im, ant1, ant2, t_index,
                invert: bool = False):
    """Corrupt (or correct) visibilities with per-time antenna gains.

    V'_ij(t) = g_i(t) conj(g_j(t)) V_ij(t); ``invert=True`` divides
    instead (``applycal``).  ``g_re/g_im``: (n_t, n_ant); ``vis_*``:
    (..., n_vis) broadcast over leading axes; ``ant1/ant2/t_index``:
    (n_vis,) int.
    """
    dt = jnp.result_type(vis_re)
    return _apply_gains(jnp.asarray(vis_re), jnp.asarray(vis_im),
                        jnp.asarray(g_re, dt), jnp.asarray(g_im, dt),
                        jnp.asarray(ant1, jnp.int32),
                        jnp.asarray(ant2, jnp.int32),
                        jnp.asarray(t_index, jnp.int32), bool(invert))


def _stefcal_one(R, M, n_iter: int, phase_only: bool, ref_ant: int):
    """StEFCal ADI iteration for one solution interval.

    R, M: dense hermitian (n_ant, n_ant) observed / model visibility
    matrices with zero diagonals.  Returns the complex gain vector g with
    R ~= diag(g) M diag(g)^H, phase-referenced to ``ref_ant``.
    """
    n_ant = R.shape[0]
    cdt = R.dtype
    g0 = jnp.ones((n_ant,), cdt)

    def body(k, carry):
        g, g_prev = carry
        # column j model: R_ij ~= z_ij conj(g_j) with z_ij = g_i M_ij;
        # least squares for g_j gives sum_i z_ij conj(R_ij) / sum |z_ij|^2
        z = g[:, None] * M
        num = jnp.sum(z * jnp.conj(R), axis=0)   # per antenna j
        den = jnp.sum(jnp.abs(z) ** 2, axis=0)
        g_new = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0),
                          g)
        # ADI averaging on odd steps (Salvini & Wijnholds alg. 2):
        # plain alternating updates oscillate between two fixed points
        g_new = jnp.where(k % 2 == 1, 0.5 * (g_new + g), g_new)
        if phase_only:
            # project AFTER the average: averaging two unit phasors
            # gives |g| = cos(dphi/2) < 1, and the iterate (hence the
            # returned solution) must honour the |g| = 1 contract
            a = jnp.abs(g_new)
            g_new = jnp.where(a > 0, g_new / jnp.where(a > 0, a, 1.0),
                              g_new)
        return g_new, g

    g, _ = jax.lax.fori_loop(0, n_iter, body, (g0, g0))
    # reference-antenna phase convention: angle(g[ref_ant]) = 0
    ref = g[ref_ant]
    ref_phase = jnp.where(jnp.abs(ref) > 0,
                          ref / jnp.where(jnp.abs(ref) > 0,
                                          jnp.abs(ref), 1.0),
                          jnp.asarray(1.0, cdt))
    return g * jnp.conj(ref_phase)


def _solve_core(vr, vi, mr, mi, ant1, ant2, t_index, n_ant, n_sol, n_t,
                n_iter, phase_only, ref_ant):
    """Interval-averaged StEFCal solve on 1-D (n_vis,) visibilities."""
    sol = (t_index.astype(jnp.int32) * n_sol) // n_t
    flat = (sol * n_ant + ant1) * n_ant + ant2
    nseg = n_sol * n_ant * n_ant

    def herm_matrix(re, im):
        sr = jax.ops.segment_sum(re, flat, num_segments=nseg)
        si = jax.ops.segment_sum(im, flat, num_segments=nseg)
        cnt = jax.ops.segment_sum(jnp.ones_like(re), flat,
                                  num_segments=nseg)
        avg = jax.lax.complex(sr, si) / jnp.maximum(cnt, 1.0)
        A = avg.reshape(n_sol, n_ant, n_ant)
        return A + jnp.conj(jnp.swapaxes(A, 1, 2))

    R = herm_matrix(vr, vi)
    M = herm_matrix(mr, mi)
    g = jax.vmap(lambda r, m: _stefcal_one(r, m, n_iter, phase_only,
                                           ref_ant))(R, M)
    return g.real, g.imag


@partial(jax.jit, static_argnames=('n_ant', 'n_sol', 'n_t', 'n_iter',
                                   'phase_only', 'ref_ant'))
def _solve_gains(vr, vi, mr, mi, ant1, ant2, t_index, n_ant, n_sol, n_t,
                 n_iter, phase_only, ref_ant):
    # channel-average first (gaincal 'G' solves one gain per solint from
    # all channels in the spw); leading axes are channels
    vr = vr.reshape(-1, vr.shape[-1]).mean(axis=0)
    vi = vi.reshape(-1, vi.shape[-1]).mean(axis=0)
    mr = mr.reshape(-1, mr.shape[-1]).mean(axis=0)
    mi = mi.reshape(-1, mi.shape[-1]).mean(axis=0)
    return _solve_core(vr, vi, mr, mi, ant1, ant2, t_index, n_ant, n_sol,
                       n_t, n_iter, phase_only, ref_ant)


@partial(jax.jit, static_argnames=('n_ant', 'n_sol', 'n_t', 'n_iter',
                                   'phase_only', 'ref_ant'))
def _solve_bandpass(vr, vi, mr, mi, ant1, ant2, t_index, n_ant, n_sol,
                    n_t, n_iter, phase_only, ref_ant):
    # per-channel solves (gaincal 'B'): vmap the interval solve over the
    # leading channel axis — all channels' dense gain matrices in one
    # batched device program
    solve = lambda a, b, c, d: _solve_core(a, b, c, d, ant1, ant2,
                                           t_index, n_ant, n_sol, n_t,
                                           n_iter, phase_only, ref_ant)
    return jax.vmap(solve)(vr, vi, mr, mi)


def solve_gains(vis_re, vis_im, mdl_re, mdl_im, ant1, ant2, t_index,
                n_ant: int, n_t: int, n_sol: int = 1,
                mode: str = 'amp+phase', n_iter: int = 50,
                ref_ant: int = 0, per_channel: bool = False):
    """Antenna gain solutions against a model visibility set.

    Splits the time axis into ``n_sol`` equal solution intervals, averages
    observed and model visibilities per (interval, baseline) — and over
    any leading channel axes — into dense hermitian (n_ant, n_ant)
    matrices, and runs the StEFCal alternating solver per interval under
    ``vmap``.  ``mode='phase'`` constrains |g| = 1 (phase-only selfcal);
    ``mode='amp+phase'`` solves the full complex gain.

    ``per_channel=True`` is the bandpass solve (gaincal ``'B'``): no
    channel averaging — every channel gets its own gain solution (the
    channel axis is vmapped over the batched interval solve), returned
    as (n_chan, n_sol, n_ant) and applicable with
    :func:`apply_bandpass` / :func:`correct_vis`.

    Returns (g_re, g_im), each (n_sol, n_ant) — or (n_chan, n_sol,
    n_ant) with ``per_channel`` — phase-referenced so antenna
    ``ref_ant`` has zero phase per interval.
    """
    if mode not in ('phase', 'amp+phase'):
        raise ValueError(f"unknown mode {mode!r}")
    dt = jnp.result_type(vis_re)
    fn = _solve_bandpass if per_channel else _solve_gains
    vr = jnp.asarray(vis_re, dt)
    if per_channel and vr.ndim != 2:
        raise ValueError("per_channel solve needs (n_chan, n_vis) "
                         "visibilities")
    return fn(vr, jnp.asarray(vis_im, dt),
              jnp.asarray(mdl_re, dt), jnp.asarray(mdl_im, dt),
              jnp.asarray(ant1, jnp.int32),
              jnp.asarray(ant2, jnp.int32),
              jnp.asarray(t_index, jnp.int32),
              int(n_ant), int(n_sol), int(n_t), int(n_iter),
              mode == 'phase', int(ref_ant))


@partial(jax.jit, static_argnames=('invert',))
def _apply_gains_pc(vr, vi, g_re, g_im, ant1, ant2, t_index, invert):
    g = jax.lax.complex(g_re, g_im)                 # (n_chan, n_t, n_ant)
    f = g[:, t_index, ant1] * jnp.conj(g[:, t_index, ant2])
    v = jax.lax.complex(vr, vi)
    out = v / f if invert else v * f
    return out.real, out.imag


def apply_bandpass(vis_re, vis_im, g_re, g_im, ant1, ant2, t_index,
                   invert: bool = False):
    """Per-channel variant of :func:`apply_gains`: gains shaped
    (n_chan, n_t, n_ant) applied to (n_chan, n_vis) visibilities."""
    dt = jnp.result_type(vis_re)
    return _apply_gains_pc(jnp.asarray(vis_re), jnp.asarray(vis_im),
                           jnp.asarray(g_re, dt), jnp.asarray(g_im, dt),
                           jnp.asarray(ant1, jnp.int32),
                           jnp.asarray(ant2, jnp.int32),
                           jnp.asarray(t_index, jnp.int32), bool(invert))


def expand_solutions(g_re, g_im, n_t: int):
    """Map (..., n_sol, n_ant) interval solutions onto the time axis
    (..., n_t, n_ant) with the same equal-interval rule as the solver."""
    g_re = np.asarray(g_re)
    n_sol = g_re.shape[-2]
    sol = (np.arange(n_t) * n_sol) // n_t
    return np.asarray(g_re)[..., sol, :], np.asarray(g_im)[..., sol, :]


def correct_vis(vis_re, vis_im, g_re_sol, g_im_sol, ant1, ant2, t_index,
                n_t: int):
    """``applycal``: expand interval solutions to per-time gains and
    divide them out of the visibilities.  Dispatches on the solution
    shape: (n_sol, n_ant) applies one gain across all channels
    (gaincal 'G'); (n_chan, n_sol, n_ant) applies each channel its own
    solution (bandpass 'B')."""
    g_re, g_im = expand_solutions(g_re_sol, g_im_sol, n_t)
    fn = apply_bandpass if g_re.ndim == 3 else apply_gains
    return fn(vis_re, vis_im, g_re, g_im, ant1, ant2, t_index,
              invert=True)


# --------------------------------------------------------------------------- #
# Closure quantities — gain-immune observables
# --------------------------------------------------------------------------- #
def baseline_index_table(n_ant: int) -> np.ndarray:
    """(n_ant, n_ant) lookup from an (i, j) antenna pair (i < j) to its
    row in the triu-ordered baseline list of :func:`uvgen.baselines`."""
    tab = np.full((n_ant, n_ant), -1, dtype=np.int32)
    i, j = np.triu_indices(n_ant, k=1)
    tab[i, j] = np.arange(i.size, dtype=np.int32)
    return tab


def closure_triangles(n_ant: int) -> np.ndarray:
    """All antenna triangles (i < j < k), shape (n_tri, 3).  The full
    set is redundant (rank n_bl - n_ant + 1) but loses no information
    and keeps the arrays static-shaped."""
    from itertools import combinations
    tri = np.asarray(list(combinations(range(n_ant), 3)), dtype=np.int32)
    return tri.reshape(-1, 3)   # shape (0, 3), not (0,), when n_ant < 3


def closure_quads(n_ant: int) -> np.ndarray:
    """All antenna quadrangles (i < j < k < l), shape (n_quad, 4), read
    as the canonical amplitude ratio |V_ij V_kl| / |V_ik V_jl|."""
    from itertools import combinations
    quad = np.asarray(list(combinations(range(n_ant), 4)), dtype=np.int32)
    return quad.reshape(-1, 4)  # shape (0, 4), not (0,), when n_ant < 4


def closure_index_arrays(n_ant: int):
    """Baseline-index gather arrays for the full triangle/quadrangle
    sets: ``{'tri': (ij, jk, ik), 'quad': (ij, kl, ik, jl)}`` — the
    shared indexing used by the (re, im) endpoints here and by the
    in-trace fit losses (:mod:`rajepy_tpu.fit`)."""
    tab = baseline_index_table(n_ant)
    tri = closure_triangles(n_ant)
    quad = closure_quads(n_ant)
    return {
        'tri': tuple(jnp.asarray(tab[tri[:, a], tri[:, b]])
                     for a, b in ((0, 1), (1, 2), (0, 2))),
        'quad': tuple(jnp.asarray(tab[quad[:, a], quad[:, b]])
                      for a, b in ((0, 1), (2, 3), (0, 2), (1, 3))),
    }


def bisp_core(v, bl_ij, bl_jk, bl_ik):
    """Bispectrum of complex visibilities (..., n_t, n_bl) over
    triangle gathers: B = V_ij V_jk conj(V_ik)."""
    return v[..., bl_ij] * v[..., bl_jk] * jnp.conj(v[..., bl_ik])


def logclamp_core(v, q_ij, q_kl, q_ik, q_jl, eps: float = 1e-30):
    """Log closure amplitudes of complex visibilities (..., n_t, n_bl)
    over quadrangle gathers: ln(|V_ij||V_kl| / |V_ik||V_jl|)."""
    a2 = v.real ** 2 + v.imag ** 2
    return 0.5 * (jnp.log(a2[..., q_ij] + eps) +
                  jnp.log(a2[..., q_kl] + eps) -
                  jnp.log(a2[..., q_ik] + eps) -
                  jnp.log(a2[..., q_jl] + eps))


@jax.jit
def _bispectrum_jit(vr, vi, bl_ij, bl_jk, bl_ik):
    b = bisp_core(jax.lax.complex(vr, vi), bl_ij, bl_jk, bl_ik)
    return b.real, b.imag


def bispectrum(vis_re, vis_im, n_ant: int, n_t: int, triangles=None):
    """Bispectra B = V_ij V_jk conj(V_ik) over antenna ``triangles``.

    ``vis_*``: (..., n_t * n_bl) in the time-major full-pair layout of
    :func:`simulate_observation`.  Returns (b_re, b_im), each
    (..., n_t, n_tri).  Under antenna gains g the bispectrum picks up
    only the REAL factor |g_i g_j g_k|^2, so its phase — the closure
    phase — is immune to antenna-based phase corruption.
    """
    if triangles is None:
        bl_ij, bl_jk, bl_ik = closure_index_arrays(n_ant)['tri']
    else:
        tri = np.asarray(triangles, dtype=np.int32)
        tab = baseline_index_table(n_ant)
        bl_ij = jnp.asarray(tab[tri[:, 0], tri[:, 1]])
        bl_jk = jnp.asarray(tab[tri[:, 1], tri[:, 2]])
        bl_ik = jnp.asarray(tab[tri[:, 0], tri[:, 2]])
    vr = jnp.asarray(vis_re)
    vr = vr.reshape(vr.shape[:-1] + (n_t, -1))
    vi = jnp.asarray(vis_im).reshape(vr.shape)
    return _bispectrum_jit(vr, vi, bl_ij, bl_jk, bl_ik)


def closure_phases(vis_re, vis_im, n_ant: int, n_t: int, triangles=None):
    """Closure phases [rad], (..., n_t, n_tri): the bispectrum phases —
    immune to antenna-based gain phases (VLBI's primary observable when
    phase calibration is impossible)."""
    br, bi = bispectrum(vis_re, vis_im, n_ant, n_t, triangles)
    return np.arctan2(np.asarray(bi), np.asarray(br))


@jax.jit
def _logclamp_jit(vr, vi, bl_ij, bl_kl, bl_ik, bl_jl):
    return logclamp_core(jax.lax.complex(vr, vi), bl_ij, bl_kl, bl_ik,
                         bl_jl)


def log_closure_amplitudes(vis_re, vis_im, n_ant: int, n_t: int,
                           quads=None):
    """Log closure amplitudes ln(|V_ij||V_kl| / |V_ik||V_jl|) over
    antenna ``quads``, (..., n_t, n_quad): immune to antenna-based gain
    AMPLITUDES (each |g| enters numerator and denominator once)."""
    if quads is None:
        idx = closure_index_arrays(n_ant)['quad']
    else:
        q = np.asarray(quads, dtype=np.int32)
        tab = baseline_index_table(n_ant)
        idx = (jnp.asarray(tab[q[:, 0], q[:, 1]]),
               jnp.asarray(tab[q[:, 2], q[:, 3]]),
               jnp.asarray(tab[q[:, 0], q[:, 2]]),
               jnp.asarray(tab[q[:, 1], q[:, 3]]))
    vr = jnp.asarray(vis_re)
    vr = vr.reshape(vr.shape[:-1] + (n_t, -1))
    vi = jnp.asarray(vis_im).reshape(vr.shape)
    return np.asarray(_logclamp_jit(vr, vi, *idx))


@jax.jit
def _model_vis_jit(img, cell_rad, u, v):
    mv = sampler.sample_vis(img, cell_rad, u, v)
    return mv.real, mv.imag


@partial(jax.jit, static_argnames=('n_wplanes',))
def _model_vis_w_jit(img, cell_rad, u, v, w, n_wplanes):
    mv = sampler.sample_vis_wstack(img, cell_rad, u, v, w,
                                   n_wplanes=n_wplanes)
    return mv.real, mv.imag


def model_vis(image, cell_rad, u_wav, v_wav, w_wav=None,
              n_wplanes: int = 0):
    """(re, im) model visibilities of ``image`` at (u, v) [wavelengths]:
    the Kaiser-Bessel degridding forward model, wrapped so the complex
    intermediates stay inside the compiled program.

    When ``n_wplanes >= 1`` (and ``w_wav`` is given) the degrid routes
    through :func:`sampler.sample_vis_wstack` so selfcal model
    visibilities carry the SAME non-coplanar w phases as wide-field data
    sampled with w-stacking — a flat model against w-stacked data leaves
    a baseline-dependent phase mismatch no antenna-based gain solve can
    absorb."""
    image = jnp.asarray(image)
    dt = image.dtype
    if n_wplanes >= 1 and w_wav is not None:
        return _model_vis_w_jit(image, jnp.asarray(cell_rad, dt),
                                jnp.asarray(u_wav, dt),
                                jnp.asarray(v_wav, dt),
                                jnp.asarray(w_wav, dt), int(n_wplanes))
    return _model_vis_jit(image, jnp.asarray(cell_rad, dt),
                          jnp.asarray(u_wav, dt), jnp.asarray(v_wav, dt))


def vis_metadata(n_t: int, pairs: np.ndarray):
    """Per-visibility (ant1, ant2, t_index) for the time-major,
    baseline-minor flattening used by :func:`simulate_observation`
    (``uvw = concat(per-scan tracks).reshape(-1, 3)``)."""
    n_bl = pairs.shape[0]
    ant1 = np.tile(pairs[:, 0], n_t)
    ant2 = np.tile(pairs[:, 1], n_t)
    t_index = np.repeat(np.arange(n_t), n_bl)
    return ant1, ant2, t_index
