"""Run-level device fan-out for the pipeline's RT stage.

The reference's per-run loop is strictly sequential (classes.py:2358) and
its own README lists "parallelise ... different synthetic observations and
model calculations" as future work (README.md:379).  Runs in the pipeline
matrix (epochs x frequencies for the continuum, epochs x lines for RRLs)
are embarrassingly parallel: only the epoch time ``t`` (through the burst
factor chi) and the channel frequencies differ between them, while every
expensive static (field cubes, the factorised free-free base cube, the
LOS-mean temperature) is shared.

``continuum_runs_fanout`` / ``rrl_runs_fanout`` evaluate a whole group of
runs in ONE jitted ``shard_map`` program over a 1-D ('run',) device mesh:
the run axis is sharded, static fields are replicated, and each device
computes complete RT products (EM map, per-channel opacity maps, flux
maps) for its share of the run matrix with zero communication.  The host
then writes each run's FITS products exactly as the sequential path does
(`Pipeline.execute` consults the fanned cache before calling the
single-device model methods).

The per-run maths is the model's full-cube XLA formulation (the
non-tiled branch of ``JetModel._epoch_base_map`` / ``_rrl_kernel``), so
fanned products are bit-compatible with the sequential float64 path and
match the single-device compacted-tile float32 path to float32
tolerance.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import constants as cnsts
from ..models import ejection as ej
from ..ops import radtrans as rt


def run_mesh(mesh: Optional[Mesh] = None) -> Mesh:
    """A 1-D ('run',) mesh over all devices (or the given mesh's)."""
    devices = mesh.devices.ravel() if mesh is not None else \
        np.array(jax.devices())
    return Mesh(devices.reshape(-1), axis_names=('run',))


def _pad_runs(times_s, freqs_mat, n_dev: int, dtype
              ) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Pad the run axis to a device multiple (edge runs repeat — their
    results are sliced off)."""
    times = np.atleast_1d(np.asarray(times_s, dtype=float))
    freqs = np.atleast_2d(np.asarray(freqs_mat, dtype=float))
    n = len(times)
    pad = (-n) % n_dev
    if pad:
        times = np.pad(times, (0, pad), mode='edge')
        freqs = np.pad(freqs, ((0, pad), (0, 0)), mode='edge')
    return jnp.asarray(times, dtype), jnp.asarray(freqs, dtype), n


def _chi2_fn(model):
    """Traced per-epoch squared burst factor (the model's _chi2),
    taking the two cubes it reads explicitly (red side, travel times)."""
    spec_r, spec_b = model._spec_r, model._spec_b
    has_bursts = model._has_bursts
    dtype = model._dtype

    def chi2(red, ts, t):
        if has_bursts:
            chi = ej.chi_field(red, t - ts, spec_r, spec_b)
            return chi * chi
        return jnp.asarray(1.0, dtype)

    return chi2


def _burst_cubes(model, f):
    """(red, ts) for the fan-out — tiny placeholders when the model has
    no bursts, so burst-free fan-outs replicate nothing extra."""
    if model._has_bursts:
        return f.red, f.ts
    return (jnp.zeros((1, 1, 1), bool),
            jnp.zeros((1, 1, 1), model._dtype))


def continuum_runs_fanout(model, years, freqs_mat,
                          mesh: Optional[Mesh] = None):
    """All continuum runs of one channel count in one sharded program.

    ``years``: (n_runs,) epoch times [yr]; ``freqs_mat``: (n_runs, n_chan)
    channel frequencies [Hz].  Returns numpy ``(em, taus, fluxes)`` of
    shapes (n_runs, nx, nz) / (n_runs, n_chan, nx, nz) x2 — identical to
    per-run ``emission_measure`` / ``optical_depth_ff`` / ``flux_ff``
    (classes.py:2397-2423 per-run products).
    """
    f = model._ensure_fields()
    st = model._rt_static()
    t_0, reyn, csize, dist = model._rt_constants()
    chi2_of = _chi2_fn(model)

    m = run_mesh(mesh)
    n_dev = int(m.devices.size)
    times, freqs, n = _pad_runs(
        np.asarray(years, dtype=float) * cnsts.YEAR, freqs_mat, n_dev,
        model._dtype)

    # pass ONLY the consumed cubes: replicating the whole StaticFields +
    # RTStatic pytrees (incl. the tile compactions) would park ~7 unused
    # cubes on every device during the fan-out (review r3s6)
    red, ts = _burst_cubes(model, f)

    @partial(jax.shard_map, mesh=m,
             in_specs=(P('run'), P('run', None)) + (P(),) * 6,
             out_specs=(P('run'), P('run'), P('run')),
             check_vma=False)
    def fan(times_l, freqs_l, red, ts, em_base, a, tbar, any_in):
        def per_run(args):
            t, fr = args
            chi2 = chi2_of(red, ts, t)
            em = jnp.sum(em_base * chi2, axis=rt.LOS_AXIS)
            base_map = jnp.sum(a * chi2, axis=rt.LOS_AXIS)
            scale = rt.tau_ff_channel_scale(fr, t_0, reyn)
            taus = scale[:, None, None] * base_map[None]
            fluxes = rt.flux_ff_maps(fr, taus, tbar, any_in, csize,
                                     dist)
            return em, taus, fluxes
        return jax.lax.map(per_run, (times_l, freqs_l))

    em, taus, fluxes = jax.jit(fan)(times, freqs, red, ts, st.em_base,
                                    st.a, st.tbar, st.any_in)
    return (np.asarray(em)[:n], np.asarray(taus)[:n],
            np.asarray(fluxes)[:n])


def rrl_runs_fanout(model, line: str, years, freqs_mat,
                    mesh: Optional[Mesh] = None, contsub: bool = False,
                    b_pairs=None):
    """All epochs of one RRL line in one sharded program.

    Returns numpy ``(em, tau_l, fluxes)`` — per-run EM maps, line
    opacity maps and line(+continuum when ``contsub=False``) flux maps,
    matching ``optical_depth_rrl`` / ``flux_rrl`` (classes.py:2437-2450
    per-run products).

    ``b_pairs``: optional (n_runs, 2) per-run departure coefficients
    (b_n1, b_n2) — switches the per-device composition to the G&S
    non-LTE form (rt.intensity_rrl_maps_nonlte).  The coefficients are
    host-side scalars per run (JetModel.departure_coefficients at each
    run's epoch), sharded over the run axis alongside the times, so
    non-LTE runs fan out exactly like LTE ones (r4's fan-out was
    LTE-only).
    """
    f = model._ensure_fields()
    st = model._rt_static()
    t_0, reyn, csize, dist = model._rt_constants()
    coeffs = rt.RRLCoeffs(line)
    fscale = float(rt.flux_scale_jy(csize, dist))
    spec_r, spec_b = model._spec_r, model._spec_b
    has_bursts = model._has_bursts
    nonlte = b_pairs is not None

    m = run_mesh(mesh)
    n_dev = int(m.devices.size)
    times, freqs, n = _pad_runs(
        np.asarray(years, dtype=float) * cnsts.YEAR, freqs_mat, n_dev,
        model._dtype)
    if nonlte:
        bp = np.atleast_2d(np.asarray(b_pairs, dtype=float))
        if bp.shape != (n, 2):
            raise ValueError(f"b_pairs shape {bp.shape} != ({n}, 2)")
        pad = (-n) % n_dev
        if pad:
            bp = np.pad(bp, ((0, pad), (0, 0)), mode='edge')
        bp = jnp.asarray(bp, model._dtype)
    else:   # tiny placeholder keeps one traced program shape per mode
        bp = jnp.ones((times.shape[0], 2), model._dtype)

    red, ts = _burst_cubes(model, f)

    @partial(jax.shard_map, mesh=m,
             in_specs=(P('run'), P('run', None), P('run')) + (P(),) * 13,
             out_specs=(P('run'), P('run'), P('run')),
             check_vma=False)
    def fan(times_l, freqs_l, bp_l, red, ts, nd, xi, temp, vy, ff, area,
            inside, em_base, a, tbar, any_in):
        def per_run(args):
            t, fr, b12 = args
            if has_bursts:
                chi = ej.chi_field(red, t - ts, spec_r, spec_b)
                chi2 = chi * chi
                n_es = nd * chi * xi
            else:
                chi2 = jnp.asarray(1.0, times_l.dtype)
                n_es = nd * xi
            em = jnp.sum(em_base * chi2, axis=rt.LOS_AXIS)
            ds = rt.path_length_cm(ff, area, csize)
            tau_l = rt.tau_rrl_maps(coeffs, fr, temp, n_es, vy, ds,
                                    inside)
            scale = rt.tau_ff_channel_scale(fr, t_0, reyn)
            tau_c = scale[:, None, None] * \
                jnp.sum(a * chi2, axis=rt.LOS_AXIS)[None]
            if nonlte:
                # the tau product is the stimulated-corrected opacity —
                # the SAME ops-level definition the sequential path uses
                tau_out = rt.tau_rrl_maps_nonlte(fr, tbar, any_in,
                                                 tau_l, b12[0], b12[1])
                ints = rt.intensity_rrl_maps_nonlte(
                    fr, tbar, tau_c, tau_l, any_in, b12[0], b12[1])
            else:
                tau_out = tau_l
                ints = rt.intensity_rrl_maps(fr, tbar, tau_c, tau_l,
                                             any_in)
            fluxes = ints * fscale
            if not contsub:
                fluxes = fluxes + rt.flux_ff_maps(fr, tau_c, tbar,
                                                  any_in, csize, dist)
            return em, tau_out, fluxes
        return jax.lax.map(per_run, (times_l, freqs_l, bp_l))

    em, tau_l, fluxes = jax.jit(fan)(
        times, freqs, bp, red, ts, f.nd, f.xi, f.temp, f.vy, f.ff,
        f.area, f.inside, st.em_base, st.a, st.tbar, st.any_in)
    return (np.asarray(em)[:n], np.asarray(tau_l)[:n],
            np.asarray(fluxes)[:n])
