#!/usr/bin/env python3
"""Smoke run of the jet RT + synthetic-observation main path on one GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: run fan-out vs sequential

One card, in one process, in this order:

1. device   — JAX's devices and the card's name and power limit; fails
              unless JAX computes on a GPU.
2. kernels  — every hand-written kernel of the main path against the XLA
              form of the same product, at the flagship model's widths,
              both checked against a float64 reference; plus the
              compacted-tile XLA forms against the full-cube ones.
3. model    — the flagship model (the bundled example jet at 512^3,
              dtype='auto', i.e. float32) through JetModel's public
              products, against the same model at dtype='parity'
              (float64) or a float64 host oracle.
4. pipeline — Pipeline.execute on the bundled campaign
              (data/example-pipeline-params.py as shipped, plus one
              epoch of the H58a cube it defines) on the bundled model.

Every check prints its measured error beside its gate; any failure exits
non-zero.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import runpy
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
YEAR = 31536000.0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet

FLAGSHIP_N = 512
NCHAN = 16
RRL_WIDE_NCHAN = 1000
RRL_WIDE_BW = 1e8           # Hz: the bundled campaign's H58a band

# gates, relative to each map's maximum
CONTINUUM_TOL = 1e-5        # LOS sums of a few hundred f32 terms
EMERGENT_TOL = 1e-5
RRL_TOL = 1e-4              # Weideman-16's f32 floor plus LOS summation
DEGRID_TOL = 1e-5           # of total flux: f32 KB degrid vs f64 DFT
MULTI_RTOL = 1e-5           # fanned vs sequential products
# The CLEAN cube is not continuous in its input: a last-bit change in a
# dirty channel can move one peak pick or one stop decision.  The GPU's
# float32 scatter-adds (tile segment sums, gridding) do not add in a
# fixed order, so the sequential path need not reproduce its own CLEAN
# cube bit for bit.  Fanned against sequential is held to this multiple
# of the sequential path's repeat-to-repeat difference, and to
# MULTI_RTOL when the repeat is exact.
CLEAN_REPEAT_FACTOR = 10.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_query() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, or '' when the
    tool is absent."""
    try:
        res = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ''
    return res.stdout.strip()


def restrict_to_first_card() -> None:
    """Before JAX initialises: let this process see only the first card
    when more are visible (a JAX process reserves most of every card it
    opens)."""
    if os.environ.get('CUDA_VISIBLE_DEVICES'):
        return
    cards = [ln for ln in gpu_query().splitlines() if ln.strip()]
    if len(cards) > 1:
        os.environ['CUDA_VISIBLE_DEVICES'] = '0'
        log(f"# {len(cards)} cards visible: restricted to the first")


def check_device(n_cards: int = 1):
    """Phase 1.  Returns (jax, device); raises unless JAX computes on
    ``n_cards`` GPUs."""
    import jax
    devs = jax.devices()
    d = devs[0]
    log(f"devices: {devs}")
    log(f"device_kind: {d.device_kind}")
    query = gpu_query()
    log(f"nvidia-smi name, power.limit: {query or 'unavailable'}")
    if d.platform != 'gpu':
        raise RuntimeError(f"JAX computes on {d.platform!r}, not a GPU")
    if len(devs) != n_cards:
        raise RuntimeError(f"need {n_cards} GPU(s), JAX sees {len(devs)}")
    return jax, d


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #
def timed(fn, *args, n_rep: int = 5, min_rep_s: float = 0.02):
    """(result, seconds per call) of a jitted callable, warm.  Each of
    ``n_rep`` repetitions dispatches enough back-to-back calls to last
    about ``min_rep_s`` before it waits once, so a sub-millisecond program
    is not timed mostly by the dispatch and wait latency.  The seconds
    are ``{'median', 'min', 'max'}`` over the repetitions."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    inner = max(1, int(min_rep_s / max(time.perf_counter() - t0, 1e-6)))
    times = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / inner)
    return out, dict(median=float(np.median(times)), min=min(times),
                     max=max(times))


def fmt_ms(s: dict) -> str:
    """A ``timed`` reading in ms: median [min-max]."""
    return (f"{s['median'] * 1e3:.3f} ms [{s['min'] * 1e3:.3f}-"
            f"{s['max'] * 1e3:.3f}]")


def map_err(got, want) -> float:
    """Max over the leading (channel) axis of max|got - want| / max|want|
    per map; 2-D inputs count as one map."""
    return float(max(map_errs(got, want)))


def map_errs(got, want) -> list:
    """max|got - want| / max|want| of each map along the leading axis."""
    got = np.nan_to_num(np.asarray(got, np.float64))
    want = np.nan_to_num(np.asarray(want, np.float64))
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    if want.ndim == 2:
        got, want = got[None], want[None]
    errs = []
    for g, w in zip(got, want):
        peak = np.max(np.abs(w))
        if peak == 0.0:
            raise AssertionError("reference map is all zero")
        errs.append(float(np.max(np.abs(g - w)) / peak))
    return errs


def gate(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"  {name}: err {err:.3e} (gate {tol:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.3g}")


def model_params(n=None):
    """The bundled example model params, rescaled to an n^3 grid."""
    p = runpy.run_path(os.path.join(HERE, 'rajepy_tpu', 'data',
                                    'example-model-params.py'))['params']
    if n is not None:
        p['grid'].update(n_x=n, n_y=n, n_z=n, l_z=None)
    return p


def line_freqs(nchan: int, bw=None):
    """H58a channel frequencies: line-centred (+-1e-4 nu0) or over
    ``bw`` Hz."""
    from rajepy_tpu.ops import radtrans as rt
    nu0 = rt.RRLCoeffs('H58a').nu0
    half = bw / 2.0 if bw else nu0 * 1e-4
    return np.linspace(nu0 - half, nu0 + half, nchan)


def emergent_oracle(dbase, temp, inside, freqs, t_0, reyn):
    """float64 host oracle of JetModel.emergent_intensity_ff: the ordered
    transfer integral over every (x, z) column holding jet cells, from
    the per-cell opacity base (A chi^2), temperature and jet mask."""
    from rajepy_tpu import constants as cnsts
    from rajepy_tpu.ops import radtrans as rt
    dbase = np.asarray(dbase, np.float64)
    temp = np.asarray(temp, np.float64)
    inside = np.asarray(inside)
    ix, iz = np.nonzero(inside.any(axis=1))
    # observer at +y: flip the LOS so index 0 faces the observer
    d = dbase[ix, :, iz][:, ::-1]
    m = inside[ix, :, iz][:, ::-1]
    tt = np.where(m, temp[ix, :, iz][:, ::-1], 1.0)
    freqs = np.asarray(freqs, np.float64)
    import jax.numpy as jnp
    scale = np.asarray(rt.tau_ff_channel_scale(jnp.asarray(freqs), t_0,
                                               reyn), np.float64)
    out = np.zeros((len(freqs),) + inside[:, 0, :].shape)
    for c, nu in enumerate(freqs):
        dt = d * scale[c]
        src = np.where(m, 2.0 * cnsts.H_CGS * nu ** 3 / cnsts.C_CGS ** 2 /
                       np.expm1(cnsts.H_CGS * nu / (cnsts.K_CGS * tt)), 0.0)
        front = np.cumsum(dt, axis=1) - dt
        out[c, ix, iz] = np.sum(src * np.exp(-front) * -np.expm1(-dt),
                                axis=1)
    return out * 1e-7 * 1e4


def _chi2_f64(jm, f, t):
    """float64 squared burst factor from a model's fields."""
    import jax.numpy as jnp
    from rajepy_tpu.models import ejection as ej
    if not jm._has_bursts:
        return 1.0
    chi = ej.chi_field(f.red, t - jnp.asarray(f.ts, jnp.float64),
                       jm._spec_r, jm._spec_b)
    return chi * chi


# --------------------------------------------------------------------- #
# phase 2: kernels and tile forms at the flagship widths
# --------------------------------------------------------------------- #
def rrl_check(jm, freqs, interpret: bool = False, n_rep: int = 5):
    """The model's RRL opacity maps over its compacted tiles with the
    per-tile Voigt sums from the Triton kernel and from the XLA tile
    form, each timed, and both against float64 rt.tau_rrl_maps on the
    same cells."""
    import functools
    import jax
    import jax.numpy as jnp
    from rajepy_tpu.ops import radtrans as rt, tiles
    from rajepy_tpu.ops.rrl_tiles import rrl_tiles_pallas, rrl_tiles_xla
    coeffs = rt.RRLCoeffs('H58a')
    tl = jm._rrl_tiles()
    bursts, off = jm._burst_tuple(), jm._ts_pack_offset
    nx, nz = jm.nx, jm.nz
    t = jm.time     # a Python float, weakly typed, as the model passes it
    freqs = jnp.asarray(freqs, jnp.float64)

    def product(partials):
        # the model's own tile program; only the Voigt sums vary
        tau_maps = jm._tau_rrl_dispatch(coeffs, True, jm.csize,
                                        partials=partials)
        return jax.jit(lambda tl, t, freqs: tau_maps(None, tl, t, freqs))

    @jax.jit
    def reference(tl, t, freqs):
        temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, seg = tl
        n_act, bx, yc, bz = temp_t.shape
        f64 = jnp.float64
        n_es = ndxi_t.astype(f64) * tiles.burst_factor(
            tss_t.astype(f64), t, bursts, off)
        cols = [a.reshape(n_act * bx, yc, bz) for a in
                (temp_t.astype(f64), n_es, vy_t.astype(f64),
                 ds_t.astype(f64), inside_t)]
        maps = rt.tau_rrl_maps(coeffs, freqs, cols[0], cols[1], cols[2],
                               cols[3], cols[4])
        parts = maps.reshape(-1, n_act, bx, bz).transpose(1, 0, 2, 3)
        return tiles.segment_tile_maps(parts, seg, nx, nz)

    kern = functools.partial(rrl_tiles_pallas, interpret=interpret)
    got_k, t_k = timed(product(kern), tl, t, freqs, n_rep=n_rep)
    got_x, t_x = timed(product(rrl_tiles_xla), tl, t, freqs, n_rep=n_rep)
    want = reference(tl, t, freqs)
    return dict(kernel_s=t_k, xla_s=t_x, kernel_err=map_err(got_k, want),
                xla_err=map_err(got_x, want))


def epoch_check(jm, n_rep: int = 15):
    """Both collapsed epoch maps (opacity base, EM base) through the
    compacted-tile XLA form and the full-cube XLA form, each timed, and
    both against a float64 full-cube evaluation of the same inputs."""
    import jax
    import jax.numpy as jnp
    from rajepy_tpu.ops import radtrans as rt
    f = jm._ensure_fields()
    st = jm._rt_static()
    t = jm.time     # a Python float, weakly typed, as the model passes it
    both = jax.jit(lambda f, st, t: jm._epoch_base_maps_both(f, st, t))
    got_t, t_tiles = timed(both, f, st, t, n_rep=n_rep)
    got_f, t_full = timed(both, f, st._replace(seg=None), t, n_rep=n_rep)

    @jax.jit
    def reference(f, st, t):
        chi2 = _chi2_f64(jm, f, t)
        return tuple(jnp.sum(b.astype(jnp.float64) * chi2, axis=rt.LOS_AXIS)
                     for b in (st.a, st.em_base))

    want = reference(f, st, t)
    stream_bytes = 3 * st.a_t.size * st.a_t.dtype.itemsize
    return dict(tiles_s=t_tiles, full_s=t_full,
                tiles_err=max(map_err(g, w) for g, w in zip(got_t, want)),
                full_err=max(map_err(g, w) for g, w in zip(got_f, want)),
                stream_bytes=stream_bytes,
                hbm_share={k: stream_bytes / s / HBM_BYTES_PER_S
                           for k, s in t_tiles.items()})


def emergent_check(jm, freqs, n_rep: int = 5):
    """The model's emergent scan program over the compacted tiles and
    over the full cube, each timed, both against the float64 host oracle
    of the same inputs."""
    import jax
    import jax.numpy as jnp
    freqs = np.asarray(freqs, np.float64)
    fr = jnp.asarray(freqs, jm._dtype)
    fn, args = jm._emergent_program(True)
    got_t, t_tiles = timed(fn, *args, jm.time, fr, n_rep=n_rep)
    fn, args = jm._emergent_program(False)
    got_f, t_full = timed(fn, *args, jm.time, fr, n_rep=n_rep)
    f = jm._ensure_fields()
    st = jm._rt_static()
    dbase = jax.jit(lambda a, f, t: a.astype(jnp.float64) *
                    _chi2_f64(jm, f, t))(st.a, f, jm.time)
    t_0, reyn, _, _ = jm._rt_constants()
    want = emergent_oracle(dbase, f.temp, f.inside, freqs, t_0, reyn)
    return dict(tiles_s=t_tiles, full_s=t_full,
                tiles_err=map_err(got_t, want), full_err=map_err(got_f,
                                                                 want))


def degrid_check(image, cell_rad: float, n_vis: int = 1024,
                 max_baseline_m: float = 36.4e3, freq: float = 6e9):
    """f32 Kaiser-Bessel degridding of ``image`` against the float64
    DFT sampler at random uv points out to the longest baseline (VLA-A
    by default); returns the max |dV| over the total flux."""
    import jax.numpy as jnp
    from rajepy_tpu.synthobs import sampler
    rng = np.random.default_rng(3)
    lam = 299792458.0 / freq
    r = max_baseline_m * np.sqrt(rng.random(n_vis)) / lam
    phi = 2.0 * np.pi * rng.random(n_vis)
    u, v = r * np.cos(phi), r * np.sin(phi)
    img64 = np.asarray(image, np.float64)
    kb = np.asarray(sampler.sample_vis(jnp.asarray(img64, jnp.float32),
                                       cell_rad, u, v))
    exact = np.concatenate([
        np.asarray(sampler.sample_vis_dft(jnp.asarray(img64), cell_rad,
                                          u[s:s + 128], v[s:s + 128]))
        for s in range(0, n_vis, 128)])
    return float(np.max(np.abs(kb - exact)) / np.sum(img64))


def phase_kernels(jm):
    log("phase kernels: flagship "
        f"{jm.nx}x{jm.ny}x{jm.nz} {np.dtype(jm._dtype).name}, "
        f"{jm._active_tile_ids()[0].size} jet-occupied tiles")
    for label, freqs in ((f"{NCHAN} line-centred channels",
                          line_freqs(NCHAN)),
                         (f"{RRL_WIDE_NCHAN} channels over "
                          f"{RRL_WIDE_BW:.0e} Hz",
                          line_freqs(RRL_WIDE_NCHAN, RRL_WIDE_BW))):
        r = rrl_check(jm, freqs)
        log(f"  rrl_tiles, {label}: triton kernel {fmt_ms(r['kernel_s'])},"
            f" xla tile form {fmt_ms(r['xla_s'])} (kernel/xla medians "
            f"{r['kernel_s']['median'] / r['xla_s']['median']:.3f})")
        gate(f"rrl triton kernel ({label}) vs f64", r['kernel_err'],
             RRL_TOL)
        gate(f"rrl xla tile form ({label}) vs f64", r['xla_err'], RRL_TOL)
    e = epoch_check(jm)
    share = e['hbm_share']
    log(f"  epoch maps (a + em): xla tile form {fmt_ms(e['tiles_s'])}, "
        f"xla full cube {fmt_ms(e['full_s'])}; tile streams "
        f"{e['stream_bytes'] / 1e6:.1f} MB -> {share['median']:.3f} "
        f"[{share['max']:.3f}-{share['min']:.3f}] of 3.35 TB/s")
    gate("epoch maps, tile form vs f64", e['tiles_err'], CONTINUUM_TOL)
    gate("epoch maps, full cube vs f64", e['full_err'], CONTINUUM_TOL)
    freqs = np.geomspace(3e8, 3e11, NCHAN)
    m = emergent_check(jm, freqs)
    log(f"  emergent scan, {NCHAN} channels: xla tile form "
        f"{fmt_ms(m['tiles_s'])}, xla full cube {fmt_ms(m['full_s'])}")
    gate("emergent, tile form vs f64 oracle", m['tiles_err'], EMERGENT_TOL)
    gate("emergent, full cube vs f64 oracle", m['full_err'], EMERGENT_TOL)
    from rajepy_tpu import constants as cnsts
    cell_rad = float(np.arctan(jm.csize * cnsts.AU / (
        jm.params['target']['dist'] * cnsts.PARSEC)))
    err = degrid_check(jm.flux_ff(6e9), cell_rad)
    gate("f32 KB degrid vs f64 DFT (of total flux)", err, DEGRID_TOL)


# --------------------------------------------------------------------- #
# phase 3: the flagship model's public products vs float64
# --------------------------------------------------------------------- #
def phase_model(jm32, jm64):
    import jax
    freqs = np.geomspace(3e8, 3e11, NCHAN)
    for k, yr in enumerate((0.5, 1.0, 2.0, 3.0)):
        jm32.time = jm64.time = yr * YEAR
        t0 = time.perf_counter()
        got = jm32.continuum_rt_products(freqs)
        dt = time.perf_counter() - t0
        want = jm64.continuum_rt_products(freqs)
        log(f"  continuum_rt_products epoch {yr} yr: {dt * 1e3:.1f} ms "
            "(incl. host pull" + (", compile)" if k == 0 else ")"))
        for name, g, w in zip(('em', 'tau', 'flux'), got, want):
            gate(f"continuum {name} @ {yr} yr vs f64 model", map_err(g, w),
                 CONTINUUM_TOL)
    jm32.time = jm64.time = 2.0 * YEAR
    rf = line_freqs(NCHAN)
    t0 = time.perf_counter()
    em, tau_l, flux = jm32.rrl_rt_products('H58a', rf)
    log(f"  rrl_rt_products H58a {NCHAN} ch: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (incl. compile)")
    em6, tau6, flux6 = jm64.rrl_rt_products('H58a', rf)
    gate("rrl tau_L maps vs f64 rt.tau_rrl_maps", map_err(tau_l, tau6),
         RRL_TOL)
    gate("rrl line+continuum flux vs f64 model", map_err(flux, flux6),
         RRL_TOL)
    t0 = time.perf_counter()
    ints = jm32.emergent_intensity_ff(freqs)
    log(f"  emergent_intensity_ff {NCHAN} ch: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    f = jm64._ensure_fields()
    dbase = jax.jit(lambda a, f, t: a * _chi2_f64(jm64, f, t))(
        jm64._rt_static().a, f, jm64.time)
    t_0, reyn, _, _ = jm64._rt_constants()
    want = emergent_oracle(dbase, f.temp, f.inside, freqs, t_0, reyn)
    gate("emergent vs f64 host oracle (f64 model inputs)",
         map_err(ints, want), EMERGENT_TOL)


# --------------------------------------------------------------------- #
# phase 4: the bundled campaign through Pipeline.execute
# --------------------------------------------------------------------- #
def campaign_params(model_dcy: str, save_dirty: bool = False):
    """data/example-pipeline-params.py as shipped, plus one epoch (the
    first continuum epoch) of the H58a cube it defines.  ``save_dirty``
    also writes each run's dirty image (an extra output only)."""
    p = runpy.run_path(os.path.join(HERE, 'rajepy_tpu', 'data',
                                    'example-pipeline-params.py'))['params']
    p = copy.deepcopy(p)
    p['dcys']['model_dcy'] = model_dcy
    p['rrls']['times'] = p['continuum']['times'][:1].copy()
    if save_dirty:
        p['synthobs'] = {'save_products': ('dirty',)}
    return p


def run_campaign(model_dcy: str, device_fanout=None, save_dirty=False):
    """Execute the bundled campaign cold; returns (pipeline, wall s,
    stage times)."""
    from rajepy_tpu import JetModel, Pipeline
    from rajepy_tpu.utils import profiling
    pline = Pipeline(JetModel(model_params()),
                     campaign_params(model_dcy, save_dirty))
    profiling.collect_stage_times(True)
    try:
        t0 = time.perf_counter()
        pline.execute(simobserve=True, verbose=False, resume=False,
                      clobber=True, plot=False, device_fanout=device_fanout)
        wall = time.perf_counter() - t0
        stages = profiling.stage_times()
    finally:
        profiling.collect_stage_times(False)
    return pline, wall, stages


def fits_products(run):
    """Every FITS product a run wrote: {name: path}."""
    out = {a: getattr(run, a) for a in ('fits_em', 'fits_tau', 'fits_flux')}
    out.update({k: v for k, v in run.products.items()
                if isinstance(v, str) and v.endswith('.fits')})
    return out


def check_campaign(pline) -> None:
    from rajepy_tpu.io.fits import read_fits
    n_cont = sum(r.obs_type == 'continuum' for r in pline.runs)
    log(f"  {len(pline.runs)} runs ({n_cont} continuum, "
        f"{len(pline.runs) - n_cont} RRL)")
    for i, run in enumerate(pline.runs):
        if not run.completed:
            raise AssertionError(f"run {i + 1} did not complete")
        for name, path in fits_products(run).items():
            data = read_fits(path)[0]
            if not np.isfinite(data).all():
                raise AssertionError(f"run {i + 1} {name}: non-finite "
                                     f"values in {path}")
        if run.obs_type == 'continuum':
            fit = run.results.get('imfit')
            if fit is None:
                raise AssertionError(f"run {i + 1}: imfit did not converge")
            log(f"  run {i + 1} ({run.year:.0f} yr, {run.freq / 1e9:.0f} "
                f"GHz): imfit converged, {len(fits_products(run))} FITS "
                "products finite")
        else:
            log(f"  run {i + 1} ({run.line}, "
                f"{len(np.atleast_1d(run.chan_freqs))} ch): "
                f"{len(fits_products(run))} FITS products finite")


def phase_pipeline() -> None:
    dcy = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        pline, wall, stages = run_campaign(os.path.join(dcy, 'run'))
        log(f"  Pipeline.execute cold wall: {wall:.1f} s")
        for name, s in sorted(stages.items(), key=lambda kv: -kv[1]):
            log(f"    stage {name}: {s:.3f} s")
        check_campaign(pline)
    finally:
        shutil.rmtree(dcy, ignore_errors=True)


# --------------------------------------------------------------------- #
# four cards: run fan-out vs sequential
# --------------------------------------------------------------------- #
def compare_campaigns(a, b) -> dict:
    """Per product, the map errors of campaign ``a`` against ``b`` over
    all their runs' maps: every run's RT products and noisy
    visibilities (each channel one map), and the RRL runs' dirty and
    CLEAN cubes."""
    from rajepy_tpu.io.fits import read_fits
    errs = {}
    for ra, rb in zip(a.runs, b.runs):
        key = 'vis' if ra.obs_type == 'continuum' else 'rrl vis'
        vis = []
        for r in (ra, rb):
            with np.load(r.products['ms_noisy']) as f:
                vis.append(np.stack([f['vis_re'], f['vis_im']], axis=1))
        errs.setdefault(key, []).extend(map_errs(*vis))
        names = ['fits_em', 'fits_tau', 'fits_flux']
        if ra.obs_type != 'continuum':
            names += ['dirty', 'clean_image']
        for name in names:
            x = read_fits(fits_products(ra)[name])[0]
            y = read_fits(fits_products(rb)[name])[0]
            key = name if ra.obs_type == 'continuum' else f"rrl {name}"
            errs.setdefault(key, []).extend(map_errs(
                x.reshape(-1, *x.shape[-2:]), y.reshape(-1, *y.shape[-2:])))
    return errs


def multi_gates(fanned: dict, repeat: dict) -> None:
    """Gate fanned-vs-sequential product errors (``compare_campaigns``):
    MULTI_RTOL for every product but the CLEAN cube, which is held to
    CLEAN_REPEAT_FACTOR times the sequential repeat's own difference
    (``repeat``)."""
    worst = {k: max(v) for k, v in fanned.items()}
    spread = {k: max(v) for k, v in repeat.items()}
    for key in fanned:
        above = [sum(e > MULTI_RTOL for e in d[key])
                 for d in (fanned, repeat)]
        log(f"  {key}: fanned vs sequential {worst[key]:.3e} "
            f"({above[0]} of {len(fanned[key])} maps above "
            f"{MULTI_RTOL:.0e}); sequential repeat {spread[key]:.3e} "
            f"({above[1]} above)")
    for key, err in worst.items():
        tol = MULTI_RTOL
        if key == 'rrl clean_image':
            tol = max(tol, CLEAN_REPEAT_FACTOR * spread[key])
        gate(f"fanned vs sequential {key}", err, tol)


def phase_multi(jax) -> None:
    """The bundled campaign with the run fan-out (the default on more
    than one device), then twice sequentially; the products are compared
    one by one (compare_campaigns, multi_gates)."""
    dcy = tempfile.mkdtemp(prefix='chip_smoke_multi_')
    try:
        fan, wall_f, _ = run_campaign(os.path.join(dcy, 'fan'),
                                      save_dirty=True)
        log(f"  fanned campaign: {wall_f:.1f} s")
        if not any('Fanned' in str(e) for e in fan.log.entries.values()):
            raise AssertionError("the continuum runs did not fan out")
        for d in jax.devices():
            stats = d.memory_stats() or {}
            log(f"  {d}: peak_bytes_in_use "
                f"{stats.get('peak_bytes_in_use', 0) / 1e9:.2f} GB")
        seq = []
        for k in range(2):
            p, wall_s, _ = run_campaign(os.path.join(dcy, f'seq{k}'),
                                        device_fanout=False,
                                        save_dirty=True)
            log(f"  sequential campaign {k + 1}: {wall_s:.1f} s")
            seq.append(p)
        for p in (fan, *seq):
            check_campaign(p)
        multi_gates(compare_campaigns(fan, seq[0]),
                    compare_campaigns(seq[1], seq[0]))
    finally:
        shutil.rmtree(dcy, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--multi', action='store_true',
                    help='four cards: the run fan-out against the '
                         'sequential path')
    args = ap.parse_args(argv)
    if not args.multi:
        restrict_to_first_card()
    t_start = time.perf_counter()
    try:
        log("phase device")
        jax, dev = check_device(4 if args.multi else 1)
        import rajepy_tpu  # noqa: F401 — x64, compile cache
        from rajepy_tpu import JetModel
        if args.multi:
            t0 = time.perf_counter()
            log("phase multi")
            phase_multi(jax)
            log(f"phase multi: {time.perf_counter() - t0:.1f} s")
        else:
            t0 = time.perf_counter()
            jm32 = JetModel(model_params(FLAGSHIP_N))
            if np.dtype(jm32._dtype) != np.float32 or not jm32._tiled():
                raise AssertionError("dtype='auto' must give the float32 "
                                     "compacted-tile path on a GPU")
            jm32.time = 2.0 * YEAR
            f = jax.block_until_ready(jm32._ensure_fields())
            log(f"grid fill {FLAGSHIP_N}^3 f32 (incl. compile): "
                f"{time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            phase_kernels(jm32)
            log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("phase model")
            jm64 = JetModel(model_params(FLAGSHIP_N), dtype='parity')
            phase_model(jm32, jm64)
            del f, jm32, jm64
            log(f"phase model: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("phase pipeline")
            phase_pipeline()
            log(f"phase pipeline: {time.perf_counter() - t0:.1f} s")
    except Exception as exc:  # report, then fail without a result line
        import traceback
        traceback.print_exc()
        log(f"FAILED: {type(exc).__name__}: {exc}")
        return 1
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
