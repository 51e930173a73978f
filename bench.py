#!/usr/bin/env python3
"""Headline benchmark: the REAL model chain at 512^3 on the default device.

Headline metric (the JSON line): per-epoch radiative-transfer throughput of
the flagship model — burst factor -> electron density -> free-free opacity
(van Hoof gaunt branch) -> flux maps, 16 channels, on the bundled example
jet scaled to 512^3 — i.e. the path a user of the reference actually runs
(classes.py:1353-1541 driven by Pipeline.execute), not synthetic fields.

Secondary numbers (stderr '#' lines): grid-fill wall time, the H58a RRL
cube, and the multi-channel emergent ordered scan.

Runs on a GPU only.  Before any timing, ``pallas_check`` validates the
hand-written Pallas kernel (the Triton-route RRL tile kernel) against its
XLA form and a float64 reference ON THE DEVICE at small shapes
(interpret-mode CI cannot catch lowering gaps or f32 constant-folding
underflows); a kernel regression fails the benchmark.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""
import json
import os
import runpy
import sys
import time

import numpy as np

YEAR = 31536000.0


def log(msg):
    print(f"# {msg}", file=sys.stderr)


# --------------------------------------------------------------------------- #
# Reference-style numpy baseline (the algorithm being replaced)
# --------------------------------------------------------------------------- #
def numpy_baseline_cells_per_sec(n=128, nchan=4):
    """Reference continuum RT (per-channel full-grid float64 elementwise
    algebra + nansum, classes.py:1384-1400 + 1449-1541), cells/sec."""
    rng = np.random.default_rng(0)
    shape = (n, n, n)
    inside = rng.random(shape) < 0.1
    temp = np.where(inside, 1e4, np.nan)
    n_es = np.where(inside, 1e7 * rng.random(shape), np.nan)
    ds = np.where(inside, 7.5e12, np.nan)
    freqs = np.linspace(1e9, 5e10, nchan)
    csize_arctan2 = np.arctan(0.5 * 1.496e11 / (120 * 3.086e16)) ** 2

    t0 = time.perf_counter()
    for nu in freqs:
        gff = 11.95 * temp ** 0.15 * nu ** -0.1
        tau = 0.018 * temp ** -1.5 * nu ** -2.0 * n_es ** 2 * ds * gff
        tau_map = np.nansum(tau, axis=1)
        tbar = np.nanmean(temp, axis=1)
        t_b = tbar * (1.0 - np.exp(-tau_map))
        i_nu = 2.0 * nu ** 2 * 1.380649e-23 * t_b / 299792458.0 ** 2
        _ = i_nu * csize_arctan2 / 1e-26
    dt = time.perf_counter() - t0
    return n ** 3 * nchan / dt


def _sync(x):
    """Device completion barrier for timing."""
    import jax
    return jax.block_until_ready(x)


# --------------------------------------------------------------------------- #
# On-device Pallas kernel validation (must pass before any timing)
# --------------------------------------------------------------------------- #
def pallas_check():
    """The Triton RRL tile kernel vs its XLA form and float64
    rt.tau_rrl_maps, compiled for the device, on a sparse jet that takes
    the kernel's all-far, all-near and mixed branches."""
    import jax.numpy as jnp
    from rajepy_tpu.ops import radtrans as rt, tiles
    from rajepy_tpu.ops.rrl_tiles import rrl_tiles_pallas, rrl_tiles_xla
    rng = np.random.default_rng(0)
    nx, ny, nz = 16, 48, 128
    inside = rng.random((nx, ny, nz)) < 0.3
    inside[nx // 2:] = False  # fully-empty tiles are dropped
    temp = np.where(inside, 1e4 * (0.5 + rng.random((nx, ny, nz))), 1.0)
    n_es = np.where(inside, 1e7 * rng.random((nx, ny, nz)), 0.0)
    vy = np.where(inside, 2e1 * (rng.random((nx, ny, nz)) - .5), 0.0)
    ds = np.where(inside, 7.5e12, 0.0)
    coeffs = rt.RRLCoeffs('H58a')
    freqs = coeffs.nu0 + np.concatenate([np.linspace(-2e6, 2e6, 13),
                                         [1e7, 1e8, 1e9]])
    tdims = dict(block_x=8, block_z=128, y_chunk=16)
    ids, seg = tiles.active_tiles(jnp.asarray(inside), **tdims)
    ids_d = jnp.asarray(ids)

    def g(a, fill=0.0):
        return tiles.gather_tiles(jnp.asarray(a), ids_d, fill=fill, **tdims)

    f32 = np.float32
    fac = rt.tau_rrl_tile_factors(
        coeffs, freqs, g(temp.astype(f32), 1.0), g(n_es.astype(f32)),
        g(vy.astype(f32)), g(ds.astype(f32)), g(inside, False))
    want = np.asarray(rt.tau_rrl_maps(coeffs, jnp.asarray(freqs),
                                      *map(jnp.asarray,
                                           (temp, n_es, vy, ds, inside))))
    checks = {}
    for name, fn in (('rrl_tiles_pallas', rrl_tiles_pallas),
                     ('rrl_tiles_xla', rrl_tiles_xla)):
        got = np.asarray(tiles.segment_tile_maps(
            fn(*fac, nu0=coeffs.nu0), jnp.asarray(seg), nx, nz))
        err = max(np.max(np.abs(g_ - w)) / np.max(np.abs(w))
                  for g_, w in zip(got, want))
        checks[name] = err
        assert err < 1e-5, f"{name} vs f64: rel err {err:.2e}"
    log("pallas_check: ok " +
        " ".join(f"{k}={v:.1e}" for k, v in checks.items()))


# --------------------------------------------------------------------------- #
# The flagship model
# --------------------------------------------------------------------------- #
def flagship_model(n):
    import jax.numpy as jnp
    from rajepy_tpu import JetModel
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'rajepy_tpu', 'data', 'example-model-params.py')
    params = runpy.run_path(path)['params']
    params['grid'].update(n_x=n, n_y=n, n_z=n, l_z=None)
    # No dtype argument: the headline measures the out-of-the-box default
    # (dtype='auto' resolves to the float32 compacted-tile path on a GPU).
    jm = JetModel(params)
    assert jm._dtype == jnp.float32 and jm._tiled(), \
        "dtype='auto' must pick the f32 compacted-tile path on a GPU"
    return jm


def model_path_bench(jm, nchan=16, n_rep=400):
    """Per-epoch model chain through the model's own flux kernel: burst
    factor -> opacity (van Hoof branch) -> flux maps, all channels,
    amortised over n_rep epochs in one device program (the per-dispatch
    launch and host sync would otherwise dominate sub-millisecond
    epochs)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    f = jm._ensure_fields()
    flux_kernel = jm._continuum_kernel('flux')  # the public path
    inner, statics = flux_kernel.inner, flux_kernel.statics
    freqs = jnp.geomspace(3e8, 3e11, nchan, dtype=jm._dtype)
    dt_epoch = jnp.asarray(0.1 * YEAR, jm._dtype)

    @jax.jit
    def bench_loop(f, st, freqs, t_start):
        def body(i, acc):
            t = t_start + i.astype(jm._dtype) * dt_epoch
            return acc + jnp.sum(inner(f, st, t, freqs))
        return lax.fori_loop(0, n_rep, body, jnp.asarray(0.0, jm._dtype))

    t_start = jnp.asarray(2.0 * YEAR, jm._dtype)
    _sync(bench_loop(f, *statics, freqs, t_start))  # compile + warm-up
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        _sync(bench_loop(f, *statics, freqs, t_start))
        dt = (time.perf_counter() - t0) / n_rep
        best = dt if best is None else min(best, dt)
    dt = best
    n_cells = jm.nx * jm.ny * jm.nz
    # effective bandwidth of the whole model chain against the epoch
    # pass's 2 tile streams — a LOWER bound on the epoch pass's own rate
    # (dt also covers the tau/flux map stage)
    st = statics[0]
    n_act, bx, yc, bz = st.a_t.shape
    gbs = n_act * bx * yc * bz * 4 * 2 / dt / 1e9
    log(f"model_chain_bandwidth_lower_bound={gbs:.0f}GB/s "
        f"({n_act} tiles x {bx}x{yc}x{bz} x 2 streams over the FULL "
        "chain time)")
    return n_cells * nchan / dt, dt


def run_products_bench(jm, nchan=16, n_rep=100):
    """The per-run continuum RT stage: the fused one-pass
    continuum_rt_products kernel vs the three separate product passes
    (em + tau + flux) Pipeline.execute used to make."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    f = jm._ensure_fields()
    st = jm._rt_static()
    freqs = jnp.geomspace(3e8, 3e11, nchan, dtype=jm._dtype)
    dt_epoch = jnp.asarray(0.1 * YEAR, jm._dtype)
    jm.continuum_rt_products(freqs)  # trace/cache
    fused_inner = jm._jit_cache[('ff_products', jm._compact_flag(st))]
    em_kernel = jm._jitted(('em', jm._compact_flag(st)), lambda: (
        lambda f, st, t: jm._epoch_base_map('em', f, st, t)))
    tau_call = jm._continuum_kernel('tau')
    flux_call = jm._continuum_kernel('flux')

    @jax.jit
    def loop_fused(f, st, freqs, t_start):
        def body(i, acc):
            t = t_start + i.astype(jm._dtype) * dt_epoch
            em, taus, fluxes = fused_inner(f, st, t, freqs)
            return acc + jnp.sum(em) + jnp.sum(fluxes) + jnp.sum(taus)
        return lax.fori_loop(0, n_rep, body, jnp.asarray(0.0, jm._dtype))

    @jax.jit
    def loop_separate(f, st, freqs, t_start):
        def body(i, acc):
            t = t_start + i.astype(jm._dtype) * dt_epoch
            em = em_kernel(f, st, t)
            taus = tau_call.inner(f, st, t, freqs)
            fluxes = flux_call.inner(f, st, t, freqs)
            return acc + jnp.sum(em) + jnp.sum(fluxes) + jnp.sum(taus)
        return lax.fori_loop(0, n_rep, body, jnp.asarray(0.0, jm._dtype))

    t_start = jnp.asarray(2.0 * YEAR, jm._dtype)
    out = {}
    for name, loop in (('fused', loop_fused), ('separate', loop_separate)):
        _sync(loop(f, st, freqs, t_start))
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            _sync(loop(f, st, freqs, t_start))
            dt = (time.perf_counter() - t0) / n_rep
            best = dt if best is None else min(best, dt)
        out[name] = best
    return out


def _timed(fn, n_rep=5):
    """Simple average over n_rep warm calls after one compiling call."""
    _sync(fn())
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn()
    _sync(out)
    return (time.perf_counter() - t0) / n_rep


def rrl_cube_bench(jm, nchan=16, bw=None):
    """H58a RRL optical-depth cube through the model's own kernel.
    ``bw`` [Hz] sets the full bandwidth (default: the narrow +-0.01%
    line-core window; pass 1e8 for the bundled pipeline's band)."""
    import jax.numpy as jnp
    from rajepy_tpu.ops import radtrans as rt
    coeffs = rt.RRLCoeffs('H58a')
    f = jm._ensure_fields()
    half = (bw / 2.0) if bw else coeffs.nu0 * 1e-4
    freqs = jnp.linspace(coeffs.nu0 - half, coeffs.nu0 + half, nchan,
                         dtype=jm._dtype)
    kern = jm._rrl_kernel('H58a', 'tau')
    dt = _timed(lambda: kern(f, jm.time, freqs, 1.0, 1.0))
    return jm.nx * jm.ny * jm.nz * nchan / dt, dt


def emergent_bench(jm, nchan=16):
    """Multi-channel emergent ordered scan over the compacted tiles
    (beyond-reference mode)."""
    import jax.numpy as jnp
    freqs = jnp.geomspace(3e8, 3e11, nchan, dtype=jm._dtype)
    fn, args = jm._emergent_program(jm._tiled())
    dt = _timed(lambda: fn(*args, jm.time, freqs))
    return jm.nx * jm.ny * jm.nz * nchan / dt, dt


def pipeline_bench(n=256, freqs=(1.5e9, 6e9, 2.2e10, 4.3e10)):
    """Warm end-to-end wall seconds for the fixed 4-run 256^3 continuum
    pipeline (RT + FITS + synthobs + imfit): execute once cold (includes every distinct jit compile),
    then once more warm on the same Pipeline.

    Returns (cold_s, warm_s, device_s, transfer_s): the warm run's
    KernelTimer stage totals split into device-compute seconds vs
    device->host-transfer + disk-IO seconds
    (utils.profiling.split_stage_times).
    """
    import copy
    import shutil
    import tempfile

    import rajepy_tpu
    from rajepy_tpu import JetModel, Pipeline

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'rajepy_tpu', 'data', 'example-model-params.py')
    params = runpy.run_path(path)['params']
    params = copy.deepcopy(params)
    params['grid'].update(n_x=n, n_y=n, n_z=n, l_z=None)
    td = tempfile.mkdtemp(prefix='bench_pipe_')
    freqs = np.asarray(freqs, float)
    nrun = freqs.size
    pparams = {
        'min_el': 20.,
        'dcys': {'model_dcy': os.path.join(td, 'run')},
        'continuum': {'times': np.array([0.]), 'freqs': freqs,
                      't_obs': np.full(nrun, 3600, dtype=int),
                      'tscps': np.array([('VLA', 'A')] * nrun),
                      't_ints': np.full(nrun, 60, dtype=int),
                      'bws': np.full(nrun, 1e8),
                      'chanws': np.full(nrun, 1e8)},
        'rrls': {'times': np.array([]), 'lines': np.array([]),
                 't_obs': np.array([]), 'tscps': np.array([]),
                 't_ints': np.array([]), 'bws': np.array([]),
                 'chanws': np.array([])},
    }
    try:
        # Pipeline construction logs its run table through Log.add_entry
        # (stdout, the reference's convention) — bench's stdout contract
        # is ONE JSON line, so route the table to stderr with the other
        # '#' diagnostics
        import contextlib
        with contextlib.redirect_stdout(sys.stderr):
            pline = Pipeline(JetModel(copy.deepcopy(params)), pparams)
            t0 = time.perf_counter()
            pline.execute(simobserve=True, verbose=False, resume=False,
                          clobber=True, plot=False)
            cold = time.perf_counter() - t0
            from rajepy_tpu.utils import profiling
            profiling.collect_stage_times(True)
            t0 = time.perf_counter()
            pline.execute(simobserve=True, verbose=False, resume=False,
                          clobber=True, plot=False)
            warm = time.perf_counter() - t0
        device_s, transfer_s, other_s = profiling.split_stage_times()
        log("pipeline stage split (warm): device compute "
            f"{device_s:.1f}s, transfer+IO {transfer_s:.1f}s, "
            f"untimed/other {warm - device_s - transfer_s:.1f}s")
    finally:
        # inside the finally: a failed warm run must not leave the
        # process-global registry collecting for later bench stages
        from rajepy_tpu.utils import profiling
        profiling.collect_stage_times(False)
        shutil.rmtree(td, ignore_errors=True)
    return cold, warm, device_s, transfer_s


def main():
    import rajepy_tpu  # noqa: F401 — x64 config etc.
    import jax
    import chip_smoke

    dev = jax.devices()[0]
    log(f"device={dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"nvidia-smi name, power.limit: {chip_smoke.gpu_query()}")
    if dev.platform != 'gpu':
        raise SystemExit(f"bench.py measures a GPU; JAX computes on "
                         f"{dev.platform!r}")
    pallas_check()

    n = 512
    nchan = 16
    jm = flagship_model(n)
    t0 = time.perf_counter()
    _sync(jm._ensure_fields())
    fill_dt = time.perf_counter() - t0
    ours, dt = model_path_bench(jm, nchan=nchan)
    log(f"grid_fill_{n}cube={fill_dt:.2f}s (once per model, cached)")
    log(f"model_path wall_per_epoch_{nchan}chan={dt * 1e3:.2f}ms")

    rp = run_products_bench(jm, nchan=nchan)
    log(f"run_rt_stage_fused={rp['fused'] * 1e3:.2f}ms "
        f"separate={rp['separate'] * 1e3:.2f}ms "
        f"(em+tau+flux per run; {rp['separate'] / rp['fused']:.2f}x "
        "from the one-pass dual-base epoch pass)")

    rrl_rate, rrl_dt = rrl_cube_bench(jm, nchan=nchan)
    log(f"rrl_cube_H58a_{n}cube_{nchan}chan={rrl_dt * 1e3:.1f}ms "
        f"({rrl_rate:.3e} cells/s)")
    em_rate, em_dt = emergent_bench(jm, nchan=nchan)
    log(f"emergent_scan_{n}cube_{nchan}chan={em_dt * 1e3:.1f}ms "
        f"({em_rate:.3e} cells/s)")
    # the bundled pipeline's H58a band: 1e8 Hz in 1e5 Hz channels
    wide_rate, wide_dt = rrl_cube_bench(jm, nchan=1000, bw=1e8)
    log(f"rrl_cube_H58a_{n}cube_1000chan={wide_dt:.2f}s "
        f"({wide_rate:.3e} cells/s)")

    # pipeline-level metric: warm wall seconds of the fixed 4-run 256^3
    # continuum pipeline
    pipe_cold, pipe_warm, pipe_device, pipe_transfer = pipeline_bench()
    log(f"pipeline_4run_256_warm={pipe_warm:.1f}s (cold incl. "
        f"compiles {pipe_cold:.1f}s; device {pipe_device:.1f}s, "
        f"transfer+IO {pipe_transfer:.1f}s)")

    # best-of-3: the bench host's CPU is shared, single runs jitter 10x
    baseline = max(numpy_baseline_cells_per_sec() for _ in range(3))
    log(f"numpy_baseline={baseline:.3e} cells/s (best of 3)")
    print(json.dumps({
        "metric": f"model_path_rt_cells_per_sec_{n}cube_{nchan}chan",
        "value": round(ours, 1),
        "unit": "cells/s",
        "vs_baseline": round(ours / baseline, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "pipeline_4run_256_warm_s": round(pipe_warm, 1),
        "pipeline_4run_256_cold_s": round(pipe_cold, 1),
        "pipeline_4run_256_device_s": round(pipe_device, 1),
        "pipeline_4run_256_transfer_s": round(pipe_transfer, 1),
    }))


if __name__ == "__main__":
    main()
