"""The compacted-tile model paths, driven end-to-end through JetModel.

A float32 model takes the compacted-tile path on any platform
(ops.paths.use_tiles), so the model-level tile plumbing — compaction
caches, launch-time packing (including the off-axis negative-travel-time
offset), segment reassembly, the epoch/RRL/emergent dispatch — runs here
on the CPU exactly as on the GPU, with only the RRL Voigt sums taking the
XLA form instead of the Triton kernel.  Both real bugs this plumbing has
had (negative-ts packing corruption, and a stale kernel signature) lived
in this glue and were invisible to kernel-only tests.
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rajepy_tpu import JetModel
from rajepy_tpu.ops import paths


def _model(params, inc=90.0, pa=0.0, n=(24, 48, 24), dtype=jnp.float32):
    p = copy.deepcopy(params)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    p['geometry'].update(inc=inc, pa=pa)
    return JetModel(p, dtype=dtype)


def _rel(got, want):
    got = np.nan_to_num(np.asarray(got, dtype=float))
    want = np.nan_to_num(np.asarray(want, dtype=float))
    denom = np.abs(want).max()
    assert denom > 0
    return np.max(np.abs(got - want)) / denom


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_tile_products_match_f64_oracle(model_params, inc, pa):
    """flux_ff / emission_measure / optical_depth_rrl /
    emergent_intensity_ff through the compacted path vs the float64
    full-cube model — on-axis AND the off-axis geometry whose negative
    travel times broke the original launch-time packing."""
    jm32 = _model(model_params, inc, pa)
    jm64 = _model(model_params, inc, pa, dtype=jnp.float64)
    assert jm32._tiled() and not jm64._tiled()
    t = 2.2 * 31536000.0
    jm32.time = jm64.time = t

    st = jm32._rt_static()
    assert st.seg is not None, "compaction must be live for f32"
    assert jm64._rt_static().seg is None
    if (inc, pa) != (90.0, 0.0):
        assert jm32._ts_pack_offset > 1.0  # negative ts present

    freqs = np.array([6e9, 2.2e10])
    assert _rel(jm32.flux_ff(freqs), jm64.flux_ff(freqs)) < 1e-5
    assert _rel(jm32.emission_measure(), jm64.emission_measure()) < 1e-5

    from rajepy_tpu.ops.radtrans import RRLCoeffs
    nu0 = RRLCoeffs('H58a').nu0
    rrl_f = np.linspace(nu0 * 0.99998, nu0 * 1.00002, 3)
    assert _rel(jm32.optical_depth_rrl('H58a', rrl_f),
                jm64.optical_depth_rrl('H58a', rrl_f)) < 1e-4
    assert _rel(jm32.emergent_intensity_ff(freqs),
                jm64.emergent_intensity_ff(freqs)) < 1e-5
    # flux_rrl exercises the remaining tiled surfaces: the factorised
    # continuum tau (epoch tiles under the RRL intensity) + cached tbar
    assert _rel(jm32.flux_rrl('H58a', rrl_f, contsub=False),
                jm64.flux_rrl('H58a', rrl_f, contsub=False)) < 1e-4
    # non-LTE tiles path (b_n coefficients traced)
    kw = dict(lte=False, departure_coeffs=(0.96, 0.98))
    assert _rel(jm32.optical_depth_rrl('H58a', rrl_f, **kw),
                jm64.optical_depth_rrl('H58a', rrl_f, **kw)) < 1e-4


def test_tile_light_curve_batch_path(model_params):
    """The lax.map-batched light curve (tiled path) vs per-epoch f64."""
    from rajepy_tpu.models import analysis
    jm32 = _model(model_params)
    jm64 = _model(model_params, dtype=jnp.float64)
    times = [0.5, 1.2, 2.0]
    lc32 = analysis.light_curve(jm32, times, [6e9])
    lc64 = analysis.light_curve(jm64, times, [6e9])
    assert 'light_curve_batch' in jm32._jit_cache
    np.testing.assert_allclose(lc32, lc64, rtol=2e-5)
    assert np.ptp(lc64) > 0  # bursts actually vary the curve


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_tile_continuum_rt_products(model_params, inc, pa):
    """The one-pass per-run RT stage (both epoch bases over the tiles in
    one pass) vs the three separate product calls — on-axis and
    off-axis."""
    jm32 = _model(model_params, inc, pa)
    jm32.time = 2.2 * 31536000.0
    assert jm32._rt_static().seg is not None
    freqs = np.array([6e9, 2.2e10])
    em, taus, fluxes = jm32.continuum_rt_products(freqs)
    np.testing.assert_allclose(em, np.asarray(jm32.emission_measure()),
                               rtol=1e-6)
    np.testing.assert_allclose(taus,
                               np.asarray(jm32.optical_depth_ff(freqs)),
                               rtol=1e-6)
    np.testing.assert_allclose(fluxes, np.asarray(jm32.flux_ff(freqs)),
                               rtol=1e-6)


@pytest.mark.parametrize("inc,pa", [(90.0, 0.0), (55.0, 30.0)])
def test_tile_rrl_rt_products(model_params, inc, pa):
    """The one-pass per-run RRL stage vs the separate product calls,
    through the compacted path."""
    jm32 = _model(model_params, inc, pa)
    jm32.time = 2.2 * 31536000.0
    from rajepy_tpu.ops.radtrans import RRLCoeffs
    nu0 = RRLCoeffs('H58a').nu0
    freqs = np.linspace(nu0 * 0.99998, nu0 * 1.00002, 3)
    em, tau_l, fluxes = jm32.rrl_rt_products('H58a', freqs, contsub=False)
    np.testing.assert_allclose(em, np.asarray(jm32.emission_measure()),
                               rtol=1e-5)
    np.testing.assert_allclose(
        tau_l, np.asarray(jm32.optical_depth_rrl('H58a', freqs)),
        rtol=1e-5)
    np.testing.assert_allclose(
        fluxes, np.asarray(jm32.flux_rrl('H58a', freqs, contsub=False)),
        rtol=1e-4)


def test_path_choice(monkeypatch, model_params):
    """ops.paths: float32 + tiles + the Triton RRL kernel on a GPU; the
    XLA RRL tile form on any other platform; float64 (no tiles) for
    'auto' on the CPU and for 'parity' everywhere; and an empty tile set
    keeps even a float32 model on the full-cube forms."""
    assert jax.default_backend() == 'cpu'
    assert paths.compute_dtype('auto') == jnp.float64
    assert not paths.use_triton_rrl()
    counted = []
    assert not paths.use_tiles(jnp.float64, lambda: counted.append(1) or 9)
    assert not counted          # float64 never pays the tile count
    assert not paths.use_tiles(jnp.float32, lambda: 0)
    assert paths.use_tiles(jnp.float32, lambda: 3)

    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    assert paths.compute_dtype('auto') == jnp.float32
    assert paths.compute_dtype(None) == jnp.float32
    assert paths.compute_dtype('parity') == jnp.float64
    assert paths.use_triton_rrl()
    jm = _model(model_params, dtype='auto')
    assert jm._dtype == jnp.float32 and jm._tiled()

    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=8, n_y=16, n_z=8, l_z=None, c_size=1e-3)
    tiny = JetModel(p, dtype=jnp.float32)   # grid far inside the jet base
    assert not tiny._ensure_fields().inside.any()
    assert not tiny._tiled()
    assert tiny._rt_static().seg is None
