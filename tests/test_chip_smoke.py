"""chip_smoke.py's device gate and its check functions, on the CPU at
small shapes (the script itself runs on a GPU; see README)."""
import copy
import importlib.util
import os

import numpy as np
import pytest
import jax.numpy as jnp

from rajepy_tpu import JetModel

_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'chip_smoke.py')


@pytest.fixture(scope='module')
def smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jm32(smoke):
    p = smoke.model_params()
    p['grid'].update(n_x=24, n_y=128, n_z=24, l_z=None)
    p['geometry'].update(inc=55.0, pa=30.0)
    jm = JetModel(p, dtype=jnp.float32)
    jm.time = 2.0 * smoke.YEAR
    assert jm._tiled()
    return jm


def test_device_phase_refuses_cpu(smoke):
    with pytest.raises(RuntimeError, match='not a GPU'):
        smoke.check_device()


def test_main_fails_without_result_line_on_cpu(smoke, capsys):
    assert smoke.main([]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert out and not out[-1].startswith('{')


@pytest.mark.parametrize("wide", [False, True])
def test_rrl_check(smoke, jm32, wide):
    freqs = smoke.line_freqs(40, smoke.RRL_WIDE_BW) if wide else \
        smoke.line_freqs(6)
    r = smoke.rrl_check(jm32, freqs, interpret=True, n_rep=1)
    assert r['kernel_err'] < smoke.RRL_TOL
    assert r['xla_err'] < smoke.RRL_TOL
    assert r['kernel_s']['median'] > 0 and r['xla_s']['median'] > 0


def test_epoch_check(smoke, jm32):
    e = smoke.epoch_check(jm32, n_rep=1)
    assert e['tiles_err'] < smoke.CONTINUUM_TOL
    assert e['full_err'] < smoke.CONTINUUM_TOL
    assert e['stream_bytes'] == 3 * jm32._rt_static().a_t.size * 4


def test_emergent_check(smoke, jm32):
    m = smoke.emergent_check(jm32, np.geomspace(3e8, 3e11, 3), n_rep=1)
    assert m['tiles_err'] < smoke.EMERGENT_TOL
    assert m['full_err'] < smoke.EMERGENT_TOL
    assert m['tiles_s']['min'] <= m['tiles_s']['median'] <= \
        m['tiles_s']['max']


def test_emergent_oracle_matches_f64_model(smoke, model_params):
    """The host oracle is the float64 model's own ordered scan."""
    import jax
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=16, n_y=40, n_z=16)
    jm = JetModel(p, dtype='parity')
    jm.time = 0.6 * smoke.YEAR
    freqs = np.array([1e9, 2e10])
    f = jm._ensure_fields()
    dbase = jax.jit(lambda a, f, t: a * smoke._chi2_f64(jm, f, t))(
        jm._rt_static().a, f, jm.time)
    t_0, reyn, _, _ = jm._rt_constants()
    want = smoke.emergent_oracle(dbase, f.temp, f.inside, freqs, t_0, reyn)
    np.testing.assert_allclose(jm.emergent_intensity_ff(freqs), want,
                               rtol=1e-9, atol=1e-9 * want.max())


def test_degrid_check(smoke):
    img = np.zeros((64, 64))
    img[30:34, 28:37] = 1.0
    img[5, 60] = 2.0
    assert smoke.degrid_check(img, 2e-8, n_vis=256) < smoke.DEGRID_TOL


def test_campaign_params(smoke, tmp_path):
    p = smoke.campaign_params(str(tmp_path))
    assert p['dcys']['model_dcy'] == str(tmp_path)
    assert len(p['continuum']['times']) == 6
    np.testing.assert_array_equal(p['rrls']['times'], [0.0])
    assert p['rrls']['bws'][0] / p['rrls']['chanws'][0] == 1000


def test_map_err_and_gate(smoke):
    want = np.array([[[1.0, 2.0]], [[1e-6, 4e-6]]])
    got = want.copy()
    got[1, 0, 1] += 4e-11
    assert smoke.map_err(got, want) == pytest.approx(1e-5)
    smoke.gate('x', 1e-5, 1e-5)
    with pytest.raises(AssertionError):
        smoke.gate('x', 2e-5, 1e-5)


def test_timed_reports_spread(smoke):
    out, s = smoke.timed(lambda x: x + 1.0, jnp.ones(4), n_rep=3)
    np.testing.assert_array_equal(out, 2.0)
    assert 0 < s['min'] <= s['median'] <= s['max']
    assert smoke.fmt_ms(s).endswith(']')


def _errs(clean, dirty=0.0):
    return {'fits_flux': [0.0, 2e-7], 'rrl dirty': [dirty, 0.0],
            'rrl clean_image': [0.0, clean]}


@pytest.mark.parametrize("fanned, repeat, ok", [
    (_errs(3e-3), _errs(1e-3), True),      # CLEAN within 10x the repeat
    (_errs(3e-3), _errs(1e-4), False),     # CLEAN beyond 10x the repeat
    (_errs(3e-3), _errs(0.0), False),      # exact repeat: MULTI_RTOL
    (_errs(1e-3, dirty=2e-5), _errs(1e-3), False),   # dirty is linear
])
def test_multi_gates(smoke, fanned, repeat, ok):
    if ok:
        smoke.multi_gates(fanned, repeat)
    else:
        with pytest.raises(AssertionError):
            smoke.multi_gates(fanned, repeat)
