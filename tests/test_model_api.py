"""JetModel API behaviours beyond parity: float32 mode, light curves,
emergent intensity, str/repr, pipeline RRL + EW-telescope integration."""
import copy
import os

import numpy as np
import pytest
import jax.numpy as jnp

from rajepy_tpu import JetModel, Pipeline
from rajepy_tpu.models import analysis


def small(params, n=(16, 40, 16), bursts=True):
    p = copy.deepcopy(params)
    p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    if not bursts:
        p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                         'chi': np.array([]), 'which': np.array([])}
    return p


class TestDtypeAuto:
    """dtype='auto' (the constructor default) must resolve to f32 on an
    accelerator — the compacted-tile flagship path — and to f64 on the
    CPU."""

    def test_default_is_f64_on_cpu(self, model_params):
        jm = JetModel(small(model_params))
        assert jm._dtype == jnp.float64

    def test_auto_rule(self, monkeypatch):
        import jax
        assert JetModel.resolve_dtype('auto') == jnp.float64  # CPU conftest
        assert JetModel.resolve_dtype(None) == jnp.float64
        monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
        assert JetModel.resolve_dtype('auto') == jnp.float32
        assert JetModel.resolve_dtype('parity') == jnp.float64
        # explicit dtypes pass through regardless of backend
        assert JetModel.resolve_dtype(jnp.float64) == jnp.float64
        assert JetModel.resolve_dtype(jnp.float32) == jnp.float32


class TestUncollapsedSaveFits:
    """collapse=False products must WRITE correct files — the reference
    crashes on both shapes (4-D fails its ndims check; scalar 3-D hits
    len() on a float, classes.py:1585/1619-1623).  Deliberate fidelity
    deviation (PARITY.md)."""

    def test_multichannel_4d(self, model_params, tmp_path):
        from rajepy_tpu.io import fits as fitsio
        jm = JetModel(small(model_params))
        jm.time = 2.0 * 31536000.0
        f = str(tmp_path / 'tau4d.fits')
        freqs = np.array([5e9, 6e9, 7e9])
        tau = np.asarray(jm.optical_depth_ff(freqs, savefits=f,
                                             collapse=False))
        assert tau.ndim == 4
        data, hdr = fitsio.read_fits(f)
        assert data.shape == (3, jm.ny, jm.nz, jm.nx)
        assert hdr['CTYPE3'] == 'LINEAR'          # LOS axis, in au
        assert hdr['CDELT3'] == pytest.approx(jm.csize)
        assert hdr['CTYPE4'] == 'FREQ'
        # odd nchan: CRVAL must be the frequency AT CRPIX (the reference
        # formula is half a channel low for odd counts)
        assert hdr['CRPIX4'] == 2.0
        assert hdr['CRVAL4'] == pytest.approx(6e9)
        assert hdr['CDELT4'] == pytest.approx(1e9)

    def test_scalar_3d_los_cube(self, model_params, tmp_path):
        from rajepy_tpu.io import fits as fitsio
        jm = JetModel(small(model_params))
        jm.time = 2.0 * 31536000.0
        f = str(tmp_path / 'tau3d.fits')
        jm.optical_depth_ff(6e9, savefits=f, collapse=False)
        data, hdr = fitsio.read_fits(f)
        assert data.shape == (jm.ny, jm.nz, jm.nx)
        assert hdr['CTYPE3'] == 'LINEAR'
        assert hdr['RESTFRQ'] == pytest.approx(6e9)
        with pytest.raises(KeyError):
            hdr['CTYPE4']

    def test_even_nchan_header_unchanged(self, model_params, tmp_path):
        """Even channel counts keep the reference's exact CRVAL3 value
        (freq[n/2-1] + dnu/2) — the fix only moves odd/single counts."""
        from rajepy_tpu.io import fits as fitsio
        jm = JetModel(small(model_params))
        jm.time = 2.0 * 31536000.0
        f = str(tmp_path / 'flux.fits')
        freqs = np.array([4e9, 5e9, 6e9, 7e9])
        jm.flux_ff(freqs, savefits=f)
        _, hdr = fitsio.read_fits(f)
        assert hdr['CRPIX3'] == 2.5
        assert hdr['CRVAL3'] == pytest.approx(5e9 + 0.5e9)  # ref formula


class TestFloat32Mode:
    def test_f32_model_matches_f64(self, model_params):
        p = small(model_params)
        jm64 = JetModel(copy.deepcopy(p))
        jm32 = JetModel(copy.deepcopy(p), dtype=jnp.float32)
        f32 = jm32._ensure_fields()
        assert f32.nd.dtype == jnp.float32
        fl64 = jm64.flux_ff(np.array([6e9]))
        fl32 = jm32.flux_ff(np.array([6e9]))
        # f32 grid fill agrees to single precision
        np.testing.assert_allclose(np.nansum(fl32), np.nansum(fl64),
                                   rtol=1e-4)


class TestLightCurve:
    def test_matches_sequential_api(self, model_params):
        jm = JetModel(small(model_params))
        times = np.linspace(0.0, 1.5, 7)
        freqs = np.array([6e9, 1e10])
        lc = analysis.light_curve(jm, times, freqs)
        assert lc.shape == (7, 2)
        for i in (0, 3, 6):
            jm.time = times[i] * 31536000.0
            ref = np.nansum(jm.flux_ff(freqs), axis=(1, 2))
            np.testing.assert_allclose(lc[i], ref, rtol=1e-10)

    def test_burst_shows_in_curve(self, model_params):
        jm = JetModel(small(model_params))
        times = np.linspace(0.0, 1.5, 31)
        lc = analysis.light_curve(jm, times, [6e9])[:, 0]
        assert lc.max() > lc.min() * 1.02  # bursts modulate the flux


class TestEmergentIntensity:
    def test_reduces_to_slab_when_isothermal(self, model_params):
        """For an isothermal jet the ordered transfer integral must equal
        the reference's slab form B_nu(T)(1 - e^-tau) pixelwise."""
        from rajepy_tpu.ops import physics as mphys
        jm = JetModel(small(model_params, bursts=False))
        freq = 6e9
        ints = jm.emergent_intensity_ff(freq)
        tau = jm.optical_depth_ff(freq)
        t0 = jm.params['properties']['T_0']
        slab = float(mphys.blackbody_nu(freq, t0)) * \
            (-np.expm1(-tau)) * 1e-7 * 1e4
        np.testing.assert_allclose(ints, slab, rtol=1e-9, atol=1e-30)


class TestStr:
    def test_model_summary_table(self, model_params):
        jm = JetModel(small(model_params))
        s = str(jm)
        assert 'JET MODEL' in s and 'BURSTS' in s
        assert 'q_tau' in s and 'n_0' in s

    def test_run_tables(self, model_params, tmp_path):
        from rajepy_tpu.models.runs import ContinuumRun, RRLRun
        r = ContinuumRun(str(tmp_path), 1.0, 6e9, 1e8, 1e7, 600, 5,
                         ('VLA', 'A'))
        assert 'Continuum' in str(r)
        assert r.nchan == 10
        assert len(r.chan_freqs) == 10
        np.testing.assert_allclose(r.chan_freqs.mean(), 6e9)
        rr = RRLRun(str(tmp_path), 1.0, 'H58a', 1e8, 1e7, 600, 5,
                    ('VLA', 'A'))
        assert 'H58a' in str(rr)
        assert rr.fits_flux.endswith('Flux_Day365_H58a.fits')

    def test_no_numpy_scalar_reprs_in_tables(self, tmp_path):
        """np.str_ params-array elements must not deface run tables
        (numpy 2 reprs them as np.str_('VLA'))."""
        from rajepy_tpu.models.runs import ContinuumRun, RRLRun
        tscop = tuple(np.array(['VLA', 'A']))  # np.str_ elements
        r = ContinuumRun(str(tmp_path), 1.0, 6e9, 1e8, 1e7, 600, 5, tscop)
        assert "('VLA', 'A')" in str(r)
        assert 'np.str_' not in str(r)
        assert all(type(t) is str for t in r.tscop)
        rr = RRLRun(str(tmp_path), 1.0, np.str_('H58a'), 1e8, 1e7, 600, 5,
                    tscop)
        assert 'np.str_' not in str(rr)
        assert type(rr.line) is str


class TestPipelineIntegration:
    def _pparams(self, tmp_path, **continuum):
        base = {
            'min_el': 20.,
            'dcys': {'model_dcy': str(tmp_path / 'out')},
            'continuum': {'times': np.array([]), 'freqs': None,
                          't_obs': None, 'tscps': None, 't_ints': None,
                          'bws': None, 'chanws': None},
            'rrls': {'times': np.array([]), 'lines': None, 't_obs': None,
                     'tscps': None, 't_ints': None, 'bws': None,
                     'chanws': None},
        }
        base.update(continuum)
        return base

    def test_rrl_run_with_cube_imaging(self, model_params, tmp_path):
        pparams = self._pparams(
            tmp_path,
            rrls={'times': np.array([0.]), 'lines': np.array(['H58a']),
                  't_obs': np.array([1800]), 'tscps': np.array([('VLA',
                                                                 'D')]),
                  't_ints': np.array([60]), 'bws': np.array([4e6]),
                  'chanws': np.array([2e6])})
        jm = JetModel(small(model_params, n=(16, 40, 16)))
        pline = Pipeline(jm, pparams)
        pline.execute(simobserve=True, verbose=False, dryrun=False,
                      resume=False, clobber=True, plot=False)
        run = pline.runs[0]
        assert run.completed
        assert np.ndim(run.results['flux']) == 1  # per-channel fluxes
        from rajepy_tpu.io.fits import read_fits
        img, hdr = read_fits(run.products['clean_image'])
        assert img.ndim == 3 and img.shape[0] == 2  # 2-channel cube

    def test_device_fanout_matches_sequential(self, model_params, tmp_path):
        """Pipeline.execute's run-level device fan-out (active on the
        8-device test mesh) must write identical RT products to the
        sequential path (device_fanout=False)."""
        import jax
        if jax.device_count() < 2:
            pytest.skip("needs a multi-device mesh")
        from rajepy_tpu.io.fits import read_fits

        def pparams(sub):
            return self._pparams(
                tmp_path / sub,
                continuum={'times': np.array([0., 0.5, 1.]),
                           'freqs': np.array([6e9]),
                           't_obs': None, 'tscps': None, 't_ints': None,
                           'bws': np.array([1e8]),
                           'chanws': np.array([5e7])})

        jm = JetModel(small(model_params))
        pl_fan = Pipeline(jm, pparams('fan'))
        pl_fan.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False)
        jm2 = JetModel(small(model_params))
        pl_seq = Pipeline(jm2, pparams('seq'))
        pl_seq.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False, device_fanout=False)

        assert all(r.completed for r in pl_fan.runs)
        for rf, rs in zip(pl_fan.runs, pl_seq.runs):
            for attr in ('fits_em', 'fits_tau', 'fits_flux'):
                a, _ = read_fits(getattr(rf, attr))
                b, _ = read_fits(getattr(rs, attr))
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0)
            np.testing.assert_allclose(rf.results['flux'],
                                       rs.results['flux'], rtol=1e-12)

    def test_device_fanout_rrl_group(self, model_params, tmp_path):
        """Pipeline-level RRL run fan-out (2 epochs of one line) matches
        the sequential path."""
        import jax
        if jax.device_count() < 2:
            pytest.skip("needs a multi-device mesh")
        from rajepy_tpu.io.fits import read_fits

        def pparams(sub):
            return self._pparams(
                tmp_path / sub,
                rrls={'times': np.array([0., 0.8]),
                      'lines': np.array(['H58a']),
                      't_obs': None, 'tscps': None, 't_ints': None,
                      'bws': np.array([4e6]),
                      'chanws': np.array([2e6])})

        pl_fan = Pipeline(JetModel(small(model_params)), pparams('rfan'))
        pl_fan.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False)
        pl_seq = Pipeline(JetModel(small(model_params)), pparams('rseq'))
        pl_seq.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False, device_fanout=False)
        assert all(r.completed for r in pl_fan.runs)
        for rf, rs in zip(pl_fan.runs, pl_seq.runs):
            for attr in ('fits_em', 'fits_tau', 'fits_flux'):
                a, _ = read_fits(getattr(rf, attr))
                b, _ = read_fits(getattr(rs, attr))
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-30)

    def test_device_fanout_nonlte_rrl_group(self, model_params,
                                            tmp_path):
        """Non-LTE RRL runs fan out too (r5; r4 fan-out was LTE-only):
        2 non-LTE epochs of one line through the sharded program match
        the sequential rrl_rt_products(lte=False) path bit-for-bit (the
        per-epoch table coefficients are the same memoised values), and
        differ from the LTE products (the non-LTE composition really
        ran)."""
        import jax
        if jax.device_count() < 2:
            pytest.skip("needs a multi-device mesh")
        from rajepy_tpu.io.fits import read_fits

        def pparams(sub, lte):
            return self._pparams(
                tmp_path / sub,
                rrls={'times': np.array([0., 0.8]),
                      'lines': np.array(['H58a']),
                      'lte': np.array([lte]),
                      't_obs': None, 'tscps': None, 't_ints': None,
                      'bws': np.array([4e6]),
                      'chanws': np.array([2e6])})

        pl_fan = Pipeline(JetModel(small(model_params)),
                          pparams('nlfan', False))
        pl_fan.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False)
        # the group really took the fanned path
        assert any('Fanned 2 rrl runs' in str(e)
                   for e in pl_fan.log.entries.values())
        pl_seq = Pipeline(JetModel(small(model_params)),
                          pparams('nlseq', False))
        pl_seq.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False, device_fanout=False)
        pl_lte = Pipeline(JetModel(small(model_params)),
                          pparams('nllte', True))
        pl_lte.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False, device_fanout=False)
        assert all(r.completed for r in pl_fan.runs)
        assert all(not r.lte for r in pl_fan.runs)
        for rf, rs, rl in zip(pl_fan.runs, pl_seq.runs, pl_lte.runs):
            for attr in ('fits_em', 'fits_tau', 'fits_flux'):
                a, _ = read_fits(getattr(rf, attr))
                b, _ = read_fits(getattr(rs, attr))
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-30)
            fl_fan, _ = read_fits(rf.fits_flux)
            fl_lte, _ = read_fits(rl.fits_flux)
            # the non-LTE composition differs measurably from LTE
            assert not np.allclose(np.nan_to_num(fl_fan),
                                   np.nan_to_num(fl_lte), rtol=1e-6)

    def test_ew_telescope_scan_split(self, model_params, tmp_path):
        pparams = self._pparams(
            tmp_path,
            continuum={'times': np.array([0.]), 'freqs': np.array([6e9]),
                       't_obs': np.array([1200]),
                       'tscps': np.array([('ATCA', '6A')]),
                       't_ints': np.array([60]), 'bws': np.array([1e8]),
                       'chanws': np.array([1e8])})
        jm = JetModel(small(model_params, n=(16, 40, 16)))
        pline = Pipeline(jm, pparams)
        pline.execute(simobserve=True, verbose=False, dryrun=False,
                      resume=False, clobber=True, plot=False)
        assert pline.runs[0].completed
        assert os.path.exists(pline.runs[0].products['clean_image'])

    def test_resume_skips_completed(self, model_params, tmp_path):
        pparams = self._pparams(
            tmp_path,
            continuum={'times': np.array([0.]), 'freqs': np.array([6e9]),
                       't_obs': None, 'tscps': None, 't_ints': None,
                       'bws': None, 'chanws': None})
        jm = JetModel(small(model_params, n=(16, 40, 16)))
        pline = Pipeline(jm, pparams)
        pline.execute(simobserve=False, verbose=False, dryrun=False,
                      resume=False, clobber=True, plot=False)
        mtime = os.path.getmtime(pline.runs[0].fits_flux)
        # reload from the saved state and re-execute: must skip
        pline2 = Pipeline.load_pipeline(pline.save_file)
        assert pline2.runs[0].completed
        pline2.execute(simobserve=False, verbose=False, dryrun=False,
                       resume=True, clobber=False, plot=False)
        assert os.path.getmtime(pline2.runs[0].fits_flux) == mtime


class TestDiagnosticMaps:
    def test_matches_host_nan_reductions(self, model_params):
        """diagnostic_maps (device-side LOS reductions feeding the
        standard plots) must equal the host nanmean/nansum of the public
        NaN-view cubes, including all-empty sightlines (NaN)."""
        jm = JetModel(small(model_params))
        jm.time = 1.1 * 31536000.0
        m = jm.diagnostic_maps()
        ax = jm.los_axis
        with np.errstate(invalid='ignore'):
            np.testing.assert_allclose(
                m['n_e'], np.nanmean(jm.number_density, axis=ax),
                rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(
                m['T'], np.nanmean(jm.temperature, axis=ax),
                rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(
                m['x_i'], np.nanmean(jm.ion_fraction, axis=ax),
                rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(
                m['v_los'], np.nanmean(jm.vel[1], axis=ax),
                rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(
                m['ff_sum'],
                np.nansum(np.nan_to_num(jm.fill_factor, nan=0.0), axis=ax),
                rtol=1e-12)
        # empty sightlines exist in this grid and must be NaN
        assert np.isnan(m['T']).any()


class TestNegativeTravelTimePacking:
    def test_off_axis_packed_chi_matches_reference(self, model_params):
        """Off-axis geometries produce NEGATIVE travel times near the
        launch surface; the packed launch-time encoding feeding the
        compacted epoch/RRL/emergent paths must still recover the reference burst factor
        exactly (regression: the fixed +1 packing offset corrupted both
        the jet side and the time for ts < -1)."""
        import jax.numpy as jnp
        from rajepy_tpu.models import ejection as ej
        p = small(model_params, n=(24, 48, 24))
        p['geometry'].update(inc=55.0, pa=30.0)
        jm = JetModel(p)
        f = jm._ensure_fields()
        st = jm._rt_static()
        assert float(jnp.min(f.ts)) < -1.0, \
            "precondition: this geometry must produce ts < -1"
        assert jm._ts_pack_offset > 1.0
        t = 2.2 * 31536000.0
        chi_ref = np.asarray(ej.chi_field(f.red, t - f.ts, jm._spec_r,
                                          jm._spec_b))
        from rajepy_tpu.ops import tiles
        chi_packed = np.asarray(tiles.burst_factor(
            st.ts_signed, t, jm._burst_tuple(), jm._ts_pack_offset))
        np.testing.assert_allclose(chi_packed, chi_ref, rtol=1e-9)


class TestContinuumRTProducts:
    def test_matches_separate_calls_f64(self, model_params):
        """The fused per-run RT stage equals the three separate product
        calls on the exact f64 XLA path."""
        jm = JetModel(small(model_params))
        jm.time = 1.1 * 31536000.0
        freqs = np.array([6e9, 1e10])
        em, taus, fluxes = jm.continuum_rt_products(freqs)
        np.testing.assert_allclose(em, jm.emission_measure(), rtol=1e-14)
        np.testing.assert_allclose(taus, jm.optical_depth_ff(freqs),
                                   rtol=1e-14)
        np.testing.assert_allclose(fluxes, jm.flux_ff(freqs), rtol=1e-14)

    def test_rrl_products_match_separate_calls_f64(self, model_params):
        jm = JetModel(small(model_params))
        jm.time = 1.1 * 31536000.0
        from rajepy_tpu.ops.radtrans import RRLCoeffs
        nu0 = RRLCoeffs('H58a').nu0
        freqs = np.linspace(nu0 * 0.9999, nu0 * 1.0001, 3)
        em, tau_l, fluxes = jm.rrl_rt_products('H58a', freqs,
                                               contsub=False)
        np.testing.assert_allclose(em, jm.emission_measure(), rtol=1e-14)
        np.testing.assert_allclose(
            tau_l, jm.optical_depth_rrl('H58a', freqs), rtol=1e-12)
        np.testing.assert_allclose(
            fluxes, jm.flux_rrl('H58a', freqs, contsub=False), rtol=1e-9)

    def test_rrl_products_contsub_true(self, model_params):
        """contsub=True must drop the continuum exactly like flux_rrl."""
        jm = JetModel(small(model_params))
        jm.time = 0.7 * 31536000.0
        from rajepy_tpu.ops.radtrans import RRLCoeffs
        nu0 = RRLCoeffs('H58a').nu0
        freqs = np.linspace(nu0 * 0.9999, nu0 * 1.0001, 3)
        _, _, fl_sub = jm.rrl_rt_products('H58a', freqs, contsub=True)
        np.testing.assert_allclose(
            fl_sub, jm.flux_rrl('H58a', freqs, contsub=True), rtol=1e-9,
            atol=1e-30)


class TestAddEjectionEvent:
    """add_ejection_event must invalidate every cache that baked the old
    burst set in (review r3s6: a burst added to a previously burst-free
    model was silently ignored — the jitted kernels and the
    with_time=False fields survived)."""

    def test_burst_added_after_use_changes_products(self, model_params):
        from rajepy_tpu import constants as cnsts
        t_burst_yr, hl_yr, chi_f = 0.5, 0.15, 5.0

        # model constructed WITH the burst = ground truth
        p_ref = small(model_params, bursts=False)
        p_ref['ejection'] = {'t_0': np.array([t_burst_yr]),
                             'hl': np.array([hl_yr]),
                             'chi': np.array([chi_f]),
                             'which': np.array(['B'])}
        ref = JetModel(p_ref)
        ref.time = 0.6 * cnsts.YEAR
        # optically-thin frequency: the burst is invisible in total flux
        # where tau >> 1
        freq = 1e11
        want = np.nan_to_num(np.asarray(ref.flux_ff(freq)), nan=0.0)

        # burst-free model, USED first (kernels compiled, fields built
        # without travel times), then the burst added via the API
        jm = JetModel(small(model_params, bursts=False))
        jm.time = 0.6 * cnsts.YEAR
        before = np.nan_to_num(np.asarray(jm.flux_ff(freq)), nan=0.0)
        peak = chi_f * jm.ss_jml('B')
        jm.add_ejection_event(t_burst_yr * cnsts.YEAR, peak,
                              hl_yr * cnsts.YEAR, 'B')
        after = np.nan_to_num(np.asarray(jm.flux_ff(freq)), nan=0.0)

        assert after.sum() > before.sum() * 1.5   # the burst is seen
        np.testing.assert_allclose(after, want, rtol=1e-9)
