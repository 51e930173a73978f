"""Physics-layer tests: the reference's closed-form-vs-quadrature pattern
(test/test_physics.py:15-57 — its strongest idea, SURVEY §4) plus the
Reynolds (1986) analytic relations against independent oracles."""
import numpy as np
import pytest
from scipy.integrate import quad

from rajepy_tpu import constants as cnsts
from rajepy_tpu.ops import physics as mphys

MSOL = 1.989e30
REL_ETOL = 1e-3
QNDS = np.linspace(-2, 2, 9)
QNVS = np.linspace(-2, 2, 9)


def _quad_cross_section(w0_au, qnd, qnv, r1_au, r2_au):
    """Independent integral of the disc-wind cross-section density profile
    (the integrand of test/test_physics.py:21-23)."""
    w0 = w0_au * cnsts.AU
    r1 = r1_au * cnsts.AU
    r2 = r2_au * cnsts.AU

    def f(w):
        return w * (1.0 + w * (r2 - r1) / (w0 * r1)) ** (qnd + qnv)

    return quad(f, 0.0, w0)[0]


class TestMlrConversions:
    def test_mlr_from_n_0_vs_quad(self):
        n0, mu, w0, v0, r1, r2 = 1e9, 1.3, 5.0, 300., 0.5, 5.0
        const = 2. * np.pi * n0 * mu * v0 * 1e6 * 1e3 * \
            cnsts.atomic_mass("H")
        for qnd in QNDS:
            for qnv in QNVS:
                expected = _quad_cross_section(w0, qnd, qnv, r1, r2) * \
                    const / (MSOL / cnsts.YEAR)
                result = mphys.mlr_from_n_0(n0, v0, w0, mu, qnd, qnv, r1,
                                            r2)
                # NB closed form uses cnsts.MSOL=1.98847e30; reference test
                # uses 1.989e30 — compare with its own convention
                expected *= MSOL / cnsts.MSOL
                assert result == pytest.approx(expected, rel=REL_ETOL)

    def test_n_0_from_mlr_vs_quad(self):
        mlr, mu, w0, v0, r1, r2 = 1e-6, 1.3, 5.0, 400., 0.5, 5.0
        const = 2. * np.pi * mu * v0 * 1e3 * cnsts.atomic_mass("H")
        for qnd in QNDS:
            for qnv in QNVS:
                expected = (mlr * cnsts.MSOL / cnsts.YEAR) / \
                    (_quad_cross_section(w0, qnd, qnv, r1, r2) * const) * \
                    1e-6
                result = mphys.n_0_from_mlr(mlr, v0, w0, mu, qnd, qnv, r1,
                                            r2)
                assert result == pytest.approx(expected, rel=REL_ETOL)

    def test_roundtrip(self):
        for qnd in (-1.0, 0.0, 0.7):
            n0 = mphys.n_0_from_mlr(1e-7, 150., 1.0, 1.3, qnd, 0.2, 0.25,
                                    2.5)
            mlr = mphys.mlr_from_n_0(n0, 150., 1.0, 1.3, qnd, 0.2, 0.25,
                                     2.5)
            assert mlr == pytest.approx(1e-7, rel=1e-12)


class TestReynoldsRelations:
    def test_q_indices(self):
        assert mphys.q_n(7 / 9, 0.0) == pytest.approx(-14 / 9)
        assert mphys.q_tau(7 / 9, 0.0, -14 / 9, 0.0) == \
            pytest.approx(7 / 9 - 28 / 9)

    def test_tau_r_consistent_with_r_tau1(self):
        # r_tau1 inverts tau_r: tau at the returned radius must be 1
        kw = dict(r_0=1.0, w_0=1.0, n_0=1e8, chi_0=0.1, T_0=1e4,
                  freq=6e9, inc=60., epsilon=7 / 9, q_x=0.0, q_T=0.0,
                  opang=25.)
        q_n_ = mphys.q_n(kw['epsilon'], 0.0)
        r1 = mphys.r_tau1(q_n_=q_n_, **kw)
        r1_au = r1 / cnsts.AU2CM
        tau = float(mphys.tau_r(r1_au, kw['r_0'], kw['w_0'], kw['n_0'],
                                kw['chi_0'], kw['T_0'], kw['freq'],
                                kw['inc'], kw['epsilon'], q_n_, kw['q_x'],
                                kw['q_T'], kw['opang']))
        assert tau == pytest.approx(1.0, rel=1e-10)

    def test_gamma_upper_negative_order(self):
        # against mpmath's generalised incomplete gamma
        import mpmath
        for s in (-1.7, -0.3, 0.5, 2.2):
            for x in (0.01, 0.5, 3.0):
                ref = float(mpmath.gammainc(s, x))
                got = float(mphys._gamma_upper(s, x))
                assert got == pytest.approx(ref, rel=1e-10)

    def test_gamma_upper_nonpositive_integer_order(self):
        """Zero/negative-integer orders (e.g. eps=1, q_v=-0.5 gives
        q_tau=-2, c=2 -> Gamma(-1, tau)) used to divide by zero in the
        lifting recurrence (review r3s6); they anchor on E_1 now.
        Near-integer orders stay within the lift's cancellation bound."""
        import mpmath
        for s in (0.0, -1.0, -2.0, -3.0):
            for x in (0.01, 0.5, 3.0, 10.0):
                ref = float(mpmath.gammainc(s, x))
                got = float(mphys._gamma_upper(s, x))
                assert got == pytest.approx(ref, rel=1e-9), (s, x)
        for s in (-0.9999999, -1.000000001, -2.00000001):
            for x in (0.5, 3.0):
                ref = float(mpmath.gammainc(s, x))
                got = float(mphys._gamma_upper(s, x))
                assert got == pytest.approx(ref, rel=1e-6), (s, x)

    def test_flux_expected_r86_positive_and_scales(self, model_params):
        from rajepy_tpu import JetModel
        import copy
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=8, n_y=8, n_z=8, l_z=None)
        jm = JetModel(p)
        f1 = float(mphys.flux_expected_r86(jm.params, 5e9, 2.0))
        f2 = float(mphys.flux_expected_r86(jm.params, 1.5e10, 2.0))
        assert f1 > 0 and f2 > f1  # rising spectrum below turnover
        fa = float(mphys.approx_flux_expected_r86(jm.params, 5e9))
        assert fa > 0
        # approximate and exact Reynolds forms agree to tens of percent
        assert fa == pytest.approx(f1, rel=0.5)

    def test_tau_r_from_jm_matches_params_form(self, model_params):
        from rajepy_tpu import JetModel
        import copy
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=8, n_y=8, n_z=8, l_z=None)
        jm = JetModel(p)
        for r in (2.0, 10.0, 50.0):
            direct = float(mphys.tau_r_from_params(jm.params, 6e9, r))
            via_jm = float(mphys.tau_r_from_jm(jm, 6e9, r))
            assert via_jm == direct and direct > 0

    def test_flux_expected_r86_against_reference(self, model_params):
        from .reference_oracle import get_reference, reference_jetmodel
        if get_reference() is None:
            pytest.skip("reference tree unavailable")
        import copy
        import RaJePy.maths.physics as rphys
        from rajepy_tpu import JetModel
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=8, n_y=8, n_z=8, l_z=None)
        jm = JetModel(p)
        ref_jm = reference_jetmodel(p)
        for freq in (5e9, 4.4e10):
            ours = float(mphys.flux_expected_r86(jm.params, freq, 2.0))
            theirs = float(rphys.flux_expected_r86(ref_jm, freq, 'B', 2.0))
            assert ours == pytest.approx(theirs, rel=1e-9)
            ours_a = float(mphys.approx_flux_expected_r86(jm.params, freq))
            theirs_a = float(rphys.approx_flux_expected_r86(ref_jm, freq,
                                                            'B'))
            assert ours_a == pytest.approx(theirs_a, rel=1e-9)


class TestMiscPhysics:
    def test_blackbody_rj_limit(self):
        # Rayleigh-Jeans: B_nu ~ 2 nu^2 k T / c^2 (cgs)
        import numpy as np
        nu, t = 1e9, 1e4
        rj = 2.0 * nu ** 2 * cnsts.K_CGS * t / cnsts.C_CGS ** 2
        assert float(mphys.blackbody_nu(nu, t)) == pytest.approx(rj,
                                                                 rel=1e-3)

    def test_blackbody_integer_frequency(self):
        # an int frequency must promote, not truncate the 2.47e-16
        # cube-root prefactor to integer 0 (regression: silent 0.0)
        import numpy as np
        want = float(mphys.blackbody_nu(6.0e9, 1e4))
        assert float(mphys.blackbody_nu(6000000000, 1e4)) == \
            pytest.approx(want, rel=1e-12)
        got = np.asarray(mphys.blackbody_nu(
            np.array([6000000000], dtype=np.int64), 1e4))
        assert got[0] == pytest.approx(want, rel=1e-12)

    def test_expm1_planck_f32_gradient_not_nan(self):
        # the f32 Planck denominator expm1(h nu / k T): the gradient of
        # B_nu with respect to T is finite and positive from the radio
        # band to the sub-mm, at jet and at cold-dust temperatures
        import jax
        import jax.numpy as jnp
        f32 = jnp.float32
        for nu in (1e9, 4.3e10, 3e11):
            for temp in (1e4, 30.0):
                g = jax.grad(lambda t: mphys.blackbody_nu(
                    jnp.asarray(nu, f32), t))(jnp.asarray(temp, f32))
                assert bool(jnp.isfinite(g)) and float(g) > 0.0

    def test_doppler(self):
        assert float(mphys.doppler_shift(1e10, 299.792458)) == \
            pytest.approx(1e10 * (1 - 1e-3), rel=1e-12)

    def test_nu_rrl_h_alpha(self):
        # H109a is the classic 5.0089 GHz line
        assert float(mphys.nu_rrl(109, 1, 'H')) == pytest.approx(5.00892e9,
                                                                 rel=1e-4)

    def test_ss73_disc_relations(self):
        args = (0.01, 1e-7, 0.5, 1.0)
        assert mphys.temp_ss73(*args) > 0
        assert mphys.n_ss73(*args) > 0
        assert mphys.u0_ss73(*args) > 0
        assert mphys.z0_ss73(*args) > 0
        assert mphys.tau_ss73(*args) > 0
        assert mphys.vr_ss73(*args) > 0
        assert mphys.h_ss73(*args) > 0
        with pytest.raises(ValueError):
            mphys.temp_ss73(*args, zone='a')
