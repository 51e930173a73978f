"""RRL physics beyond the hot path: band-integrated profiles, channel-
averaged opacity, non-LTE coefficient scaffolding — vs the reference."""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from rajepy_tpu.ops import rrls as mrrl

from .reference_oracle import get_reference


def _ref_rrls():
    if get_reference() is None:
        pytest.skip("reference tree unavailable")
    import RaJePy.maths.rrls as rrrl
    return rrrl


class TestIntegratedProfiles:
    def test_thermal_integrated_parity(self):
        rrrl = _ref_rrls()
        nu0, fwhm, bw = 1.4716e10, 1e6, 2e5
        for off in (-3e6, -5e5, 0.0, 7e5, 4e6):
            ours = float(mrrl.phi_thermal_nu_integrated(nu0 + off, nu0,
                                                        fwhm, bw))
            ref = float(rrrl.phi_thermal_nu_integrated(nu0 + off, nu0,
                                                       fwhm, bw))
            assert ours == pytest.approx(ref, rel=1e-9, abs=1e-300)

    def test_stark_integrated_parity(self):
        rrrl = _ref_rrls()
        nu0, fwhm, bw = 1.4716e10, 5e5, 2e5
        for off in (-3e6, 0.0, 7e5):
            ours = float(mrrl.phi_stark_nu_integrated(nu0 + off, nu0, fwhm,
                                                      bw))
            ref = float(rrrl.phi_stark_nu_integrated(nu0 + off, nu0, fwhm,
                                                     bw))
            assert ours == pytest.approx(ref, rel=1e-9)

    @pytest.mark.parametrize('method, rtol', [('qa13', 2e-6),
                                              ('quad', 1e-6)])
    def test_voigt_integrated_vs_quadrature(self, method, rtol):
        """Both channel-average formulations — the QA13 indefinite-integral
        series (the reference's closed form, sign defect fixed) and
        GL quadrature — vs scipy fine integration of the wofz profile."""
        from scipy.special import wofz
        from scipy.integrate import quad
        nu0, fg, fl, bw = 1.4716e10, 1e6, 2e5, 3e5
        sigma = fg / 2 / np.sqrt(2 * np.log(2))

        def phi(nu):
            return np.real(wofz(((nu - nu0) + 1j * fl / 2) /
                                sigma / np.sqrt(2))) / sigma / \
                np.sqrt(2 * np.pi)

        for off in (-2e6, -3e5, 0.0, 5e5, 3e6):
            f = nu0 + off
            ref, _ = quad(phi, f - bw / 2, f + bw / 2, epsrel=1e-12)
            ours = float(mrrl.phi_voigt_nu_integrated(f, nu0, fg, fl, bw,
                                                      average=False,
                                                      method=method))
            assert ours == pytest.approx(ref, rel=rtol)

    def test_qa13_series_error_budget(self):
        """Sweep wide/narrow channels x core/wing offsets x Stark fractions:
        the QA13 series and the independent GL quadrature must agree
        wherever either is trustworthy (each is exact where the other is
        weakest: qa13 in the core/wide channels, quad in the far wings)."""
        nu0, fg = 1.4716e10, 1e6
        offs = np.array([-8.0, -3.0, -0.5, 0.0, 0.7, 2.5, 6.0, 10.0]) * fg
        for fl in (1e3, 1e5, 4e5):
            for bw in (1e4, 3e5, 5e6):
                f = nu0 + offs
                qa = np.asarray(mrrl.phi_voigt_nu_integrated(
                    f, nu0, fg, fl, bw, method='qa13'))
                qd = np.asarray(mrrl.phi_voigt_nu_integrated(
                    f, nu0, fg, fl, bw, method='quad'))
                # wide channels: quadrature degrades (3e-6 at 5 FWHM);
                # far wings: the series degrades (1e-4, same as the
                # reference's own implementation there)
                np.testing.assert_allclose(qa, qd, rtol=3e-4, atol=0.0)

    def test_voigt_integrated_vs_reference_series(self):
        """vs the reference's QA13 implementation
        (/root/reference/maths/rrls.py:191-272): exact agreement outside
        the central expansion region; inside it the reference's
        ``-1.**n`` precedence slip (always -1, the paper has (-1)^n)
        biases it by up to ~3%, and our value must be the one matching
        fine numerical integration (PARITY.md deviations)."""
        rrrl = _ref_rrls()
        from scipy.integrate import quad
        nu0, fg, fl, bw = 1.4716e10, 1e6, 1e4, 1e5

        # mid/external regions (|x + 4y| > 4.5): bit-level agreement
        for off in (-4e6, 3e6, 8e6):
            f = nu0 + off
            ours = float(mrrl.phi_voigt_nu_integrated(f, nu0, fg, fl, bw))
            ref = float(rrrl.phi_voigt_nu_integrated(f, nu0, fg, fl, bw))
            assert ours == pytest.approx(ref, rel=1e-9)

        # central region: quantify both against the true integral
        for off in (0.0, 5e5, 1.5e6):
            f = nu0 + off
            truth, _ = quad(
                lambda nu: rrrl.phi_voigt_nu(nu0, fl, fg, nu),
                f - bw / 2, f + bw / 2, epsrel=1e-12)
            truth /= bw
            ours = float(mrrl.phi_voigt_nu_integrated(f, nu0, fg, fl, bw))
            ref = float(rrrl.phi_voigt_nu_integrated(f, nu0, fg, fl, bw))
            assert ours == pytest.approx(truth, rel=1e-9)
            ref_err = abs(ref - truth) / truth
            # 0.8% at line centre, growing to ~30% where the channel
            # difference cancels — the documented defect
            assert 1e-4 < ref_err < 0.5

    def test_kappa_l_average_parity(self):
        rrrl = _ref_rrls()
        args = dict(freq=1.4716e10, n=58, oscillator_strength=11.3,
                    av_line_profile=3e-7, n_e=1e7, n_i=9e6, temp=1e4, z=1,
                    energy_n1=-6.5e-15, bw=2e5)
        ours = float(mrrl.kappa_l_average(**args))
        ref = float(rrrl.kappa_l_average(
            args['freq'], args['n'], args['oscillator_strength'],
            args['av_line_profile'], args['n_e'], args['n_i'],
            args['temp'], args['z'], args['energy_n1'], args['bw']))
        assert ours == pytest.approx(ref, rel=1e-9)


class TestNonLTEMode:
    """Beyond-reference non-LTE RRL products (the reference raises on
    lte=False; this framework computes the G&S slab forms when departure
    coefficients are supplied)."""

    @pytest.fixture(scope='class')
    def jm(self):
        import copy
        import numpy as np
        from rajepy_tpu import JetModel
        params = {
            "target": {"name": "nl", "ra": "04:31:34.1",
                       "dec": "+18:08:04.9", "epoch": "J2000",
                       "dist": 120., "v_lsr": 6.2, "M_star": 0.55,
                       "R_1": .25, "R_2": 2.5},
            "grid": {"n_x": 12, "n_y": 24, "n_z": 12, "l_z": None,
                     "c_size": 0.5},
            "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1.,
                         "r_0": 1., "inc": 90., "pa": 0.,
                         "rotation": "CCW"},
            "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                           "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
            "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4,
                           "mu": 1.3, "mlr_bj": 1e-7, "mlr_rj": 5e-8},
            "ejection": {"t_0": np.array([]), "hl": np.array([]),
                         "chi": np.array([]), "which": np.array([])},
        }
        return JetModel(copy.deepcopy(params))

    def test_auto_departure_coefficients(self, jm):
        """lte=False with NO explicit coefficients runs from the bundled
        case-B b_n table at the jet's EM-weighted conditions (the
        reference raises here, classes.py:1258-1262)."""
        b_n1, b_n2 = jm.departure_coefficients('H58a')
        assert 0.1 < b_n1 <= 1.05 and 0.1 < b_n2 <= 1.05
        # this jet is dense (n_e >> 1e6 at the base): b_n near unity,
        # and the upper level closer to LTE than the lower
        t_char, ne_char = jm.characteristic_conditions()
        assert 1e3 < t_char < 5e4 and ne_char > 1e4
        i_nl = jm.intensity_rrl('H58a', 1.4716e10, lte=False)
        i_auto = jm.intensity_rrl('H58a', 1.4716e10, lte=False,
                                  departure_coeffs=(b_n1, b_n2))
        np.testing.assert_allclose(np.nan_to_num(i_nl),
                                   np.nan_to_num(i_auto), rtol=1e-12)
        tau = jm.optical_depth_rrl('H58a', 1.4716e10, lte=False)
        assert np.isfinite(np.nan_to_num(tau)).all()

    def test_characteristic_conditions_memoised_per_time(self, jm):
        """The EM-weighted conditions are a device reduction and host
        pull hit by every departure entry point — repeated calls at one model time must reuse the cached
        pair, and a time change must recompute (r5 review fix)."""
        t_orig = jm.time
        try:
            jm.time = 0.0
            first = jm.characteristic_conditions()
            assert jm.characteristic_conditions() == first
            cache = jm._char_cond_cache
            assert cache[0.0] == first
            jm.time = 3.15e7
            second = jm.characteristic_conditions()
            assert {0.0, 3.15e7} <= set(cache) and \
                cache[3.15e7] == second
        finally:
            jm.time = t_orig  # class-scoped fixture: later tests
            #                   must see the fixture's model time

    def test_lte_limit(self, jm):
        """b_n1 = b_n2 = 1 must reproduce the LTE products exactly
        (beta = eta = 1)."""
        freqs = np.linspace(1.4715e10, 1.4717e10, 3)
        i_lte = jm.intensity_rrl('H58a', freqs)
        i_nl = jm.intensity_rrl('H58a', freqs, lte=False,
                                departure_coeffs=(1.0, 1.0))
        np.testing.assert_allclose(np.nan_to_num(i_nl),
                                   np.nan_to_num(i_lte), rtol=1e-12)
        t_lte = jm.optical_depth_rrl('H58a', freqs)
        t_nl = jm.optical_depth_rrl('H58a', freqs, lte=False,
                                    departure_coeffs=(1.0, 1.0))
        np.testing.assert_allclose(np.nan_to_num(t_nl),
                                   np.nan_to_num(t_lte), rtol=1e-12)

    def test_stimulated_amplification(self, jm):
        """At radio frequencies h nu << k T, b_n2 > b_n1 drives beta
        negative (stimulated emission dominates): the non-LTE line
        opacity goes negative and the line amplifies over LTE — the
        classic RRL maser behaviour the slab formulas encode."""
        freq = 1.4716e10
        t_nl = jm.optical_depth_rrl(freq=freq, rrl='H58a', lte=False,
                                    departure_coeffs=(0.90, 0.95))
        t_lte = jm.optical_depth_rrl('H58a', freq)
        sel = np.nan_to_num(t_lte) > 0
        assert (np.nan_to_num(t_nl)[sel] < 0).all()
        i_nl = jm.intensity_rrl('H58a', freq, lte=False,
                                departure_coeffs=(0.90, 0.95))
        i_lte = jm.intensity_rrl('H58a', freq)
        assert np.nanmax(i_nl) > np.nanmax(i_lte)


class TestNonLTECoefficients:
    def test_parity(self):
        rrrl = _ref_rrls()
        freq, temp = 1.4716e10, 9000.0
        b_n1, b_n2 = 0.92, 0.95
        tau_c, tau_l_star = 0.3, 0.05
        kappa_c, kappa_l_star = 1e-18, 3e-19

        beta_o = float(mrrl.beta_coeff(freq, temp, b_n1, b_n2))
        beta_r = float(rrrl.beta_coeff(freq, temp, b_n1, b_n2))
        assert beta_o == pytest.approx(beta_r, rel=1e-9)

        tau_o = float(mrrl.tau_nu_coeff(beta_o, tau_c, tau_l_star, b_n1))
        tau_r = float(rrrl.tau_nu_coeff(beta_r, tau_c, tau_l_star, b_n1))
        assert tau_o == pytest.approx(tau_r, rel=1e-12)

        eta_o = float(mrrl.eta_coeff(b_n1, b_n2, kappa_c, kappa_l_star,
                                     beta_o))
        eta_r = float(rrrl.eta_coeff(b_n1, b_n2, kappa_c, kappa_l_star,
                                     beta_r))
        assert eta_o == pytest.approx(eta_r, rel=1e-9)

        r_o = float(mrrl.line_continuum_ratio_nonlte(eta_o, tau_o, tau_c))
        r_r = float(rrrl.line_continuum_ratio_nonlte(eta_r, tau_r, tau_c))
        assert r_o == pytest.approx(r_r, rel=1e-9)

    def test_lte_ratio_parity(self):
        rrrl = _ref_rrls()
        ours = float(mrrl.line_continuum_ratio_lte(0.4, 0.07))
        ref = float(rrrl.line_continuum_ratio_lte(0.4, 0.07))
        assert ours == pytest.approx(ref, rel=1e-12)


class TestWofzDerivative:
    def test_custom_jvp_matches_finite_difference(self):
        # wofz carries a custom JVP from the Faddeeva ODE
        # w'(z) = -2 z w(z) + 2i/sqrt(pi) (ops/voigt.py) — check both
        # partials of both parts against central differences across the
        # rational, continued-fraction and small-y regions
        import jax
        from rajepy_tpu.ops.voigt import wofz
        pts = [(0.3, 0.1), (2.0, 1.0), (7.5, 0.02), (12.0, 5.0),
               (0.5, 4.0), (20.0, 1e-3)]
        eps = 1e-6
        for x0, y0 in pts:
            for part in (0, 1):
                gx = float(jax.grad(
                    lambda a: wofz(a, jnp.float64(y0))[part])(
                        jnp.float64(x0)))
                fdx = float((wofz(x0 + eps, y0)[part] -
                             wofz(x0 - eps, y0)[part]) / (2 * eps))
                assert gx == pytest.approx(fdx, rel=1e-6, abs=1e-10)
                gy = float(jax.grad(
                    lambda b: wofz(jnp.float64(x0), b)[part])(
                        jnp.float64(y0)))
                fdy = float((wofz(x0, y0 + eps)[part] -
                             wofz(x0, y0 - eps)[part]) / (2 * eps))
                assert gy == pytest.approx(fdy, rel=1e-6, abs=1e-10)


class TestLineConstants:
    def test_rest_freq_and_widths_parity(self):
        rrrl = _ref_rrls()
        for line in ('H58a', 'He42b', 'H109a', 'C76g'):
            el, n, dn = mrrl.rrl_parser(line)
            assert (el, n, dn) == rrrl.rrl_parser(line)
            assert float(mrrl.rrl_nu_0(el, n, dn)) == pytest.approx(
                float(rrrl.rrl_nu_0(el, n, dn)), rel=1e-11)
            assert mrrl.f_n1n2(n, dn) == pytest.approx(
                rrrl.f_n1n2(n, dn), rel=1e-12)
            assert mrrl.energy_n(n, el) == pytest.approx(
                rrrl.energy_n(n, el), rel=1e-12)
        assert float(mrrl.ni_from_ne(1e7, 'H')) == pytest.approx(
            float(rrrl.ni_from_ne(1e7, 'H')), rel=1e-9)
        assert float(mrrl.deltanu_l(1e7, 58, 1)) == pytest.approx(
            float(rrrl.deltanu_l(1e7, 58, 1)), rel=1e-12)
        assert float(mrrl.deltanu_g(1.47e10, 9000.0, 'H')) == \
            pytest.approx(float(rrrl.deltanu_g(1.47e10, 9000.0, 'H')),
                          rel=1e-9)
        assert float(mrrl.deltanu_v(1e6, 2e5)) == pytest.approx(
            float(rrrl.deltanu_v(1e6, 2e5)), rel=1e-12)


class TestDepartureCoefficients:
    """The case-B b_n(n, T_e, n_e) statistical-equilibrium solver
    (ops.departure) behind the auto-derived non-LTE coefficients."""

    def test_ingredient_anchors(self):
        """Published exact values the rate ingredients must hit."""
        from rajepy_tpu.ops import departure as dep
        assert dep.oscillator_strength(1, 2) == pytest.approx(0.4162,
                                                              rel=1e-3)
        assert dep.einstein_a(1, 2) == pytest.approx(4.699e8, rel=2e-3)
        assert dep.einstein_a(2, 3) == pytest.approx(4.410e7, rel=5e-3)
        # Kramers high-n asymptote f(n -> n+1) = 0.1908 n
        assert dep.oscillator_strength(80, 81) == pytest.approx(
            0.1908 * 80, rel=2e-2)
        # case-B recombination sum at 1e4 K: alpha_B = 2.59e-13 cm^3/s
        alpha_b = float(np.sum(dep.radiative_recombination(
            np.arange(2, 600), 1e4))) * 1e6
        assert alpha_b == pytest.approx(2.59e-13, rel=0.15)
        # alpha_1: 1.58e-13 cm^3/s (Seaton 1959)
        alpha_1 = float(dep.radiative_recombination(
            np.array([1]), 1e4)[0]) * 1e6
        assert alpha_1 == pytest.approx(1.58e-13, rel=0.25)

    def test_lte_fixed_point(self):
        """Collisions satisfy detailed balance EXACTLY, so b -> 1 as
        n_e -> infinity at any temperature."""
        from rajepy_tpu.ops import departure as dep
        for T in (3e3, 1e4, 3e4):
            b = dep.solve_bn(T, 1e15)
            assert np.max(np.abs(b[8:] - 1.0)) < 1e-3, T

    def test_case_b_shape(self):
        """Low-density case-B physics: b_n < 1 (radiative cascade
        underpopulates vs Saha), monotone approach to 1 with n_e, and
        d ln b / dn > 0 over the RRL range (the G&S stimulated-emission
        amplification sign)."""
        from rajepy_tpu.ops import departure as dep
        b_lo = dep.solve_bn(1e4, 1e2)
        b_mid = dep.solve_bn(1e4, 1e6)
        b_hi = dep.solve_bn(1e4, 1e10)
        n = np.arange(2, dep.N_SOLVE + 1)
        rrl = (n >= 40) & (n <= 200)
        assert (b_lo[rrl] < 1.0).all() and (b_lo[rrl] > 0.3).all()
        assert (b_mid[rrl] >= b_lo[rrl] - 1e-6).all()
        assert (b_hi[rrl] >= b_mid[rrl] - 1e-6).all()
        # rising with n across the RRL range at nebular densities
        sel = (n >= 58) & (n <= 150)
        assert (np.diff(b_lo[sel]) > -1e-5).all()

    def test_table_interpolation(self):
        """The bundled table + bilinear lookup agree with a direct solve
        at an off-grid point to the interpolation error."""
        from rajepy_tpu.ops import departure as dep
        T, ne = 9200.0, 3.7e5
        direct = dep.solve_bn(T, ne)
        for n in (58, 59, 100):
            got = float(dep.b_n(n, T, ne))
            want = float(direct[n - 2])
            assert got == pytest.approx(want, abs=0.02), n
        b1, b2 = dep.b_n_pair(58, 1, T, ne)
        assert b2 > b1  # upper level closer to LTE

    def test_table_edges_and_errors(self):
        from rajepy_tpu.ops import departure as dep
        b, ns, logT, logne = dep.get_table()
        assert np.isfinite(b).all()
        # beyond-edge queries clamp instead of extrapolating
        assert float(dep.b_n(100, 1e6, 1e20)) == pytest.approx(
            float(dep.b_n(100, 10 ** logT[-1], 10 ** logne[-1])),
            rel=1e-6)
        with pytest.raises(ValueError):
            dep.b_n(5000, 1e4, 1e4)


class TestDepartureSystematic:
    """The quantified rate-prescription error band (r4 review item 1):
    the table carries x0.5/x2 collisional-rate edge solutions
    (RATE_SCALE_BAND — the van Regemorter/Thomson accuracy class) whose
    spread is the b_n systematic, propagated into non-LTE fit errors by
    fit.rrl_departure_systematic.  No digitised Salem & Brocklehurst
    (1979) / Storey & Hummer (1995) tabulation is available offline, so
    the central solution is pinned to figure-level literature bands and
    the systematic is the by-construction rate-tier bound (PARITY.md)."""

    def test_band_magnitude_and_structure(self):
        from rajepy_tpu.ops import departure as dep
        # the band is widest in the radiative-cascade regime...
        s_low = float(dep.b_n_systematic(100, 1e4, 1e2))
        assert 0.02 < s_low < 0.15
        # ...and vanishes at high n_e: detailed balance pins b = 1 at
        # EVERY rate scale
        s_dense = float(dep.b_n_systematic(100, 1e4, 1e12))
        assert s_dense < 1e-4
        assert float(dep.b_n_systematic(58, 1e4, 1e6)) < 0.02

    def test_edge_tables_bracket_sensibly(self):
        """Stronger collisions (the 'hi' x2 table) push b towards 1;
        weaker pull it away — at every tabulated RRL point below the
        thermalised regime."""
        from rajepy_tpu.ops import departure as dep
        t = dep._get_table_dict()
        n_sel = (t['n'] >= 40) & (t['n'] <= 200)
        lo_ne = t['logne'] <= 6.0
        b = t['b'][:, lo_ne][:, :, n_sel]
        b_hi = t['b_hi'][:, lo_ne][:, :, n_sel]
        b_lo = t['b_lo'][:, lo_ne][:, :, n_sel]
        assert (b_hi >= b - 1e-5).all()
        assert (b_lo <= b + 1e-5).all()

    def test_central_values_in_literature_bands(self):
        """Figure-level anchors from the published case-B b_n curves
        (Brocklehurst 1970 / S&B 1979 as reproduced in Gordon &
        Sorochenko 2002): generous bands reflecting read-off-a-figure
        precision."""
        from rajepy_tpu.ops import departure as dep
        assert 0.70 < float(dep.b_n(100, 1e4, 1e2)) < 0.90
        assert 0.90 < float(dep.b_n(100, 1e4, 1e4)) < 1.00
        assert 0.80 < float(dep.b_n(58, 1e4, 1e4)) < 0.95
        assert 0.55 < float(dep.b_n(58, 1e4, 1e2)) < 0.75
        assert 0.93 < float(dep.b_n(170, 1e4, 1e2)) < 1.00

    def test_coherent_pairs_and_jetmodel_accessors(self, model_params=None):
        from rajepy_tpu.ops import departure as dep
        (b1, b2) = dep.b_n_pair(58, 1, 1e4, 1e4)
        (l1, l2) = dep.b_n_pair(58, 1, 1e4, 1e4, 'lo')
        (h1, h2) = dep.b_n_pair(58, 1, 1e4, 1e4, 'hi')
        s1, s2 = dep.b_n_pair_systematic(58, 1, 1e4, 1e4)
        assert l1 < b1 < h1 and l2 < b2 < h2
        assert s1 == pytest.approx(max(abs(l1 - b1), abs(h1 - b1)))
        # coherence: the shifted pairs keep b2 > b1 (the amplification
        # sign survives the rate-scale perturbation)
        assert l2 > l1 and h2 > h1


class TestDepartureMaps:
    def test_per_sightline_maps(self):
        """departure_coefficient_maps: (nx, nz) per-column coefficients
        accepted by the non-LTE entry points, b = 1 off the jet, and the
        scalar auto-derivation is their EM-weighted middle ground."""
        import copy
        from rajepy_tpu import JetModel
        import tests.test_rrl_extras as _m
        params = {
            "target": {"name": "nlm", "ra": "04:31:34.1",
                       "dec": "+18:08:04.9", "epoch": "J2000",
                       "dist": 120., "v_lsr": 6.2, "M_star": 0.55,
                       "R_1": .25, "R_2": 2.5},
            "grid": {"n_x": 12, "n_y": 24, "n_z": 12, "l_z": None,
                     "c_size": 0.5},
            "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1.,
                         "r_0": 1., "inc": 90., "pa": 0.,
                         "rotation": "CCW"},
            "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                           "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
            "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4,
                           "mu": 1.3, "mlr_bj": 1e-7, "mlr_rj": 5e-8},
            "ejection": {"t_0": np.array([]), "hl": np.array([]),
                         "chi": np.array([]), "which": np.array([])},
        }
        jm = JetModel(copy.deepcopy(params))
        b1m, b2m = jm.departure_coefficient_maps('H58a')
        assert b1m.shape == (jm.nx, jm.nz)
        occ = np.nan_to_num(jm.fill_factor, nan=0.0).sum(axis=1) > 0
        assert np.allclose(b1m[~occ], 1.0) and np.allclose(b2m[~occ], 1.0)
        assert (b1m[occ] <= 1.0 + 1e-6).all() and (b1m[occ] > 0.1).all()
        # scalar auto value lies within the per-column spread
        b1s, _ = jm.departure_coefficients('H58a')
        assert b1m[occ].min() - 1e-6 <= b1s <= b1m[occ].max() + 1e-6
        # map-valued coefficients broadcast through the entry points
        i_map = jm.intensity_rrl('H58a', 1.4716e10, lte=False,
                                 departure_coeffs=(b1m, b2m))
        assert np.isfinite(np.nan_to_num(i_map)).all()
        t_map = jm.optical_depth_rrl('H58a', 1.4716e10, lte=False,
                                     departure_coeffs=(b1m, b2m))
        assert np.isfinite(np.nan_to_num(t_map)).all()
        # b = 1 maps reproduce LTE exactly
        ones = np.ones((jm.nx, jm.nz))
        i_one = jm.intensity_rrl('H58a', 1.4716e10, lte=False,
                                 departure_coeffs=(ones, ones))
        i_lte = jm.intensity_rrl('H58a', 1.4716e10)
        np.testing.assert_allclose(np.nan_to_num(i_one),
                                   np.nan_to_num(i_lte), rtol=1e-12)


class TestNonLTEPipeline:
    def test_rrl_rt_products_nonlte_consistency(self):
        """The fused per-run stage with lte=False must equal the public
        optical_depth_rrl / flux_rrl non-LTE entry points."""
        import copy
        from rajepy_tpu import JetModel
        params = {
            "target": {"name": "nlp", "ra": "04:31:34.1",
                       "dec": "+18:08:04.9", "epoch": "J2000",
                       "dist": 120., "v_lsr": 6.2, "M_star": 0.55,
                       "R_1": .25, "R_2": 2.5},
            "grid": {"n_x": 12, "n_y": 24, "n_z": 12, "l_z": None,
                     "c_size": 0.5},
            "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1.,
                         "r_0": 1., "inc": 90., "pa": 0.,
                         "rotation": "CCW"},
            "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                           "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
            "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4,
                           "mu": 1.3, "mlr_bj": 1e-7, "mlr_rj": 5e-8},
            "ejection": {"t_0": np.array([]), "hl": np.array([]),
                         "chi": np.array([]), "which": np.array([])},
        }
        jm = JetModel(copy.deepcopy(params))
        freqs = np.linspace(1.4715e10, 1.4717e10, 3)
        bpair = (0.93, 0.97)
        em, tau_nl, flux_nl = jm.rrl_rt_products(
            'H58a', freqs, contsub=True, lte=False,
            departure_coeffs=bpair)
        tau_api = jm.optical_depth_rrl('H58a', freqs, lte=False,
                                       departure_coeffs=bpair)
        flux_api = jm.flux_rrl('H58a', freqs, lte=False, contsub=True,
                               departure_coeffs=bpair)
        np.testing.assert_allclose(tau_nl, np.nan_to_num(tau_api),
                                   rtol=1e-10, atol=1e-300)
        np.testing.assert_allclose(flux_nl, np.nan_to_num(flux_api),
                                   rtol=1e-10, atol=1e-300)
        # and lte=True reproduces the old signature exactly
        em2, tau_l, flux_l = jm.rrl_rt_products('H58a', freqs,
                                                contsub=True)
        np.testing.assert_allclose(
            tau_l, np.nan_to_num(jm.optical_depth_rrl('H58a', freqs)),
            rtol=1e-10, atol=1e-300)

    def test_pipeline_lte_flag(self, tmp_path):
        """An 'lte' array in the rrls params section runs that line's RT
        non-LTE (auto-derived coefficients) end to end."""
        import copy
        from rajepy_tpu import JetModel, Pipeline
        from rajepy_tpu.io.fits import read_fits
        params = {
            "target": {"name": "nlp2", "ra": "04:31:34.1",
                       "dec": "+18:08:04.9", "epoch": "J2000",
                       "dist": 120., "v_lsr": 6.2, "M_star": 0.55,
                       "R_1": .25, "R_2": 2.5},
            "grid": {"n_x": 12, "n_y": 24, "n_z": 12, "l_z": None,
                     "c_size": 0.5},
            "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1.,
                         "r_0": 1., "inc": 90., "pa": 0.,
                         "rotation": "CCW"},
            "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                           "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
            "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4,
                           "mu": 1.3, "mlr_bj": 1e-7, "mlr_rj": 5e-8},
            "ejection": {"t_0": np.array([]), "hl": np.array([]),
                         "chi": np.array([]), "which": np.array([])},
        }

        def pparams(dcy, lte_arr):
            rr = {'times': np.array([0.]), 'lines': np.array(['H58a']),
                  't_obs': np.array([1800]),
                  'tscps': np.array([('VLA', 'D')]),
                  't_ints': np.array([60]), 'bws': np.array([6e6]),
                  'chanws': np.array([2e6])}
            if lte_arr is not None:
                rr['lte'] = lte_arr
            return {'min_el': 20., 'dcys': {'model_dcy': dcy},
                    'continuum': {'times': np.array([]),
                                  'freqs': np.array([]),
                                  't_obs': np.array([]),
                                  'tscps': np.array([]),
                                  't_ints': np.array([]),
                                  'bws': np.array([]),
                                  'chanws': np.array([])},
                    'rrls': rr}

        pl_nl = Pipeline(JetModel(copy.deepcopy(params)),
                         pparams(str(tmp_path / 'nl'), np.array([False])))
        assert pl_nl.runs[0].lte is False
        pl_nl.execute(simobserve=False, verbose=False, resume=False,
                      clobber=True, plot=False)
        pl_lte = Pipeline(JetModel(copy.deepcopy(params)),
                          pparams(str(tmp_path / 'lte'), None))
        assert pl_lte.runs[0].lte is True
        pl_lte.execute(simobserve=False, verbose=False, resume=False,
                       clobber=True, plot=False)
        f_nl, _ = read_fits(pl_nl.runs[0].fits_flux)
        f_lte, _ = read_fits(pl_lte.runs[0].fits_flux)
        assert np.isfinite(np.nan_to_num(f_nl)).all()
        # the non-LTE stimulated correction changes the line flux
        assert not np.allclose(np.nan_to_num(f_nl),
                               np.nan_to_num(f_lte), rtol=1e-6)
        # RESUME with only the flux product missing: the per-product
        # fallback path must keep the run's non-LTE mode (a silent LTE
        # recompute under the non-LTE filename was a real r4 bug)
        os.remove(pl_nl.runs[0].fits_flux)
        pl_nl.runs[0].completed = False
        pl_nl.execute(simobserve=False, verbose=False, resume=True,
                      clobber=False, plot=False)
        f_res, _ = read_fits(pl_nl.runs[0].fits_flux)
        np.testing.assert_allclose(np.nan_to_num(f_res),
                                   np.nan_to_num(f_nl), rtol=1e-10)
