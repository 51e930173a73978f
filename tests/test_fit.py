"""Differentiable-fitting tests (rajepy_tpu.fit) — the gradient-inference
capability the reference's forward-only pipeline has no analogue for.

Strategy: exact-parity of the fit forward against the public flux_ff API,
autodiff-vs-finite-difference gradient checks, and round-trip parameter
recovery (synthesise observations from known 'true' parameters, start the
optimiser from a perturbed guess, assert recovery)."""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rajepy_tpu import JetModel
from rajepy_tpu import fit as jfit

YEAR = 31536000.0


def _small(params, n=16):
    p = copy.deepcopy(params)
    p['grid'].update(n_x=n, n_y=n, n_z=n, l_z=None)
    return p


# optically-thin channels included so density (mlr) is constrained — at
# the bundled parameters the low-GHz channels sit at tau >> 1 where the
# SED is pure blackbody and carries no density information
SED_FREQS = np.array([6e9, 4.4e10, 1e11, 3e11])

from rajepy_tpu.ops import rrls as _mrrl  # noqa: E402

_H58A_NU0 = _mrrl.rrl_nu_0('H', 58, 1)


class TestForwardParity:
    def test_sed_forward_matches_flux_ff(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR  # bursts active
        fwd, th0 = jfit.build_sed_forward(
            jm, SED_FREQS, ('properties.mlr_bj', 'properties.T_0'))
        ours = np.asarray(fwd(th0))
        api = np.nansum(jm.flux_ff(SED_FREQS), axis=(1, 2))
        assert ours == pytest.approx(api, rel=1e-12)

    def test_forward_parity_off_axis(self, model_params):
        # off-axis geometries have negative travel times near the launch
        # surface — the fit path must agree there too
        p = _small(model_params)
        p['geometry'].update(inc=55., pa=30.)
        jm = JetModel(p)
        jm.time = 2.0 * YEAR
        fwd, th0 = jfit.build_sed_forward(
            jm, SED_FREQS, ('properties.T_0',))
        api = np.nansum(jm.flux_ff(SED_FREQS), axis=(1, 2))
        assert np.asarray(fwd(th0)) == pytest.approx(api, rel=1e-12)

    def test_geometry_free_params_rederive_chain(self, model_params):
        # freeing epsilon must re-derive mod_r_0 AND q_n in-trace: nudging
        # epsilon in theta equals the flux of a model built with nudged
        # epsilon.  Off-axis geometry: at inc=90/pa=0 the symmetric grid
        # puts voxel corners EXACTLY on the jet boundary, where eager-vs-
        # jit 1-ulp arithmetic differences flip the inside mask.
        p = _small(model_params)
        p['geometry'].update(inc=60., pa=20.)
        jm = JetModel(p)
        jm.time = 0.0
        fwd, th0 = jfit.build_sed_forward(
            jm, SED_FREQS, ('geometry.epsilon',))
        p2 = copy.deepcopy(p)
        p2['geometry']['epsilon'] = float(th0[0]) + 0.05
        jm2 = JetModel(p2)
        jm2.time = 0.0
        api2 = np.nansum(jm2.flux_ff(SED_FREQS), axis=(1, 2))
        assert np.asarray(fwd(th0 + 0.05)) == pytest.approx(api2, rel=1e-12)

    def test_unsupported_free_param_raises(self, model_params):
        jm = JetModel(_small(model_params))
        with pytest.raises(ValueError, match="unsupported free parameter"):
            jfit.build_sed_forward(jm, SED_FREQS, ('properties.n_0',))

    def test_rrl_forward_matches_flux_rrl(self, model_params):
        # line-only and line+continuum forms both replay the public
        # flux_rrl chain exactly (bursts active)
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 5))
        for contsub in (True, False):
            fwd, th0 = jfit.build_rrl_spectrum_forward(
                jm, 'H58a', freqs,
                ('properties.T_0', 'target.v_lsr'), contsub=contsub)
            ours = np.asarray(fwd(th0))
            api = np.nansum(jm.flux_rrl('H58a', freqs, contsub=contsub),
                            axis=(1, 2))
            assert ours == pytest.approx(api, rel=1e-12)


class TestFloat32Path:
    def test_f32_forward_and_grad_match_f64(self, model_params):
        # the accelerator fitting precision: forward within f32 eps of the
        # f64 oracle, gradients finite and matching (the gaunt log-sum
        # form guards against the k_B*T ~ 1e-19 JVP underflow)
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        free = ('properties.mlr_bj', 'properties.T_0')
        f64, th0 = jfit.build_sed_forward(jm, SED_FREQS, free)
        f32, _ = jfit.build_sed_forward(jm, SED_FREQS, free,
                                        dtype=jnp.float32)
        a, b = np.asarray(f64(th0)), np.asarray(f32(th0))
        assert b.dtype == np.float32
        assert b == pytest.approx(a, rel=1e-5)
        g32 = np.asarray(jax.grad(
            lambda t: jnp.sum(jnp.log(f32(t))))(th0))
        g64 = np.asarray(jax.grad(
            lambda t: jnp.sum(jnp.log(f64(t))))(th0))
        assert np.all(np.isfinite(g32))
        assert g32 == pytest.approx(g64, rel=1e-4)


class TestGradients:
    def test_grad_matches_finite_difference(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        free = ('properties.mlr_bj', 'properties.T_0', 'power_laws.q_T')
        fwd, th0 = jfit.build_sed_forward(jm, SED_FREQS, free)

        def loss(th):
            return jnp.sum(jnp.log(fwd(th)))

        g = np.asarray(jax.grad(loss)(th0))
        eps = 1e-5
        for i in range(len(free)):
            fd = (float(loss(th0.at[i].add(eps))) -
                  float(loss(th0.at[i].add(-eps)))) / (2 * eps)
            assert g[i] == pytest.approx(fd, rel=2e-5, abs=1e-12)

    def test_rrl_grad_matches_finite_difference(self, model_params):
        # exercises the wofz custom JVP (the Faddeeva-ODE derivative)
        # through the full line chain: Doppler shift, widths, Voigt,
        # kappa_L, slab intensity
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        free = ('properties.T_0', 'target.v_lsr', 'properties.mlr_bj')
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 5))
        fwd, th0 = jfit.build_rrl_spectrum_forward(jm, 'H58a', freqs,
                                                   free)

        def loss(th):
            return jnp.sum(fwd(th) * 1e6) ** 2

        g = np.asarray(jax.grad(loss)(th0))
        assert np.all(np.isfinite(g)) and np.all(g != 0)
        eps = 1e-5
        for i in range(len(free)):
            fd = (float(loss(th0.at[i].add(eps))) -
                  float(loss(th0.at[i].add(-eps)))) / (2 * eps)
            assert g[i] == pytest.approx(fd, rel=5e-5, abs=1e-12)

    def test_light_curve_grad_finite(self, model_params):
        jm = JetModel(_small(model_params))
        times = np.linspace(0.5, 3.0, 5) * YEAR
        fwd, th0, _ = jfit.build_light_curve_forward(
            jm, times, np.array([4.4e10]))
        g = jax.grad(lambda t: jnp.sum(fwd(t)))(th0)
        assert np.all(np.isfinite(np.asarray(g)))
        assert np.any(np.asarray(g) != 0)


class TestRecovery:
    def test_sed_recovers_mlr_and_t0(self, model_params):
        p = _small(model_params)
        true_mlr = p['properties']['mlr_bj'] * 2.5
        true_t0 = p['properties']['T_0'] * 0.6
        pt = copy.deepcopy(p)
        pt['properties'].update(mlr_bj=true_mlr, T_0=true_t0)
        jm_true = JetModel(pt)
        jm_true.time = 2.0 * YEAR
        obs = np.nansum(jm_true.flux_ff(SED_FREQS), axis=(1, 2))

        jm = JetModel(p)
        jm.time = 2.0 * YEAR
        res = jfit.fit_sed(jm, SED_FREQS, obs, steps=500,
                           learning_rate=0.05)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(true_mlr, rel=1e-4)
        assert res.values['properties.T_0'] == \
            pytest.approx(true_t0, rel=1e-4)
        assert res.loss[-1] < 1e-10 < res.loss[0]
        # param_dict round-trips into a constructible model
        jm_fit = JetModel(res.param_dict(p))
        jm_fit.time = 2.0 * YEAR
        sed = np.nansum(jm_fit.flux_ff(SED_FREQS), axis=(1, 2))
        assert sed == pytest.approx(obs, rel=1e-3)

    def test_map_fit_recovers_mlr(self, model_params):
        p = _small(model_params)
        pt = copy.deepcopy(p)
        true_mlr = p['properties']['mlr_bj'] * 3.0
        pt['properties']['mlr_bj'] = true_mlr
        jm_true = JetModel(pt)
        jm_true.time = 0.0
        obs = np.nan_to_num(jm_true.flux_ff(np.array([1e11]))[0])

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_map(jm, 1e11, obs, free=('properties.mlr_bj',),
                           steps=300, learning_rate=0.05)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(true_mlr, rel=1e-3)

    def test_geometry_gradient_smooth_part_nonzero(self, model_params):
        # geometry morphology enters through the HARD voxel inside-mask
        # (fields.fill_factor_area), so the loss vs inc/opang is a
        # staircase: gradients capture only the smooth in-mask dependence
        # (jet-frame r/w values).  Pin that the smooth part exists and is
        # finite — and that recovery claims for mask-moving params are
        # out of scope by construction (see fit module docstring).
        p = _small(model_params)
        p['geometry'].update(inc=60., pa=20.)
        jm = JetModel(p)
        jm.time = 0.0
        fwd, th0 = jfit.build_sed_forward(jm, SED_FREQS,
                                          ('geometry.inc',))
        g = np.asarray(jax.grad(lambda t: jnp.sum(jnp.log(fwd(t))))(th0))
        assert np.all(np.isfinite(g)) and np.any(g != 0)

    def test_light_curve_recovers_burst(self, model_params):
        p = _small(model_params)
        pt = copy.deepcopy(p)
        pt['ejection'] = {'t_0': np.array([1.2]), 'hl': np.array([0.4]),
                          'chi': np.array([4.0]),
                          'which': np.array(['B'])}
        jm_true = JetModel(pt)
        times = np.linspace(0.5, 4.0, 12) * YEAR
        freqs = np.array([4.4e10])
        obs = []
        for t in times:
            jm_true.time = t
            obs.append(np.nansum(jm_true.flux_ff(freqs), axis=(1, 2)))
        obs = np.asarray(obs)

        pg = copy.deepcopy(p)
        pg['ejection'] = {'t_0': np.array([1.8]), 'hl': np.array([0.7]),
                          'chi': np.array([2.0]),
                          'which': np.array(['B'])}
        jm = JetModel(pg)
        res = jfit.fit_light_curve(jm, times, freqs, obs, steps=800,
                                   learning_rate=0.03)
        assert res.t_0[0] == pytest.approx(1.2, abs=1e-3)
        assert res.hl[0] == pytest.approx(0.4, rel=1e-3)
        assert res.chi[0] == pytest.approx(4.0, rel=1e-3)

    def test_laplace_uncertainties_cover_truth(self, model_params):
        # noisy synthetic SED: the fitted values must sit within ~3 sigma
        # of truth, and the noise-free sigmas must be much smaller
        p = _small(model_params)
        true_mlr = p['properties']['mlr_bj'] * 2.0
        pt = copy.deepcopy(p)
        pt['properties']['mlr_bj'] = true_mlr
        jm_true = JetModel(pt)
        jm_true.time = 0.0
        freqs = np.geomspace(4e10, 3e11, 8)
        clean = np.nansum(jm_true.flux_ff(freqs), axis=(1, 2))
        rng = np.random.default_rng(7)
        noisy = clean * np.exp(rng.normal(0.0, 0.02, clean.shape))

        jm = JetModel(p)
        jm.time = 0.0
        free = ('properties.mlr_bj', 'properties.T_0')
        res = jfit.fit_sed(jm, freqs, noisy, free=free, steps=500,
                           learning_rate=0.05)
        fwd, _ = jfit.build_sed_forward(jm, freqs, free)
        sig, cov = jfit.laplace_uncertainties(fwd, res.theta, noisy, free)
        mlr_hat = res.values['properties.mlr_bj']
        assert sig['properties.mlr_bj'] > 0
        assert abs(mlr_hat - true_mlr) < 4 * sig['properties.mlr_bj']
        assert cov.shape == (2, 2)
        # noise-free data -> near-zero estimated noise scale -> tiny sigma
        res0 = jfit.fit_sed(jm, freqs, clean, free=free, steps=500,
                            learning_rate=0.05)
        sig0, _ = jfit.laplace_uncertainties(fwd, res0.theta, clean, free)
        assert sig0['properties.mlr_bj'] < 1e-3 * sig['properties.mlr_bj']

    def test_posterior_sampling_matches_laplace(self, model_params):
        # preconditioned MALA on a near-Gaussian posterior: the sample
        # mean must sit on the MAP and the sample std must reproduce the
        # Laplace sigma (the analytic check for sampler correctness)
        p = _small(model_params)
        true = copy.deepcopy(p)
        true['properties']['mlr_bj'] = 2e-7
        jm_t = JetModel(true)
        jm_t.time = 0.0
        freqs = np.geomspace(4e10, 3e11, 8)
        clean = np.nansum(jm_t.flux_ff(freqs), axis=(1, 2))
        rng = np.random.default_rng(5)
        noisy = clean * np.exp(rng.normal(0, 0.02, clean.shape))

        jm = JetModel(p)
        jm.time = 0.0
        free = ('properties.mlr_bj', 'properties.T_0')
        res = jfit.fit_sed(jm, freqs, noisy, free=free, steps=400,
                           learning_rate=0.05)
        fwd, _ = jfit.build_sed_forward(jm, freqs, free)
        sig, cov = jfit.laplace_uncertainties(fwd, res.theta, noisy, free)
        post = jfit.sample_posterior(fwd, res.theta, noisy, free, cov=cov,
                                     steps=3000, burn=500, seed=1,
                                     chains=2)
        assert 0.3 < post.acceptance <= 1.0
        for path in free:
            s = post.samples[path]
            assert abs(s.mean() - res.values[path]) < 3 * sig[path]
            assert s.std() == pytest.approx(sig[path], rel=0.3)
            assert post.r_hat[path] < 1.05   # split-R-hat converged

    def test_grid_refine_recovers_inclination(self, model_params):
        # the recommended recipe for mask-moving geometry: coarse grid
        # over inc + gradient refinement of mlr at each node
        p = _small(model_params)
        pt = copy.deepcopy(p)
        pt['geometry']['inc'] = 70.
        pt['properties']['mlr_bj'] = 2e-7
        jm_true = JetModel(pt)
        jm_true.time = 0.0
        obs = np.nansum(jm_true.flux_ff(SED_FREQS), axis=(1, 2))

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_grid_refine(
            jm, SED_FREQS, obs, grid={'geometry.inc': [50., 70., 90.]},
            free=('properties.mlr_bj',), steps=250, learning_rate=0.05)
        assert res.node['geometry.inc'] == 70.
        assert res.best.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=1e-3)
        assert len(res.table) == 3
        losses = dict((n['geometry.inc'], l) for n, l in res.table)
        assert losses[70.] < losses[50.] and losses[70.] < losses[90.]

    def test_visibility_fit_recovers_params_under_noise(self, model_params):
        # uv-plane model fitting: recover mlr/T_0 directly from noisy
        # complex visibilities (no imaging in the loop)
        p = _small(model_params)
        rng = np.random.default_rng(3)
        uvw = rng.normal(0, 2e4, (300, 3))
        freqs = np.array([1e11, 3e11])
        true = copy.deepcopy(p)
        true['properties'].update(mlr_bj=2e-7, T_0=7000.)
        jm_t = JetModel(true)
        jm_t.time = 0.0
        fwd_t, th_t = jfit.build_vis_forward(jm_t, freqs, uvw,
                                             ('properties.mlr_bj',))
        vis = np.asarray(fwd_t(th_t))
        sigma = 0.02 * np.abs(vis).max()
        vis = vis + (rng.normal(0, sigma, vis.shape) +
                     1j * rng.normal(0, sigma, vis.shape))

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_visibilities(
            jm, freqs, uvw, vis, sigma=sigma,
            free=('properties.mlr_bj', 'properties.T_0'),
            steps=400, learning_rate=0.05)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=0.02)
        assert res.values['properties.T_0'] == pytest.approx(7000., rel=0.02)
        # converged loss sits at the chi-squared noise floor:
        # E[(re^2 + im^2)/sigma^2] = 2 per visibility
        assert 1.0 < res.loss[-1] < 3.0 < res.loss[0]

    def test_visibility_fit_through_wstack_forward(self, model_params):
        # wide-field data: the w-stacked (differentiable) forward recovers
        # a parameter from visibilities generated by the same measurement
        # equation; gradients flow through the per-plane FFT scan
        p = _small(model_params)
        rng = np.random.default_rng(5)
        uvw = np.stack([rng.normal(0, 2e4, 200),
                        rng.normal(0, 2e4, 200),
                        rng.uniform(-5e6, 5e6, 200)], axis=1)
        freqs = np.array([1e11, 3e11])
        true = copy.deepcopy(p)
        true['properties'].update(mlr_bj=2e-7)
        jm_t = JetModel(true)
        jm_t.time = 0.0
        fwd_t, th_t = jfit.build_vis_forward(
            jm_t, freqs, uvw, ('properties.mlr_bj',), w_planes=4)
        vis = np.asarray(fwd_t(th_t))
        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_visibilities(
            jm, freqs, uvw, vis, free=('properties.mlr_bj',),
            steps=150, learning_rate=0.05, w_planes=4)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=0.02)

    def test_fit_from_uvfits_file(self, model_params, tmp_path):
        # the measurement-set workflow: visibilities land in a standard
        # UVFITS file (export_uvfits / real observed data) and fit_uvfits
        # recovers parameters straight from the file, using its weights
        from rajepy_tpu.synthobs import uvfits
        p = _small(model_params)
        rng = np.random.default_rng(7)
        n_ant = 25                       # 25*24/2 = 300 baselines
        i, j = np.triu_indices(n_ant, k=1)
        uvw = rng.normal(0, 2e4, (i.size, 3))
        freqs = np.array([1e11, 3e11])
        true = copy.deepcopy(p)
        true['properties'].update(mlr_bj=2e-7)
        jm_t = JetModel(true)
        jm_t.time = 0.0
        fwd_t, th_t = jfit.build_vis_forward(jm_t, freqs, uvw,
                                             ('properties.mlr_bj',))
        vis = np.asarray(fwd_t(th_t))
        sigma = 0.02 * np.abs(vis).max()
        vis = vis + (rng.normal(0, sigma, vis.shape) +
                     1j * rng.normal(0, sigma, vis.shape))
        fn = uvfits.write_uvfits(
            str(tmp_path / 'obs.uvfits'), uvw, vis.real, vis.imag,
            freqs, rng.normal(0, 1e4, (n_ant, 3)), i, j,
            np.full(i.size, 30.0), ra_deg=100.0, dec_deg=20.0,
            sigma=sigma)

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_uvfits(jm, fn, free=('properties.mlr_bj',),
                              steps=200, learning_rate=0.05)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=0.02)
        # the file's weights reproduce the chi-squared noise floor
        assert 1.0 < res.loss[-1] < 3.0

    def test_visibility_fit_rejects_dist(self, model_params):
        jm = JetModel(_small(model_params))
        with pytest.raises(ValueError, match="pixel scale"):
            jfit.build_vis_forward(jm, np.array([1e11]),
                                   np.zeros((4, 3)), ('target.dist',))

    def test_light_curve_joint_two_burst_recovery(self, model_params):
        # two overlapping bursts fitted jointly (6 free parameters)
        p = _small(model_params)
        pt = copy.deepcopy(p)
        pt['ejection'] = {'t_0': np.array([1.0, 2.2]),
                          'hl': np.array([0.3, 0.5]),
                          'chi': np.array([3.0, 5.0]),
                          'which': np.array(['B', 'B'])}
        jm_true = JetModel(pt)
        times = np.linspace(0.4, 4.5, 18) * YEAR
        freqs = np.array([4.4e10])
        obs = []
        for t in times:
            jm_true.time = t
            obs.append(np.nansum(jm_true.flux_ff(freqs), axis=(1, 2)))
        obs = np.asarray(obs)

        pg = copy.deepcopy(p)
        pg['ejection'] = {'t_0': np.array([0.8, 2.6]),
                          'hl': np.array([0.45, 0.35]),
                          'chi': np.array([2.0, 3.5]),
                          'which': np.array(['B', 'B'])}
        res = jfit.fit_light_curve(JetModel(pg), times, freqs, obs,
                                   steps=1500, learning_rate=0.02)
        assert res.t_0 == pytest.approx([1.0, 2.2], abs=5e-3)
        assert res.hl == pytest.approx([0.3, 0.5], rel=2e-2)
        assert res.chi == pytest.approx([3.0, 5.0], rel=2e-2)

    def test_rrl_spectrum_recovers_temperature_and_velocity(
            self, model_params):
        # the two classic line-profile observables: Doppler width -> T_0,
        # centroid -> systemic velocity.  A continuum SED cannot separate
        # either; the line profile pins both to optimiser precision.
        p = _small(model_params)
        nu0 = _H58A_NU0
        freqs = nu0 * (1.0 + np.linspace(-4e-4, 4e-4, 17))
        pt = copy.deepcopy(p)
        true_t0 = p['properties']['T_0'] * 0.7
        true_v = 25.0
        pt['properties']['T_0'] = true_t0
        pt['target']['v_lsr'] = true_v
        jm_true = JetModel(pt)
        jm_true.time = 2.0 * YEAR
        obs = np.nansum(jm_true.flux_rrl('H58a', freqs, contsub=True),
                        axis=(1, 2))

        jm = JetModel(p)
        jm.time = 2.0 * YEAR
        res = jfit.fit_rrl_spectrum(jm, 'H58a', freqs, obs, steps=700,
                                    learning_rate=0.2)
        assert res.values['properties.T_0'] == pytest.approx(true_t0,
                                                             rel=1e-4)
        assert res.values['target.v_lsr'] == pytest.approx(true_v,
                                                           abs=1e-3)
        assert res.loss[-1] < 1e-12 < res.loss[0]

    def test_multi_start_matches_and_deepens_single_start(
            self, model_params):
        # n_starts > 1 runs vmapped optimiser chains in one program and
        # keeps the best final loss — never worse than the single start,
        # same recovered values; with a mesh the starts axis shards
        # across devices
        from rajepy_tpu.parallel import sharding as _sh
        p = _small(model_params)
        pt = copy.deepcopy(p)
        true_mlr = p['properties']['mlr_bj'] * 2.5
        pt['properties']['mlr_bj'] = true_mlr
        jm_true = JetModel(pt)
        jm_true.time = 2.0 * YEAR
        obs = np.nansum(jm_true.flux_ff(SED_FREQS), axis=(1, 2))

        jm = JetModel(p)
        jm.time = 2.0 * YEAR
        kw = dict(free=('properties.mlr_bj',), steps=250,
                  learning_rate=0.05)
        res1 = jfit.fit_sed(jm, SED_FREQS, obs, **kw)
        res4 = jfit.fit_sed(jm, SED_FREQS, obs, n_starts=4, **kw)
        assert res4.loss[-1] <= res1.loss[-1] * (1 + 1e-9)
        assert res4.values['properties.mlr_bj'] == \
            pytest.approx(true_mlr, rel=1e-3)
        # sharded over the virtual mesh (starts pad 5 -> 8 on 'chan')
        mesh = _sh.make_mesh(n_los=1, n_chan=8)
        res_m = jfit.fit_sed(jm, SED_FREQS, obs, n_starts=5, mesh=mesh,
                             **kw)
        assert res_m.values['properties.mlr_bj'] == \
            pytest.approx(true_mlr, rel=1e-3)

    def test_joint_sed_plus_line_breaks_degeneracy(self, model_params):
        # one theta fitted against two observables at once: the SED
        # constrains the density (v_lsr-blind — its gradient through the
        # continuum is exactly zero), the line profile pins temperature
        # and velocity; jointly all three recover
        p = _small(model_params)
        line_freqs = _H58A_NU0 * (1.0 + np.linspace(-4e-4, 4e-4, 13))
        pt = copy.deepcopy(p)
        true_mlr = p['properties']['mlr_bj'] * 2.0
        pt['properties'].update(mlr_bj=true_mlr, T_0=7000.0)
        pt['target']['v_lsr'] = 20.0
        jm_t = JetModel(pt)
        jm_t.time = 2.0 * YEAR
        sed_obs = np.nansum(jm_t.flux_ff(SED_FREQS), axis=(1, 2))
        line_obs = np.nansum(jm_t.flux_rrl('H58a', line_freqs,
                                           contsub=True), axis=(1, 2))

        jm = JetModel(p)
        jm.time = 2.0 * YEAR
        res = jfit.fit_joint(
            jm,
            [{'kind': 'sed', 'freqs': SED_FREQS, 'observed': sed_obs},
             {'kind': 'rrl_spectrum', 'line': 'H58a',
              'freqs': line_freqs, 'observed': line_obs}],
            free=('properties.mlr_bj', 'properties.T_0',
                  'target.v_lsr'),
            steps=700, learning_rate=0.2)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(true_mlr, rel=1e-4)
        assert res.values['properties.T_0'] == pytest.approx(7000.0,
                                                             rel=1e-4)
        assert res.values['target.v_lsr'] == pytest.approx(20.0,
                                                           abs=1e-3)
        assert isinstance(res.model, tuple) and len(res.model) == 2
        assert res.model[0].shape == (len(SED_FREQS),)
        assert res.model[1].shape == (len(line_freqs),)

    def test_joint_unknown_kind_raises(self, model_params):
        jm = JetModel(_small(model_params))
        with pytest.raises(ValueError, match="unknown joint-fit"):
            jfit.fit_joint(jm, [{'kind': 'nope', 'observed': [1.0]}])

    def test_rrl_cube_recovers_velocity_law(self, model_params):
        # position-velocity structure: at off-axis inclination the jet's
        # LOS velocity shifts the line differentially along the axis, so
        # a resolved channel cube pins v_0 — which the spatially-
        # integrated spectrum (red/blue blended) cannot separate
        p = _small(model_params)
        p['geometry'].update(inc=60., pa=0.)
        freqs = _H58A_NU0 * (1.0 + np.linspace(-1.5e-3, 1.5e-3, 15))
        pt = copy.deepcopy(p)
        true_v0 = p['properties']['v_0'] * 1.5
        pt['properties']['v_0'] = true_v0
        jm_true = JetModel(pt)
        jm_true.time = 2.0 * YEAR
        obs = np.nan_to_num(jm_true.flux_rrl('H58a', freqs, contsub=True))

        jm = JetModel(p)
        jm.time = 2.0 * YEAR
        res = jfit.fit_rrl_cube(
            jm, 'H58a', freqs, obs,
            free=('properties.T_0', 'properties.v_0'),
            steps=500, learning_rate=0.1)
        assert res.values['properties.v_0'] == pytest.approx(true_v0,
                                                             rel=1e-4)
        assert res.values['properties.T_0'] == pytest.approx(
            p['properties']['T_0'], rel=1e-4)
        assert res.loss[-1] < 1e-14 < res.loss[0]

    def test_light_curve_forward_handles_rb_burst(self, model_params):
        # a 'RB' burst contributes to both jets; the forward at theta0
        # must match the public API light curve exactly
        p = _small(model_params)
        p['ejection'] = {'t_0': np.array([1.0]), 'hl': np.array([0.3]),
                         'chi': np.array([3.0]),
                         'which': np.array(['RB'])}
        jm = JetModel(p)
        times = np.array([0.8, 1.2, 2.0]) * YEAR
        freqs = np.array([4.4e10])
        fwd, th0, _ = jfit.build_light_curve_forward(jm, times, freqs)
        ours = np.asarray(fwd(th0))
        api = []
        for t in times:
            jm.time = t
            api.append(np.nansum(jm.flux_ff(freqs), axis=(1, 2)))
        assert ours == pytest.approx(np.asarray(api), rel=1e-12)


class TestClosureFitting:
    def test_closure_fit_is_gain_robust(self, model_params):
        """fit_closures recovers the truth from severely uncalibrated
        visibilities where fit_visibilities converges to a biased
        optimum (closure quantities are exactly gain-immune)."""
        from rajepy_tpu.synthobs import calibration as cal
        p = _small(model_params)
        rng = np.random.default_rng(3)
        n_ant, n_t = 8, 6
        pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
        a1, a2, tix = cal.vis_metadata(n_t, pairs)
        uvw = rng.normal(0, 2e4, (n_t * pairs.shape[0], 3))
        freqs = np.array([5e9, 2.2e10])   # partially optically thick:
        # mlr moves the tau=1 surface, so closures SEE it (closures are
        # blind to pure flux rescaling)
        true = copy.deepcopy(p)
        true['properties'].update(mlr_bj=2e-7)
        jm_t = JetModel(true)
        jm_t.time = 0.0
        fwd, th = jfit.build_vis_forward(jm_t, freqs, uvw,
                                         ('properties.mlr_bj',))
        vis = np.asarray(fwd(th))
        # severe uncalibrated antenna gains: iid 80-deg phases, 30% amps
        g_re, g_im = cal.simulate_gain_errors(7, n_t, n_ant, amp_rms=0.3,
                                              phase_rms_deg=80.0)
        cr, ci = cal.apply_gains(vis.real, vis.imag, g_re, g_im,
                                 a1, a2, tix)
        vis_corr = np.asarray(cr) + 1j * np.asarray(ci)

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_closures(jm, freqs, uvw, vis_corr, n_ant=n_ant,
                                n_t=n_t, free=('properties.mlr_bj',),
                                steps=300)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=1e-3)

        jm2 = JetModel(copy.deepcopy(p))
        jm2.time = 0.0
        res2 = jfit.fit_visibilities(jm2, freqs, uvw, vis_corr,
                                     free=('properties.mlr_bj',),
                                     steps=300)
        err_vis = abs(res2.values['properties.mlr_bj'] / 2e-7 - 1)
        assert err_vis > 0.3   # the uncalibrated fit is badly biased

    def test_closure_fit_validates_layout(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 0.0
        with pytest.raises(ValueError, match='time-major'):
            jfit.fit_closures(jm, np.array([1e10]), np.zeros((10, 3)),
                              np.zeros((1, 10), complex), n_ant=8,
                              n_t=6)
        with pytest.raises(ValueError, match='at least one'):
            jfit.fit_closures(jm, np.array([1e10]), np.zeros((168, 3)),
                              np.zeros((1, 168), complex), n_ant=8,
                              n_t=6, use_phases=False,
                              use_log_amps=False)


class TestJointClosures:
    def test_joint_sed_plus_closures_from_uncalibrated_vis(self,
                                                           model_params):
        """A 'closures' component in fit_joint: uncalibrated
        visibilities contribute their gain-immune structure constraint
        while an SED component pins the absolute flux scale closures
        cannot see — two free parameters recovered from data whose
        gains are 80 deg wrong."""
        from rajepy_tpu.synthobs import calibration as cal
        p = _small(model_params)
        rng = np.random.default_rng(9)
        n_ant, n_t = 8, 6
        pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
        a1, a2, tix = cal.vis_metadata(n_t, pairs)
        uvw = rng.normal(0, 2e4, (n_t * pairs.shape[0], 3))
        vis_freqs = np.array([5e9, 2.2e10])
        pt = copy.deepcopy(p)
        pt['properties'].update(mlr_bj=2e-7, T_0=7000.0)
        jm_t = JetModel(pt)
        jm_t.time = 0.0
        sed_obs = np.nansum(jm_t.flux_ff(SED_FREQS), axis=(1, 2))
        fwd, th = jfit.build_vis_forward(jm_t, vis_freqs, uvw,
                                         ('properties.mlr_bj',))
        vis = np.asarray(fwd(th))
        g_re, g_im = cal.simulate_gain_errors(4, n_t, n_ant,
                                              amp_rms=0.3,
                                              phase_rms_deg=80.0)
        cr, ci = cal.apply_gains(vis.real, vis.imag, g_re, g_im,
                                 a1, a2, tix)
        vis_corr = np.asarray(cr) + 1j * np.asarray(ci)

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_joint(
            jm,
            [{'kind': 'sed', 'freqs': SED_FREQS, 'observed': sed_obs},
             {'kind': 'closures', 'freqs': vis_freqs, 'uvw_m': uvw,
              'observed': vis_corr, 'n_ant': n_ant, 'n_t': n_t}],
            free=('properties.mlr_bj', 'properties.T_0'),
            steps=500, learning_rate=0.1)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=0.01)
        assert res.values['properties.T_0'] == \
            pytest.approx(7000.0, rel=0.01)


class TestJointMultiEpoch:
    def test_per_component_time_overrides(self, model_params):
        """Components may carry their own epochs: two SEDs bracketing an
        ejection burst fit one parameter vector, each evaluated at its
        own time (the burst brightens epoch 2 only)."""
        p = _small(model_params)
        p['ejection'] = {'t_0': np.array([1.5]), 'hl': np.array([0.5]),
                         'chi': np.array([4.0]), 'which': np.array(['R'])}
        pt = copy.deepcopy(p)
        pt['properties'].update(mlr_bj=2e-7)
        jm_t = JetModel(pt)
        jm_t.time = 0.0
        sed0 = np.nansum(jm_t.flux_ff(SED_FREQS), axis=(1, 2))
        jm_t.time = 2.0 * YEAR
        sed2 = np.nansum(jm_t.flux_ff(SED_FREQS), axis=(1, 2))
        assert np.all(sed2 > sed0)      # the burst is inside at 2 yr

        jm = JetModel(p)
        res = jfit.fit_joint(
            jm,
            [{'kind': 'sed', 'freqs': SED_FREQS, 'observed': sed0,
              'time': 0.0},
             {'kind': 'sed', 'freqs': SED_FREQS, 'observed': sed2,
              'time': 2.0 * YEAR}],
            free=('properties.mlr_bj',), steps=300, learning_rate=0.1)
        assert res.values['properties.mlr_bj'] == \
            pytest.approx(2e-7, rel=1e-3)
        # each component really saw its own epoch
        m0, m2 = (np.asarray(m) for m in res.model)
        assert np.all(m2 > m0)


class TestClosureUncertainties:
    def test_sigma_covers_noise_driven_error(self, model_params):
        """Laplace error bars on a gain-robust fit: with thermal noise
        on the uncalibrated visibilities, the closure fit's deviation
        from truth is consistent with the reported 1-sigma."""
        from rajepy_tpu.synthobs import calibration as cal
        p = _small(model_params)
        rng = np.random.default_rng(13)
        n_ant, n_t = 8, 6
        pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
        a1, a2, tix = cal.vis_metadata(n_t, pairs)
        uvw = rng.normal(0, 2e4, (n_t * pairs.shape[0], 3))
        freqs = np.array([5e9, 2.2e10])
        true = copy.deepcopy(p)
        true['properties'].update(mlr_bj=2e-7)
        jm_t = JetModel(true)
        jm_t.time = 0.0
        fwd, th = jfit.build_vis_forward(jm_t, freqs, uvw,
                                         ('properties.mlr_bj',))
        vis = np.asarray(fwd(th))
        sigma_n = 0.01 * np.abs(vis).max()
        vis = vis + (rng.normal(0, sigma_n, vis.shape) +
                     1j * rng.normal(0, sigma_n, vis.shape))
        g_re, g_im = cal.simulate_gain_errors(2, n_t, n_ant, amp_rms=0.3,
                                              phase_rms_deg=80.0)
        cr, ci = cal.apply_gains(vis.real, vis.imag, g_re, g_im,
                                 a1, a2, tix)
        vis_corr = np.asarray(cr) + 1j * np.asarray(ci)

        jm = JetModel(p)
        jm.time = 0.0
        res = jfit.fit_closures(jm, freqs, uvw, vis_corr, n_ant=n_ant,
                                n_t=n_t, free=('properties.mlr_bj',),
                                steps=300)
        sig, cov = jfit.closure_uncertainties(
            jm, freqs, uvw, vis_corr, res.theta,
            ('properties.mlr_bj',), n_ant=n_ant, n_t=n_t)
        s = sig['properties.mlr_bj']
        err = abs(res.values['properties.mlr_bj'] - 2e-7)
        assert 0 < s < 0.2 * 2e-7          # informative error bar
        assert err < 4 * s                 # deviation consistent with it
        assert cov.shape == (1, 1)


class TestReviewRegressionsR3S6:
    """Pins for the third round-3 session-6 review batch."""

    def test_closure_small_arrays_guarded(self, model_params):
        """n_ant=3 has no quadrangles: log closure amplitudes must raise
        a clear error (the empty (0,) index arrays used to crash with
        IndexError, and an empty mean would return NaN loss)."""
        jm = JetModel(_small(model_params))
        uvw = np.random.default_rng(0).normal(size=(3, 3)) * 1e3
        vis = np.ones(3, complex)
        with pytest.raises(ValueError, match='n_ant >= 4'):
            jfit.fit_closures(jm, [6e9], uvw, vis[None], n_ant=3, n_t=1,
                              free=('properties.mlr_bj',), steps=1)
        # triangles exist at n_ant=3: phases-only must build fine
        from rajepy_tpu.synthobs import calibration as cal
        ix = cal.closure_index_arrays(3)
        assert ix['tri'][0].shape == (1,)
        assert ix['quad'][0].shape == (0,)
        b = cal.bisp_core(jnp.asarray(vis)[None], *ix['tri'])
        assert b.shape == (1, 1)

    def test_light_curve_errors_broadcast(self, model_params):
        """1-D per-time errors must weight each point by its own error
        (they used to broadcast the residual to an (n_t, n_t) outer
        matrix)."""
        p = _small(model_params)
        p['ejection'] = {'t_0': np.array([0.5]), 'hl': np.array([0.1]),
                         'chi': np.array([3.0]),
                         'which': np.array(['B'])}
        jm = JetModel(p)
        times = np.linspace(0.3, 0.9, 5) * YEAR
        from rajepy_tpu.models import analysis
        obs = analysis.light_curve(jm, times / YEAR, [6e9])[:, 0]
        err = np.full(5, 0.05 * obs.max())
        res = jfit.fit_light_curve(jm, times, [6e9], obs, errors=err,
                                   steps=5)
        # loss history must be scalar-per-step and finite (an (n,n)
        # broadcast residual still reduces to a scalar via mean, so pin
        # the loss VALUE against the correct per-point form instead)
        fwd, th0, _ = jfit.build_light_curve_forward(jm, times, [6e9],
                                                     ('t_0',))
        model0 = np.asarray(fwd(th0))
        expect = np.mean(((model0 - obs[:, None]) / err[:, None]) ** 2)
        from rajepy_tpu.fit import _sed_loss
        got = float(_sed_loss(jnp.asarray(obs[:, None]), err[:, None])(
            jnp.asarray(model0)))
        np.testing.assert_allclose(got, expect, rtol=1e-12)
        assert np.isfinite(res.loss).all()
        # 2-D observed keeps errors as given: per-channel (n_chan,)
        # sigmas broadcast per channel (the 1-D reshape must not touch
        # them — review r3s6 follow-up)
        from rajepy_tpu.models import analysis
        obs2 = analysis.light_curve(jm, times / YEAR, [6e9, 2.2e10])
        err2 = np.array([1.0, 2.0]) * 0.05 * obs2.max()
        res2 = jfit.fit_light_curve(jm, times, [6e9, 2.2e10], obs2,
                                    errors=err2, steps=3)
        assert np.isfinite(res2.loss).all()

    def test_freed_q_t_uses_smooth_gaunt(self, model_params):
        """Freeing power_laws.q_T from the q_T=0 default must not freeze
        the van Hoof gaunt branch: the forward at a moved q_T must match
        a JetModel built at that q_T (which uses the Reynolds form)."""
        p = _small(model_params)
        jm = JetModel(p)
        fwd, th0 = jfit.build_flux_forward(jm, [6e9],
                                           ('power_laws.q_T',))
        q_t_new = 0.4
        model = np.asarray(fwd(jnp.asarray([q_t_new])))[0]
        p2 = _small(model_params)
        p2['power_laws']['q_T'] = q_t_new
        jm2 = JetModel(p2)
        ref = np.nan_to_num(np.asarray(jm2.flux_ff(6e9)), nan=0.0)
        np.testing.assert_allclose(model, ref, rtol=1e-9, atol=1e-30)

    def test_imfit_all_nan_returns_none(self):
        from rajepy_tpu.synthobs.imfit import fit_gaussian
        assert fit_gaussian(np.full((8, 8), np.nan)) is None


class TestSweep:
    """Batched parameter surveys (fit.sweep): one compiled program over
    the combo axis — vs per-combo forward calls as the oracle."""

    def test_sed_product_matches_pointwise(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        grid = {'properties.mlr_bj': np.array([5e-8, 1e-7, 2e-7]),
                'properties.T_0': np.array([8e3, 1.2e4])}
        res = jfit.sweep(jm, SED_FREQS, grid)
        assert res.values.shape == (6, SED_FREQS.size)
        assert res.shape == (3, 2)
        assert res.reshaped().shape == (3, 2, SED_FREQS.size)
        # oracle: the single-theta forward at each combo
        fwd, _ = jfit.build_sed_forward(jm, SED_FREQS,
                                        ('properties.mlr_bj',
                                         'properties.T_0'))
        for i in range(6):
            th = jnp.asarray([np.log(res.points['properties.mlr_bj'][i]),
                              np.log(res.points['properties.T_0'][i])])
            want = np.asarray(jax.jit(fwd)(th))
            np.testing.assert_allclose(res.values[i], want, rtol=1e-12)
        # flux increases with mlr at the optically-thin channel
        cube = res.reshaped()
        assert (np.diff(cube[:, 0, -1]) > 0).all()

    def test_zip_chunked_and_map_kind(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        grid = {'properties.mlr_bj': np.array([5e-8, 1e-7, 2e-7, 4e-7,
                                               8e-7]),
                'geometry.inc': np.array([90., 80., 70., 60., 50.])}
        res = jfit.sweep(jm, SED_FREQS[:2], grid, product=False,
                         batch_size=2)
        assert res.values.shape == (5, 2)
        res_nb = jfit.sweep(jm, SED_FREQS[:2], grid, product=False)
        np.testing.assert_allclose(res.values, res_nb.values, rtol=1e-12)
        with pytest.raises(ValueError):
            jfit.sweep(jm, SED_FREQS[:2],
                       {'properties.mlr_bj': np.array([1e-7]),
                        'geometry.inc': np.array([80., 70.])},
                       product=False)
        m = jfit.sweep(jm, SED_FREQS[:1],
                       {'properties.T_0': np.array([1e4, 2e4])},
                       kind='map')
        assert m.values.shape == (2, 1, jm.nx, jm.nz)
        np.testing.assert_allclose(m.values.sum(axis=(2, 3))[:, 0],
                                   jfit.sweep(jm, SED_FREQS[:1],
                                              {'properties.T_0':
                                               np.array([1e4, 2e4])}
                                              ).values[:, 0], rtol=1e-10)

    def test_sharded_combo_axis(self, model_params):
        if jax.device_count() < 8:
            pytest.skip("needs xla_force_host_platform_device_count=8")
        from rajepy_tpu.parallel import sharding
        mesh = sharding.make_mesh(n_los=1, n_chan=8)
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        grid = {'properties.mlr_bj': np.geomspace(5e-8, 5e-7, 6)}
        seq = jfit.sweep(jm, SED_FREQS[:2], grid)
        shd = jfit.sweep(jm, SED_FREQS[:2], grid, mesh=mesh)
        np.testing.assert_allclose(shd.values, seq.values, rtol=1e-10)

    def test_sharded_and_chunked(self, model_params):
        if jax.device_count() < 8:
            pytest.skip("needs xla_force_host_platform_device_count=8")
        from rajepy_tpu.parallel import sharding
        mesh = sharding.make_mesh(n_los=1, n_chan=8)
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        grid = {'properties.mlr_bj': np.geomspace(5e-8, 5e-7, 10)}
        seq = jfit.sweep(jm, SED_FREQS[:2], grid)
        both = jfit.sweep(jm, SED_FREQS[:2], grid, mesh=mesh,
                          batch_size=3)   # rounded up to 8/dev multiple
        np.testing.assert_allclose(both.values, seq.values, rtol=1e-10)


class TestNonLTEFitting:
    """Freeing the G&S departure coefficients: observed stimulated
    amplification becomes a fittable quantity (the reference has no
    non-LTE mode at all, let alone its inverse problem)."""

    def test_nonlte_forward_matches_flux_rrl(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 5))
        bpair = (0.93, 0.97)
        fwd, th0 = jfit.build_rrl_spectrum_forward(
            jm, 'H58a', freqs, ('properties.T_0',), lte=False,
            departure_coeffs=bpair)
        ours = np.asarray(fwd(th0))
        api = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                    departure_coeffs=bpair),
                        axis=(1, 2))
        assert ours == pytest.approx(api, rel=1e-12)

    def test_recover_b_n2(self, model_params):
        """Synthesise an amplified profile at known (b_n1, b_n2); free
        b_n2 (b_n1 pinned — the two are near-degenerate in a single
        profile) and recover it."""
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 7))
        b_true = (0.95, 0.985)
        obs = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                    departure_coeffs=b_true),
                        axis=(1, 2))
        res = jfit.fit_rrl_spectrum(
            jm, 'H58a', freqs, obs, free=('nonlte.b_n2',), lte=False,
            departure_coeffs=(0.95, 0.95),   # start b_n2 wrong
            steps=300, learning_rate=0.01)
        got = res.values['nonlte.b_n2']
        assert got == pytest.approx(0.985, abs=2e-3), got
        # theta0 for a freed coefficient starts at the supplied value
        _, th0 = jfit.build_rrl_spectrum_forward(
            jm, 'H58a', freqs, ('nonlte.b_n2', 'properties.T_0'),
            lte=False, departure_coeffs=(0.9, 0.8))
        assert float(np.exp(th0[0])) == pytest.approx(0.8, rel=1e-12)
        # param_dict skips the pseudo path (result stays JetModel-able)
        pd = res.param_dict(jm.params)
        assert 'nonlte' not in pd

    def test_nonlte_free_rejected_outside_rrl(self, model_params):
        jm = JetModel(_small(model_params))
        with pytest.raises(ValueError, match="only meaningful"):
            jfit.build_sed_forward(jm, SED_FREQS, ('nonlte.b_n2',))

    def test_departure_systematic_propagation(self, model_params):
        """The b_n table's rate-prescription band propagates into fit
        errors (r4 review item 1): synthesise the observation with the
        'hi' rate-band-edge coefficients (truth at the edge of the
        systematic band), fit T_0 with the table-central ones, and check
        rrl_departure_systematic BRACKETS the real parameter bias — the
        bias the statistical sigma alone underestimates severalfold."""
        p = _small(model_params)
        # optically thin jet: characteristic n_e ~ 2e4 cm^-3 where the
        # table systematic is a few percent of b (dense jets pin b = 1
        # at every rate scale and the systematic vanishes)
        p['properties'].update(mlr_bj=1e-10, mlr_rj=5e-11)
        p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                         'chi': np.array([]), 'which': np.array([])}
        line, free = 'H58a', ('properties.T_0',)
        freqs = _H58A_NU0 + np.linspace(-6e6, 6e6, 17)
        jm_t = JetModel(copy.deepcopy(p))
        jm_t.time = 0.0
        b_hi = jm_t.departure_coefficients_at_scale(line, 'hi')
        b_c = jm_t.departure_coefficients(line)
        assert b_hi[0] > b_c[0]         # the band edge is a real shift
        fwd_t, th_t = jfit.build_rrl_spectrum_forward(
            jm_t, line, freqs, free, lte=False, departure_coeffs=b_hi)
        obs = np.asarray(fwd_t(th_t))

        jm = JetModel(copy.deepcopy(p))
        jm.time = 0.0
        res = jfit.fit_rrl_spectrum(jm, line, freqs, obs, free=free,
                                    steps=200, learning_rate=0.05,
                                    lte=False)
        bias = abs(res.values['properties.T_0'] - 1e4)
        assert bias > 50.0              # the systematic is REAL
        sys = jfit.rrl_departure_systematic(jm, line, freqs, res.theta,
                                            free)
        s = sys['properties.T_0']
        # first-order propagation brackets the actual bias
        assert 0.5 * bias < s < 4.0 * bias
        # ...and dominates the statistical sigma of this noiseless fit
        fwd_c, _ = jfit.build_rrl_spectrum_forward(
            jm, line, freqs, free, lte=False, departure_coeffs=b_c)
        stat, _ = jfit.laplace_uncertainties(fwd_c, res.theta, obs, free)
        assert s > 2.0 * stat['properties.T_0']

    def test_departure_systematic_rejects_freed_coefficients(
            self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 0.0
        freqs = _H58A_NU0 + np.linspace(-6e6, 6e6, 5)
        with pytest.raises(ValueError, match="FREE parameter"):
            jfit.rrl_departure_systematic(
                jm, 'H58a', freqs, np.zeros(1), ('nonlte.b_n2',))

    def test_departure_systematic_dense_jet(self, model_params):
        """Dense (thermalised) jet: each b is pinned to 1 at every rate
        scale (per-LEVEL systematic < 1e-3) — yet the propagated T_0
        systematic does NOT vanish, because the G&S beta amplification
        divides the level DIFFERENCE (b_n2 - b_n1) by h nu / k T ~ 1e-4
        and that difference keeps its ~50% rate-scale spread.  The
        honest contract: non-LTE T_0 carries a few-percent rate-model
        systematic even where b ~ 1."""
        p = _small(model_params)
        p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                         'chi': np.array([]), 'which': np.array([])}
        jm = JetModel(p)
        jm.time = 0.0
        s1, s2 = jm.departure_coefficient_systematic('H58a')
        assert s1 < 2e-3 and s2 < 2e-3     # per-level pinning holds
        freqs = _H58A_NU0 + np.linspace(-6e6, 6e6, 9)
        fwd, th0 = jfit.build_rrl_spectrum_forward(
            jm, 'H58a', freqs, ('properties.T_0',), lte=False,
            departure_coeffs=jm.departure_coefficients('H58a'))
        sys = jfit.rrl_departure_systematic(
            jm, 'H58a', freqs, th0, ('properties.T_0',))
        # measured ~700 K (7%) at r5; pin the order of magnitude
        assert 100.0 < sys['properties.T_0'] < 3000.0

    def test_map_departure_coeffs_accepted(self, model_params):
        """departure_coefficient_maps output is a documented
        departure_coeffs= input: the fit forwards must take the
        per-sightline maps, matching JetModel's own non-LTE API."""
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 5))
        b1m, b2m = jm.departure_coefficient_maps('H58a')
        fwd, th0 = jfit.build_rrl_spectrum_forward(
            jm, 'H58a', freqs, ('properties.T_0',), lte=False,
            departure_coeffs=(b1m, b2m))
        ours = np.asarray(fwd(th0))
        api = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                    departure_coeffs=(b1m, b2m)),
                        axis=(1, 2))
        assert ours == pytest.approx(api, rel=1e-12)
        # freeing a coefficient whose own starting value is a map is
        # ill-posed (theta is scalar) and refused loudly
        with pytest.raises(ValueError, match="SCALAR"):
            jfit.build_rrl_spectrum_forward(
                jm, 'H58a', freqs, ('nonlte.b_n2',), lte=False,
                departure_coeffs=(b1m, b2m))
        # ...but freeing the OTHER (scalar) coefficient while a map is
        # held fixed is well-posed and must work
        fwd2, th02 = jfit.build_rrl_spectrum_forward(
            jm, 'H58a', freqs, ('nonlte.b_n1',), lte=False,
            departure_coeffs=(0.95, b2m))
        ours2 = np.asarray(fwd2(th02))
        api2 = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                     departure_coeffs=(0.95, b2m)),
                         axis=(1, 2))
        assert ours2 == pytest.approx(api2, rel=1e-12)
        # mis-shaped arrays are refused instead of broadcasting silently
        with pytest.raises(ValueError, match=r"\(nx, nz\)"):
            jfit.build_rrl_spectrum_forward(
                jm, 'H58a', freqs, ('properties.T_0',), lte=False,
                departure_coeffs=(np.ones(jm.nz), b2m))
        with pytest.raises(ValueError, match=r"\(nx, nz\)"):
            jfit.build_rrl_spectrum_forward(
                jm, 'H58a', freqs, ('properties.T_0',), lte=False,
                departure_coeffs=(b1m.T[:, :-1], b2m))

    def test_sweep_nonlte_b_n2(self, model_params):
        """sweep accepts the nonlte pseudo-paths for RRL-spectrum
        surveys (they are SUPPORTED_FREE members; the docstring says
        any of them sweep)."""
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 5))
        b1_fix, _ = jm.departure_coefficients('H58a')
        b2s = np.linspace(0.9, 1.0, 3)
        res = jfit.sweep(jm, freqs, {'nonlte.b_n2': b2s},
                         kind='rrl_spectrum', line='H58a')
        for i, b2 in enumerate(b2s):
            api = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                        departure_coeffs=(b1_fix, b2)),
                            axis=(1, 2))
            np.testing.assert_allclose(res.values[i], api, rtol=1e-10,
                                       err_msg=f"b_n2={b2}")
        # still rejected where the forwards have no nonlte slot
        with pytest.raises(ValueError, match="only meaningful"):
            jfit.sweep(jm, SED_FREQS, {'nonlte.b_n2': b2s}, kind='sed')

    def test_joint_sed_plus_nonlte_profile(self, model_params):
        """Mixed joint fit: the SED component builds on the real-
        parameter subset (nonlte.* slots are zero-gradient there) while
        the non-LTE profile component owns the b's.  Amplitude-only
        observables cannot split (mlr, b_n1, b_n2) completely — the
        physical degeneracy — so the assertions are the honest ones:
        the fit reproduces BOTH observations and stays on the
        degeneracy surface near the truth."""
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        freqs = _H58A_NU0 * (1.0 + np.linspace(-3e-4, 3e-4, 7))
        b_true = (0.94, 0.98)
        obs_line = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                         departure_coeffs=b_true),
                             axis=(1, 2))
        obs_sed = np.nansum(jm.flux_ff(SED_FREQS), axis=(1, 2))
        # b_n1 pinned at truth, b_n2 freed: the well-posed joint
        # problem (freeing BOTH b's leaves the beta sign-flip cliff in
        # the landscape — beta ~ (1 - b2/b1)/x diverges as x -> 0 — and
        # amplitude-only data cannot regularise it)
        res = jfit.fit_joint(
            jm,
            [{'kind': 'sed', 'freqs': SED_FREQS, 'observed': obs_sed},
             {'kind': 'rrl_spectrum', 'line': 'H58a', 'freqs': freqs,
              'observed': obs_line, 'lte': False,
              'departure_coeffs': (b_true[0], b_true[0])}],
            free=('properties.mlr_bj', 'nonlte.b_n2'),
            steps=500, learning_rate=0.005)
        assert res.values['properties.mlr_bj'] == pytest.approx(
            jm.params['properties']['mlr_bj'], rel=0.02)
        assert res.values['nonlte.b_n2'] == pytest.approx(b_true[1],
                                                          abs=5e-3)
        fit_sed = np.asarray(res.model[0])
        fit_line = np.asarray(res.model[1])
        np.testing.assert_allclose(fit_sed, obs_sed, rtol=3e-2)
        np.testing.assert_allclose(fit_line, obs_line, rtol=3e-2,
                                   atol=1e-12)

    def test_joint_nonlte_requires_rrl_component(self, model_params):
        jm = JetModel(_small(model_params))
        jm.time = 2.0 * YEAR
        obs_sed = np.nansum(jm.flux_ff(SED_FREQS), axis=(1, 2))
        with pytest.raises(ValueError, match="rrl_spectrum"):
            jfit.fit_joint(
                jm, [{'kind': 'sed', 'freqs': SED_FREQS,
                      'observed': obs_sed}],
                free=('nonlte.b_n2',), steps=2)
