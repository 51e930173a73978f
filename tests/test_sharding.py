"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rajepy_tpu.parallel import sharding


@pytest.fixture(scope='module')
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs xla_force_host_platform_device_count=8")
    return jax.devices()[:8]


def _small_model(model_params):
    from rajepy_tpu import JetModel
    p = copy.deepcopy(model_params)
    p['grid'].update(n_x=16, n_y=32, n_z=16, l_z=None)
    # burst-free so the static density equals the time-dependent one
    p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                     'chi': np.array([]), 'which': np.array([])}
    return JetModel(p)


class TestMesh:
    def test_make_mesh_shapes(self, eight_devices):
        mesh = sharding.make_mesh()
        assert mesh.devices.size == 8
        assert mesh.axis_names == ('chan', 'los')
        mesh2 = sharding.make_mesh(n_los=4, n_chan=2)
        assert mesh2.devices.shape == (2, 4)


class TestShardedRT:
    def test_los_sharded_matches_single_device(self, eight_devices,
                                               model_params):
        jm = _small_model(model_params)
        f, n_es, ds = jm._rt_inputs()
        freqs = jnp.asarray([1e9, 3e9, 6e9, 1e10])
        t_0 = jm.params['properties']['T_0']

        from rajepy_tpu.ops import radtrans as rt
        expected = np.asarray(rt.tau_ff_maps(freqs, f.temp, n_es, ds,
                                             f.inside, t_0, False))

        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        with mesh:
            fs = sharding.shard_fields(f, mesh)
            step = sharding.sharded_continuum_step(mesh, t_0, False)
            n_es_s = jax.device_put(n_es, sharding.grid_sharding(mesh))
            ds_s = jax.device_put(ds, sharding.grid_sharding(mesh))
            got = step(jax.device_put(freqs, sharding.chan_sharding(mesh)),
                       fs.temp, n_es_s, ds_s, fs.inside)
        np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-12)

    def test_full_rt_step_sharded(self, eight_devices, model_params):
        jm = _small_model(model_params)
        f = jm._ensure_fields()
        freqs = jnp.asarray([6e9, 1e10])
        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        t_0 = jm.params['properties']['T_0']
        with mesh:
            step = sharding.sharded_rt_products(
                mesh, t_0, False, jm.csize, jm.params['target']['dist'])
            fs = sharding.shard_fields(f, mesh)
            em, taus, fluxes = step(
                jax.device_put(freqs, sharding.chan_sharding(mesh)),
                fs.nd, fs.xi, fs.temp, fs.ff, fs.area, fs.inside)
        em = np.asarray(em)
        fluxes = np.asarray(fluxes)
        assert em.shape == (jm.nx, jm.nz)
        assert fluxes.shape == (2, jm.nx, jm.nz)
        # compare against the unsharded model API
        np.testing.assert_allclose(
            em, jm.emission_measure(), rtol=1e-12)
        np.testing.assert_allclose(
            fluxes, jm.flux_ff(np.asarray(freqs)), rtol=1e-12)

    def test_rrl_tau_sharded_matches_single_device(self, eight_devices,
                                                   model_params):
        from rajepy_tpu.ops import radtrans as rt
        jm = _small_model(model_params)
        f, n_es, ds = jm._rt_inputs()
        coeffs = rt.RRLCoeffs('H58a')
        freqs = jnp.linspace(coeffs.nu0 * 0.9999, coeffs.nu0 * 1.0001, 4)
        expected = np.asarray(rt.tau_rrl_maps(coeffs, freqs, f.temp, n_es,
                                              f.vy, ds, f.inside))
        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        with mesh:
            fs = sharding.shard_fields(f, mesh)
            got = sharding.sharded_rrl_tau_maps(
                mesh, coeffs,
                jax.device_put(freqs, sharding.chan_sharding(mesh)),
                fs.temp,
                jax.device_put(n_es, sharding.grid_sharding(mesh)),
                fs.vy,
                jax.device_put(ds, sharding.grid_sharding(mesh)),
                fs.inside)
        np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-12)

    @pytest.mark.parametrize('observer_near_y0', [False, True])
    def test_transfer_scan_sharded_monoid(self, eight_devices, model_params,
                                          observer_near_y0):
        """The cross-shard (attenuation, intensity) monoid combine must
        reproduce the single-device ordered scan exactly."""
        from rajepy_tpu.ops import radtrans as rt
        jm = _small_model(model_params)
        f, n_es, ds = jm._rt_inputs()
        t_0 = jm.params['properties']['T_0']
        dtau = rt.tau_ff_cube(jnp.asarray([1e10]), f.temp, n_es, ds,
                              f.inside, t_0, False)[0]
        src = jnp.where(f.inside, f.temp, 0.0)
        expected_i = np.asarray(rt.transfer_scan(
            src, dtau, observer_near_y0=observer_near_y0))
        expected_tau = np.asarray(jnp.sum(dtau, axis=1))

        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        sh = sharding.grid_sharding(mesh)
        with mesh:
            inten, tau_tot = sharding.sharded_transfer_scan(
                mesh, jax.device_put(src, sh), jax.device_put(dtau, sh),
                observer_near_y0=observer_near_y0)
        np.testing.assert_allclose(np.asarray(inten), expected_i,
                                   rtol=1e-10, atol=0.0)
        np.testing.assert_allclose(np.asarray(tau_tot), expected_tau,
                                   rtol=1e-12)

    def test_clean_cube_channel_sharded(self, eight_devices):
        """Channel-sharded cube imaging equals the single-device program."""
        from rajepy_tpu.synthobs import imaging, observatories, sampler, \
            uvgen
        rng = np.random.default_rng(7)
        n_chan, n, imsize = 8, 24, 64
        sky = np.zeros((n_chan, n, n))
        sky[:, n // 2, n // 2] = 1e-2
        ant = observatories.read_antenna_config(
            observatories.cfg_file('VLA', 'D'))
        bl, _ = uvgen.baselines(ant['xyz'][:6])
        uvw = uvgen.uvw_tracks(bl, np.linspace(-0.5, 0.5, 8), 30.0,
                               -107.6).reshape(-1, 3)
        freqs = np.linspace(1.00e10, 1.02e10, n_chan)
        cell_model = 2e-7
        vis = np.asarray(sampler.sample_vis_cube(
            jnp.asarray(sky), cell_model, jnp.asarray(uvw),
            jnp.asarray(freqs)))
        cell_rad = (3e8 / freqs[-1]) / np.abs(uvw[:, :2]).max() / 4.0
        mask = np.zeros((imsize, imsize))
        mask[imsize // 4:-imsize // 4, imsize // 4:-imsize // 4] = 1.0
        kern = imaging.gaussian_beam_kernel(imsize, cell_rad, 4 * cell_rad,
                                            3 * cell_rad, 0.0)
        w0 = np.ones(uvw.shape[0])

        expected, _ = imaging.clean_cube(
            jnp.asarray(uvw[:, :2]), jnp.asarray(freqs),
            jnp.asarray(vis.real), jnp.asarray(vis.imag),
            jnp.asarray(w0), imsize, cell_rad, jnp.asarray(mask),
            jnp.asarray(kern), weighting='natural', niter=20)

        mesh = sharding.make_mesh(n_los=2, n_chan=4)
        with mesh:
            got, _ = sharding.sharded_clean_cube(
                mesh, uvw, freqs, vis.real, vis.imag, w0, imsize,
                cell_rad, mask, kern, weighting='natural', niter=20)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                                   rtol=1e-10, atol=1e-14)

        # channel counts NOT divisible by the mesh pad internally
        # (duplicated last frequency, zero visibilities) and slice back
        with mesh:
            got7, _ = sharding.sharded_clean_cube(
                mesh, uvw, freqs[:7], vis.real[:7], vis.imag[:7], w0,
                imsize, cell_rad, mask, kern, weighting='natural',
                niter=20)
        assert got7.shape[0] == 7
        np.testing.assert_allclose(np.asarray(got7),
                                   np.asarray(expected)[:7],
                                   rtol=1e-10, atol=1e-14)

        # a caller-supplied chan_chunk must reach the per-shard clean_cube
        # call (review r3s6: it used to keep the inner 256 default, so
        # any chan_chunk > 256 raised 'cannot run inside a traced
        # context' — each shard's channel count exceeded the inner
        # chunking bound).  Capture the forwarded kwarg and re-check the
        # result equality through the wrapped call.
        from rajepy_tpu.synthobs import imaging as imaging_mod
        seen = []
        orig = imaging_mod.clean_cube

        def spy(*a, **kw):
            seen.append(kw.get('chan_chunk'))
            return orig(*a, **kw)

        imaging_mod.clean_cube = spy
        try:
            with mesh:
                got_cc, _ = sharding.sharded_clean_cube(
                    mesh, uvw, freqs, vis.real, vis.imag, w0, imsize,
                    cell_rad, mask, kern, weighting='natural', niter=20,
                    chan_chunk=300)
        finally:
            imaging_mod.clean_cube = orig
        assert seen and all(c == 300 for c in seen)
        np.testing.assert_allclose(np.asarray(got_cc),
                                   np.asarray(expected),
                                   rtol=1e-10, atol=1e-14)

    def test_continuum_runs_fanout_matches_sequential(self, eight_devices,
                                                      model_params):
        """Run-level fan-out (parallel.fanout) vs the per-run model
        methods the sequential pipeline loop calls."""
        from rajepy_tpu import JetModel
        from rajepy_tpu.parallel import fanout
        import rajepy_tpu.constants as cnsts
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=16, n_y=32, n_z=16, l_z=None)
        jm = JetModel(p)
        years = np.array([0.0, 0.5, 1.0])  # 3 runs over 8 devices (pad)
        freqs_mat = np.stack([np.array([6e9, 1e10])] * 3)
        em, taus, fluxes = fanout.continuum_runs_fanout(jm, years,
                                                        freqs_mat)
        assert em.shape == (3, jm.nx, jm.nz)
        assert fluxes.shape == (3, 2, jm.nx, jm.nz)
        for k, yr in enumerate(years):
            jm.time = yr * cnsts.YEAR
            np.testing.assert_allclose(em[k], jm.emission_measure(),
                                       rtol=1e-12)
            np.testing.assert_allclose(
                taus[k], jm.optical_depth_ff(freqs_mat[k]), rtol=1e-12)
            np.testing.assert_allclose(
                fluxes[k], jm.flux_ff(freqs_mat[k]), rtol=1e-12)

    def test_rrl_runs_fanout_matches_sequential(self, eight_devices,
                                                model_params):
        from rajepy_tpu import JetModel
        from rajepy_tpu.parallel import fanout
        from rajepy_tpu.ops import radtrans as rt
        import rajepy_tpu.constants as cnsts
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=16, n_y=32, n_z=16, l_z=None)
        jm = JetModel(p)
        nu0 = rt.RRLCoeffs('H58a').nu0
        years = np.array([0.0, 0.8])
        freqs_mat = np.stack([np.linspace(nu0 * 0.9999, nu0 * 1.0001, 4)]
                             * 2)
        em, tau_l, fluxes = fanout.rrl_runs_fanout(jm, 'H58a', years,
                                                   freqs_mat,
                                                   contsub=False)
        for k, yr in enumerate(years):
            jm.time = yr * cnsts.YEAR
            np.testing.assert_allclose(
                tau_l[k], jm.optical_depth_rrl('H58a', freqs_mat[k]),
                rtol=1e-9)
            np.testing.assert_allclose(
                fluxes[k], jm.flux_rrl('H58a', freqs_mat[k],
                                       contsub=False), rtol=1e-9)

    def test_light_curve_sharded_matches_single_device(self, eight_devices,
                                                       model_params):
        from rajepy_tpu import JetModel
        from rajepy_tpu.models import analysis
        import copy
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=16, n_y=32, n_z=16, l_z=None)
        jm = JetModel(p)
        times = np.linspace(0.0, 1.2, 11)  # 11 epochs over 8 devices (pad)
        freqs = np.array([6e9, 1e10])
        lc_ref = analysis.light_curve(jm, times, freqs)
        lc_sh = sharding.light_curve_sharded(jm, times, freqs)
        np.testing.assert_allclose(lc_sh, lc_ref, rtol=1e-12)

    def test_epoch_tiles_sharded_matches_single_device(self, eight_devices,
                                                       model_params):
        """The tile-parallel epoch map (production compacted path sharded
        across all devices) vs the full-grid chi^2 LOS sum."""
        from rajepy_tpu import JetModel
        from rajepy_tpu.models import ejection as ej
        from rajepy_tpu.ops import tiles
        import copy
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=16, n_y=32, n_z=16, l_z=None)
        jm = JetModel(p)
        f = jm._ensure_fields()
        st = jm._rt_static()
        tile = dict(block_x=8, block_z=128, y_chunk=16)
        ids, seg = tiles.active_tiles(f.inside, **tile)
        assert ids.size > 0
        ids_d = jnp.asarray(ids)
        base_t = tiles.gather_tiles(st.a, ids_d, **tile)
        tss_t = tiles.gather_tiles(st.ts_signed, ids_d, fill=1.0, **tile)

        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        t_now = 1.1 * 31536000.0
        got = np.asarray(sharding.sharded_epoch_base_map_tiles(
            mesh, base_t, tss_t, jnp.asarray(seg), t_now, jm._spec_r,
            jm._spec_b, jm.nx, jm.nz,
            pack_offset=jm._ts_pack_offset))

        chi = ej.chi_field(f.red, t_now - f.ts, jm._spec_r, jm._spec_b)
        want = np.asarray(jnp.sum(st.a * chi * chi, axis=1))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


class TestShardedFill:
    """sharded_static_fields: the grid fill itself built LOS-sharded."""

    def test_matches_single_device_fill(self, eight_devices, model_params):
        jm = _small_model(model_params)
        single = jm._ensure_fields()
        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        with mesh:
            shard = sharding.sharded_static_fields(
                mesh, jm._static_params(), jm._ss_jml_rb_frac,
                jm.nx, jm.ny, jm.nz, jm.csize, dtype=jnp.float64,
                with_time=jm._has_bursts)
        for name in single._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(shard, name)),
                np.asarray(getattr(single, name)),
                rtol=1e-12, atol=0, err_msg=name)

    def test_fields_are_los_sharded(self, eight_devices, model_params):
        jm = _small_model(model_params)
        mesh = sharding.make_mesh(n_los=4, n_chan=2)
        with mesh:
            shard = sharding.sharded_static_fields(
                mesh, jm._static_params(), jm._ss_jml_rb_frac,
                jm.nx, jm.ny, jm.nz, jm.csize, dtype=jnp.float64)
        # each device holds ny/n_los of the LOS axis, full nx/nz
        for name in ('temp', 'nd', 'ts'):
            arr = getattr(shard, name)
            sh0 = arr.addressable_shards[0]
            assert sh0.data.shape == (jm.nx, jm.ny // 4, jm.nz), name
        # and the sharded fields drive the sharded RT step unmodified
        freqs = jnp.linspace(4e9, 4e10, 4)
        with mesh:
            step = sharding.sharded_rt_products(
                mesh, jm.params['properties']['T_0'], False, jm.csize,
                jm.params['target']['dist'])
            em, taus, fluxes = step(
                jax.device_put(freqs, sharding.chan_sharding(mesh)),
                shard.nd, shard.xi, shard.temp, shard.ff, shard.area,
                shard.inside)
        f = jm._ensure_fields()
        from rajepy_tpu.ops import radtrans as rt
        em_ref = rt.emission_measure_map(f.nd, f.xi, f.ff, f.area,
                                         jm.csize)
        np.testing.assert_allclose(np.asarray(em), np.asarray(em_ref),
                                   rtol=1e-12)

    def test_fill_beyond_single_device_budget(self, eight_devices,
                                              model_params):
        """Beyond-single-HBM scaling, proven by the compiler (SURVEY
        §2.9(b)): a model whose full static cube set is >2x any one
        device's live footprint builds through the mesh-sharded fill.
        XLA's buffer assignment for the SPMD program gives the true
        per-device bytes (arguments + outputs + temporaries); no cube is
        ever replicated, and the products still match the single-device
        path at the same shape."""
        from rajepy_tpu import JetModel
        p = copy.deepcopy(model_params)
        # 64 x 256 x 64 f64: the 9-cube output set alone is ~62 MB
        p['grid'].update(n_x=64, n_y=256, n_z=64, l_z=None)
        # burst-free so the static density equals the time-dependent one
        p['ejection'] = {'t_0': np.array([]), 'hl': np.array([]),
                         'chi': np.array([]), 'which': np.array([])}
        jm = JetModel(p)
        mesh = sharding.make_mesh(n_los=8, n_chan=1)

        stats = sharding.fill_memory_stats(
            mesh, jm._static_params(), jm._ss_jml_rb_frac, jm.nx, jm.ny,
            jm.nz, jm.csize, dtype=jnp.float64,
            with_time=jm._has_bursts)
        assert stats is not None, "backend lost memory_analysis support"
        assert stats['n_los'] == 8
        # the output set is 1/8th per device (never replicated):
        # full_output_bytes comes INDEPENDENTLY from the logical
        # eval_shape leaves, so this has teeth — buffer alignment is
        # bytes-scale, far below the ~7.3 MB a single replicated cube
        # would add; bound the slack by HALF the smallest replication
        # rather than a hard-coded alignment guess (per-leaf page
        # alignment on some backend/version must not false-fail this)
        pad = stats['per_device_output_bytes'] - \
            stats['full_output_bytes'] // 8
        pad_limit = stats['min_leaf_bytes'] * 7 // 8 // 2
        assert 0 <= pad <= pad_limit, stats
        # and TOTAL per-device live bytes — temporaries included — stay
        # under half the full cube set: a device with half the model's
        # HBM footprint still builds it
        assert stats['per_device_bytes'] < stats['full_output_bytes'] / 2, \
            (stats['per_device_bytes'], stats['full_output_bytes'])

        with mesh:
            shard = sharding.sharded_static_fields(
                mesh, jm._static_params(), jm._ss_jml_rb_frac,
                jm.nx, jm.ny, jm.nz, jm.csize, dtype=jnp.float64,
                with_time=jm._has_bursts)
            for name in ('temp', 'nd', 'ff'):
                arr = getattr(shard, name)
                for s in arr.addressable_shards:
                    assert s.data.shape == (jm.nx, jm.ny // 8, jm.nz), \
                        name
            # sharded RT products at the beyond-budget shape agree with
            # the single-device model API (CPU hosts both comfortably;
            # on hardware only the sharded path would fit)
            step = sharding.sharded_rt_products(
                mesh, jm.params['properties']['T_0'], False, jm.csize,
                jm.params['target']['dist'])
            freqs = jnp.asarray([6e9, 1e10])
            em, taus, fluxes = step(
                jax.device_put(freqs, sharding.chan_sharding(mesh)),
                shard.nd, shard.xi, shard.temp, shard.ff, shard.area,
                shard.inside)
        np.testing.assert_allclose(np.asarray(em), jm.emission_measure(),
                                   rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(fluxes), jm.flux_ff(np.asarray(freqs)),
            rtol=1e-12)
