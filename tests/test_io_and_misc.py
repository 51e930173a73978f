"""Tests for FITS I/O, checkpoints, logging, misc utilities, validation
and the CASA script-export compatibility layer."""
import copy
import os

import numpy as np
import pytest

from rajepy_tpu.io import fits as fitsio
from rajepy_tpu.io import checkpoint
from rajepy_tpu.utils import misc, validation
from rajepy_tpu.utils.logger import Entry, Log


class TestFits:
    def test_roundtrip_2d(self, tmp_path):
        data = np.random.default_rng(0).normal(size=(33, 47))
        hdr = fitsio.Header()
        hdr['OBJECT'] = 'test object'
        hdr['CRVAL1'] = 67.89190567
        hdr['CDELT1'] = -1.15e-6
        hdr['BUNIT'] = 'Jy pixel^-1'
        hdr['HISTORY'] = 'a' * 100  # splits over two cards
        f = str(tmp_path / 'test.fits')
        fitsio.write_fits(f, data, hdr)
        data2, hdr2 = fitsio.read_fits(f)
        np.testing.assert_array_equal(data2, data)
        assert hdr2['OBJECT'] == 'test object'
        assert hdr2['CRVAL1'] == pytest.approx(67.89190567)
        assert hdr2['CDELT1'] == pytest.approx(-1.15e-6)
        assert ''.join(hdr2['HISTORY']) == 'a' * 100

    def test_header_copy_is_independent(self):
        hdr = fitsio.Header()
        hdr['BUNIT'] = 'Jy/beam'
        hdr.comments['BUNIT'] = 'brightness unit'
        hdr['HISTORY'] = 'original'
        cp = hdr.copy()
        cp['BUNIT'] = ''
        cp['HISTORY'] = 'derived'
        assert hdr['BUNIT'] == 'Jy/beam'
        assert cp['BUNIT'] == ''
        assert hdr['HISTORY'] == ['original']
        assert cp['HISTORY'] == ['original', 'derived']
        assert cp.comments['BUNIT'] == 'brightness unit'

    def test_roundtrip_3d_float32(self, tmp_path):
        data = np.random.default_rng(1).normal(
            size=(4, 16, 17)).astype(np.float32)
        f = str(tmp_path / 'cube.fits')
        fitsio.write_fits(f, data)
        data2, hdr2 = fitsio.read_fits(f)
        assert hdr2['NAXIS'] == 3
        assert hdr2['BITPIX'] == -32
        np.testing.assert_allclose(data2, data, rtol=1e-7)

    def test_block_alignment(self, tmp_path):
        f = str(tmp_path / 'a.fits')
        fitsio.write_fits(f, np.ones((3, 3)))
        assert os.path.getsize(f) % 2880 == 0

    def test_long_string_value_continue_cards(self, tmp_path):
        """String values >68 chars use the CONTINUE convention instead of
        silent truncation (a long model_dcy is a realistic case)."""
        long_path = '/some/deeply/nested/output/directory/' + 'x' * 90 + \
            "/with_quo'tes/and_more_" + 'y' * 40
        hdr = fitsio.Header()
        hdr['MODELDIR'] = long_path
        hdr['OBJECT'] = 'short'
        f = str(tmp_path / 'long.fits')
        fitsio.write_fits(f, np.zeros((2, 2)), hdr)
        with open(f, 'rb') as fh:
            raw = fh.read(2880).decode('ascii')
        assert 'CONTINUE' in raw
        _, hdr2 = fitsio.read_fits(f)
        assert hdr2['MODELDIR'] == long_path
        assert hdr2['OBJECT'] == 'short'

    def test_float_formatting_roundtrips_exactly(self, tmp_path):
        """Extreme float64 values survive write->read bit-exactly (the old
        repr() formatting could overflow its fixed field)."""
        vals = {'V1': 1.2345678901234567e-123, 'V2': -9.87654321098765e+250,
                'V3': 2.0, 'V4': -1.7976931348623157e+308,
                'V5': 5e-324, 'V6': 0.1}
        hdr = fitsio.Header()
        for k, v in vals.items():
            hdr[k] = v
        f = str(tmp_path / 'floats.fits')
        fitsio.write_fits(f, np.zeros((2, 2)), hdr)
        _, hdr2 = fitsio.read_fits(f)
        for k, v in vals.items():
            assert hdr2[k] == v, (k, hdr2[k], v)

    def test_astropy_roundtrip(self, tmp_path, model_params):
        """Cross-validate the hand-rolled codec against astropy: our files
        must read back identically through astropy.io.fits, including the
        save_fits headers, and astropy-written files must read through our
        reader.  Skipped when astropy is absent from the environment."""
        apfits = pytest.importorskip('astropy.io.fits')
        if not hasattr(apfits, 'PrimaryHDU'):
            # real astropy is NOT installed in this image (the oracle
            # shim fabricates the module precisely because it is
            # missing); test_fits_standard_conformance below provides
            # the independent validation in its absence
            pytest.skip("real astropy not installed in this environment")
        from rajepy_tpu import JetModel
        jm = JetModel(copy.deepcopy(model_params))
        f = str(tmp_path / 'flux.fits')
        jm.flux_ff(6e9, savefits=f)

        ours, our_hdr = fitsio.read_fits(f)
        with apfits.open(f) as hdul:
            theirs = hdul[0].data
            ap_hdr = hdul[0].header
        np.testing.assert_array_equal(np.asarray(ours),
                                      np.asarray(theirs, dtype=ours.dtype))
        for key in ('OBJECT', 'CRVAL1', 'CRVAL2', 'CDELT1', 'CDELT2',
                    'BUNIT', 'CTYPE1', 'CTYPE2'):
            if key in our_hdr:
                assert ap_hdr[key] == our_hdr[key], key

        # astropy-written file through our reader
        g = str(tmp_path / 'ap.fits')
        data = np.arange(12.0).reshape(3, 4)
        hdu = apfits.PrimaryHDU(data)
        hdu.header['LONGKEY'] = 'z' * 100  # astropy emits CONTINUE cards
        hdu.header['TESTVAL'] = 3.14159265358979
        hdu.writeto(g)
        back, hdr2 = fitsio.read_fits(g)
        np.testing.assert_array_equal(back, data)
        assert hdr2['LONGKEY'] == 'z' * 100
        assert hdr2['TESTVAL'] == pytest.approx(3.14159265358979, rel=0)


class TestFITSStandardConformance:
    """Byte-level validation of the hand-rolled codec against the FITS
    standard (NOST 100-2.0), through an INDEPENDENT minimal parser
    written here from the standard — deliberately sharing no code with
    rajepy_tpu.io.fits, so a format assumption baked into the codec
    cannot silently validate itself.  This stands in for the astropy
    cross-check (astropy is not installed in this image); the astropy
    round-trip above runs automatically wherever astropy exists."""

    @staticmethod
    def _parse(raw: bytes):
        assert len(raw) % 2880 == 0, "file not a multiple of 2880 bytes"
        cards = {}
        order = []
        pos = 0
        ended = False
        while not ended:
            block = raw[pos:pos + 2880]
            assert len(block) == 2880
            # header blocks are restricted-ASCII text
            assert all(32 <= b <= 126 for b in block), \
                "non-printable byte in header block"
            pos += 2880
            for i in range(0, 2880, 80):
                card = block[i:i + 80].decode('ascii')
                key = card[:8].rstrip()
                if key == 'END':
                    ended = True
                    break
                if not key or key in ('COMMENT', 'HISTORY', 'CONTINUE'):
                    continue
                assert card[8:10] == '= ', f"bad value indicator: {card!r}"
                val = card[10:].split('/')[0].strip()
                cards[key] = val
                order.append(key)
        return cards, order, pos

    def test_written_file_conforms(self, tmp_path, model_params):
        import struct
        from rajepy_tpu import JetModel
        jm = JetModel(copy.deepcopy(model_params))
        f = str(tmp_path / 'flux.fits')
        flux = np.asarray(jm.flux_ff(6e9, savefits=f))
        raw = open(f, 'rb').read()
        cards, order, data_pos = self._parse(raw)

        # mandatory keywords, in the standard's mandated order
        assert order[0] == 'SIMPLE' and cards['SIMPLE'] == 'T'
        assert order[1] == 'BITPIX'
        assert order[2] == 'NAXIS'
        bitpix = int(cards['BITPIX'])
        naxis = int(cards['NAXIS'])
        shape = [int(cards[f'NAXIS{i + 1}']) for i in range(naxis)]
        assert order[3:3 + naxis] == [f'NAXIS{i + 1}'
                                      for i in range(naxis)]

        # payload: big-endian IEEE floats of exactly the declared shape
        count = int(np.prod(shape))
        itemsize = abs(bitpix) // 8
        payload = raw[data_pos:data_pos + count * itemsize]
        assert len(payload) == count * itemsize
        fmt = {-64: '>d', -32: '>f'}[bitpix]
        first = struct.unpack(fmt, payload[:itemsize])[0]
        arr = np.frombuffer(payload, dtype={-64: '>f8', -32: '>f4'}[
            bitpix]).reshape(tuple(reversed(shape)))
        assert arr.flat[0] == first
        # values round-trip against the in-memory product (FITS axis
        # order: our writer stores [dec, ra] with ra fastest)
        np.testing.assert_array_equal(
            np.ascontiguousarray(arr.squeeze()),
            np.asarray(flux.squeeze().T, dtype=arr.dtype))
        # trailing data block zero-padded to a 2880 multiple
        tail = raw[data_pos + count * itemsize:]
        assert len(tail) < 2880 * 2
        assert all(b == 0 for b in tail)

    def test_header_value_formats(self, tmp_path):
        from rajepy_tpu.io import fits as fitsio
        hdr = fitsio.Header()
        hdr['OBJECT'] = "O'Hara"          # quote escaping
        hdr['PI'] = 3.141592653589793     # float formatting
        hdr['NITER'] = 42                 # integer
        hdr['FLAG'] = True                # logical
        f = str(tmp_path / 'h.fits')
        fitsio.write_fits(f, np.zeros((2, 2)), hdr)
        cards, _, _ = self._parse(open(f, 'rb').read())
        assert cards['OBJECT'].startswith("'O''Hara")  # FITS '' escaping
        assert cards['FLAG'] == 'T'
        assert int(cards['NITER']) == 42
        assert abs(float(cards['PI']) - 3.141592653589793) < 1e-15


class TestCheckpoint:
    def test_model_roundtrip(self, model_params, tmp_path):
        from rajepy_tpu import JetModel
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=12, n_y=16, n_z=12)
        jm = JetModel(p)
        jm.time = 0.7 * 31536000.0
        _ = jm.fill_factor
        path = str(tmp_path / 'ckpt')
        checkpoint.save_model_checkpoint(path, jm)
        jm2 = checkpoint.load_model_checkpoint(path)
        assert jm2.time == jm.time
        np.testing.assert_array_equal(
            np.isnan(jm2.fill_factor), np.isnan(jm.fill_factor))
        assert jm2.params['properties']['n_0'] == \
            pytest.approx(jm.params['properties']['n_0'])

    def test_inconsistent_checkpoint_ff_stays_finite(self, model_params,
                                                     tmp_path):
        """A checkpoint whose fill factors disagree with the current
        params (hand-edited file, or params changed after save) must not
        poison products: a cell the checkpoint claims inside but the
        recomputed fields place outside has temp=0, and 0**-1.35 = inf
        would otherwise leak through every product on that sightline."""
        import pickle
        from rajepy_tpu import JetModel
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=12, n_y=16, n_z=12)
        jm = JetModel(p)
        jm.time = 0.7 * 31536000.0
        _ = jm.fill_factor          # materialise the cached ff/areas
        path = str(tmp_path / 'model.pkl')
        jm.save(path)
        with open(path, 'rb') as f:
            state = pickle.load(f)
        # claim a definitely-outside corner cell is fully inside the jet
        state['ffs'][0, 0, 0] = 1.0
        state['areas'][0, 0, 0] = 1.0
        with open(path, 'wb') as f:
            pickle.dump(state, f)
        jm2 = JetModel.load_model(path)
        fl = np.asarray(jm2.flux_ff(np.array([6e9])))
        tau = np.asarray(jm2.optical_depth_ff(np.array([6e9])))
        assert not np.isinf(fl).any() and not np.isinf(tau).any()
        assert np.nanmax(fl) > 0  # the real jet is still there

    def test_pipeline_state(self, model_params, tmp_path):
        from rajepy_tpu import JetModel, Pipeline
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=12, n_y=16, n_z=12)
        pparams = {
            'min_el': 20.,
            'dcys': {'model_dcy': str(tmp_path / 'p')},
            'continuum': {'times': np.array([0.]),
                          'freqs': np.array([6e9]), 't_obs': None,
                          'tscps': None, 't_ints': None, 'bws': None,
                          'chanws': None},
            'rrls': {'times': None, 'lines': None, 't_obs': None,
                     'tscps': None, 't_ints': None, 'bws': None,
                     'chanws': None},
        }
        pline = Pipeline(JetModel(p), pparams)
        pline.runs[0].completed = True
        pline.runs[0].results['flux'] = 1.23
        f = str(tmp_path / 'pipeline.json')
        checkpoint.save_pipeline_checkpoint(f, pline)
        state = checkpoint.load_pipeline_state(f)
        assert state['runs'][0]['completed'] is True
        assert state['runs'][0]['results']['flux'] == 1.23


class TestLogger:
    def test_log_writes_and_echoes(self, tmp_path, capsys):
        f = str(tmp_path / 'test.log')
        log = Log(f, verbose=True)
        log.add_entry('INFO', 'hello world')
        log.add_entry('WARNING', 'two\nlines')
        out = capsys.readouterr().out
        assert 'hello world' in out
        text = open(f).read()
        assert 'hello world' in text and 'INFO' in text
        assert 'WARNING' in text
        # timestamp=False blanks the preamble (reference logger.py:221-222)
        log.add_entry('INFO', 'quiet', timestamp=False)
        last = open(f).read().split('\n')[-1]
        assert last.lstrip().startswith(': quiet') or 'quiet' in last
        assert not last.startswith('1') and not last.startswith('2')

    def test_invalid_mtype(self, tmp_path):
        log = Log(str(tmp_path / 'x.log'))
        with pytest.raises(TypeError):
            log.add_entry('DEBUG', 'nope')

    def test_combine_logs_time_order(self, tmp_path):
        l1 = Log(str(tmp_path / 'a.log'), verbose=False)
        l2 = Log(str(tmp_path / 'b.log'), verbose=False)
        l1.add_entry('INFO', 'first')
        l2.add_entry('INFO', 'second')
        l1.add_entry('INFO', 'third')
        merged = Log.combine_logs(l1, l2, str(tmp_path / 'c.log'), True)
        msgs = [merged.entries[i].message for i in sorted(merged.entries)]
        assert msgs == ['first', 'second', 'third']
        assert not os.path.exists(str(tmp_path / 'a.log'))


class TestMisc:
    def test_freq_str(self):
        assert misc.freq_str(6e9) == '6GHz'
        assert misc.freq_str(250.) == '250Hz'
        assert misc.freq_str(1.5e5, '.1f') == '150.0kHz'
        assert misc.freq_str([1e9, 1e12]) == ['1GHz', '1THz']

    def test_reorder_axes_2d(self):
        a = np.arange(6).reshape(2, 3)  # (ra, dec)
        out = misc.reorder_axes(a, ra_axis=0, dec_axis=1)
        np.testing.assert_array_equal(out, a.T)

    def test_reorder_axes_3d(self):
        a = np.random.default_rng(0).normal(size=(4, 5, 6))
        # (freq, ra, dec) -> (freq, dec, ra)
        out = misc.reorder_axes(a, ra_axis=1, dec_axis=2, axis3=0,
                                axis3_type='freq')
        np.testing.assert_array_equal(out, np.transpose(a, (0, 2, 1)))

    def test_reorder_axes_4d(self):
        a = np.random.default_rng(0).normal(size=(3, 4, 5, 6))
        # (freq, ra, y, dec) -> (freq, y, dec, ra)
        out = misc.reorder_axes(a, ra_axis=1, dec_axis=3, axis3=2,
                                axis3_type='y', axis4=0, axis4_type='freq')
        np.testing.assert_array_equal(out, np.transpose(a, (0, 2, 3, 1)))

    def test_compile_cache_under_checkout(self, monkeypatch):
        """Without JAX_COMPILATION_CACHE_DIR the persistent compile cache
        lives at the fixed <checkout>/.jax_cache (git-ignored), and the
        package pointed JAX at it on import."""
        import jax
        import rajepy_tpu
        env_at_import = os.environ.get('JAX_COMPILATION_CACHE_DIR')
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        checkout = os.path.dirname(os.path.dirname(
            os.path.abspath(rajepy_tpu.__file__)))
        want = os.path.join(checkout, '.jax_cache')
        assert rajepy_tpu.compile_cache_dir() == want
        if not env_at_import:
            assert jax.config.jax_compilation_cache_dir == want
        with open(os.path.join(checkout, '.gitignore')) as f:
            assert '.jax_cache/' in f.read().split()

    def test_compile_cache_env_var_honoured(self, monkeypatch, tmp_path):
        """An explicit JAX_COMPILATION_CACHE_DIR wins: the package sets no
        cache directory of its own."""
        import rajepy_tpu
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
        assert rajepy_tpu.compile_cache_dir() is None

    def test_home_relativise_is_prefix_anchored(self):
        """Pipeline save/load '~' substitution must only touch a home
        PREFIX: a bare str.replace corrupted '/rootfs/...' paths when
        home='/root' and literal '~' elsewhere in a loaded path."""
        from rajepy_tpu.pipeline import _expand_home, _relativise_home
        home = '/root'
        assert _relativise_home('/root/models/x', home) == '~/models/x'
        assert _relativise_home('/root', home) == '~'
        assert _relativise_home('/rootfs/data/x', home) == '/rootfs/data/x'
        assert _expand_home('~/models/x', home) == '/root/models/x'
        assert _expand_home('~', home) == '/root'
        assert _expand_home('/data/proj~v2/x', home) == '/data/proj~v2/x'
        # round trip
        for p in ('/root/a/b', '/rootfs/a', '/data/proj~v2/m', '/root'):
            assert _expand_home(_relativise_home(p, home), home) == p


class TestValidation:
    def test_model_params_ok(self, model_params):
        assert validation.check_model_params(model_params) is None

    def test_missing_section(self, model_params):
        p = {k: v for k, v in model_params.items() if k != 'geometry'}
        assert isinstance(validation.check_model_params(p), KeyError)

    def test_wrong_type(self, model_params):
        p = copy.deepcopy(model_params)
        p['geometry']['opang'] = 'wide'
        assert isinstance(validation.check_model_params(p), ValueError)

    def test_n_0_optional(self, model_params):
        p = copy.deepcopy(model_params)
        assert 'n_0' not in p['properties']
        assert validation.check_model_params(p) is None

    def test_legacy_schema_migration(self):
        legacy = {'properties': {'mlr': 1e-8, 'n_0': None},
                  'ejection': {'t_0': np.array([0.5]),
                               'hl': np.array([0.25]),
                               'chi': np.array([2.])}}
        out = validation.migrate_legacy_model_params(legacy)
        assert out['properties']['mlr_bj'] == 1e-8
        assert out['properties']['mlr_rj'] == 1e-8
        assert list(out['ejection']['which']) == ['RB']

    def test_bad_epoch(self, model_params):
        p = copy.deepcopy(model_params)
        p['target']['epoch'] = 'B1875'
        assert isinstance(validation.check_model_params(p), ValueError)


class TestCasaCompat:
    def test_task_rendering_omits_defaults(self):
        from rajepy_tpu.casa_compat import Simobserve
        so = Simobserve(project='SynObs', totaltime='3600s')
        s = str(so)
        assert s.startswith('simobserve(')
        assert "project='SynObs'" in s
        assert "totaltime='3600s'" in s
        assert 'obsmode' not in s  # defaulted -> omitted

    def test_task_type_check(self):
        from rajepy_tpu.casa_compat import Tclean
        with pytest.raises(TypeError):
            Tclean(niter='lots')
        with pytest.raises(KeyError):
            Tclean(no_such_param=1)

    def test_positional_tasks(self):
        from rajepy_tpu.casa_compat import Chdir, Rmdir
        assert str(Chdir('/tmp/x')) == "os.chdir('/tmp/x')"
        assert str(Rmdir(path='/tmp/y')) == "shutil.rmtree(path='/tmp/y')"

    def test_ia_tool_wrappers(self):
        """The 5 ia-tool wrappers (reference casa/tasks.py:413-477)."""
        from rajepy_tpu.casa_compat import (IaClose, IaMaskhandler, IaOpen,
                                            IaPad, IaRestoringbeam)
        assert str(IaClose()) == 'ia.close()'
        assert str(IaOpen(infile='a.image')) == "ia.open(infile='a.image')"
        assert str(IaOpen(infile='a', cache=False)) in (
            "ia.open(infile='a', cache=False)",
            "ia.open(cache=False, infile='a')")
        assert str(IaPad(outfile='b', npixels=2)) == \
            "ia.pad(outfile='b', npixels=2)"
        assert str(IaRestoringbeam()) == 'ia.restoringbeam()'
        assert str(IaMaskhandler(op='copy', name=['m0', 'm1'])) == \
            "ia.maskhandler(op='copy', name=['m0', 'm1'])"
        with pytest.raises(TypeError):
            IaPad(npixels='two')

    def test_pointing(self):
        """Pointing value object (reference classes.py:3185-3233)."""
        from rajepy_tpu import Pointing
        p = Pointing(1000.0, '04:31:34.07736', '+18:08:04.9020', 300.0)
        assert p.ra == '04h31m34.0774'
        assert p.dec == '+18d08m04.902'
        assert p.time == 1000.0 and p.duration == 300.0
        assert p.epoch == 'J2000'
        ra_deg, dec_deg = p.coord
        assert abs(ra_deg - (4 + 31 / 60 + 34.07736 / 3600) * 15) < 1e-9
        n = Pointing(0.0, '12:00:00', '-05:30:00', 60.0, epoch='B1950')
        assert n.dec == '-05d30m00.000'
        assert n.epoch == 'B1950'
        with pytest.raises(ValueError):
            Pointing(0.0, '0:0:0', '0:0:0', 1.0, epoch='J1900')

    def test_script_render_and_dryrun(self, tmp_path, capsys):
        from rajepy_tpu.casa_compat import Script, Simobserve, Tclean
        sc = Script()
        sc.add_task(Simobserve(project='SynObs', skymodel='model.fits'))
        sc.add_task(Tclean(vis='SynObs.ms', imagename='im',
                           niter=500, interactive=False))
        text = sc.render()
        assert text.startswith('import os\nimport shutil\n')
        assert 'vp.setpbgauss' in text  # e-MERLIN PB always prepended
        assert 'simobserve(' in text and 'tclean(' in text
        sc.execute(dcy=str(tmp_path), dryrun=True)
        out = capsys.readouterr().out
        assert 'casa --nogui --nologger --agg' in out
        assert os.path.exists(str(tmp_path / sc.casafile))

    def test_script_executes_through_casa_binary(self, tmp_path,
                                                 monkeypatch):
        """The subprocess hand-off contract (_interface.py:63-81), tested
        against a stub ``casa`` on PATH: the stub receives the
        reference's exact flag set, writes the requested logfile and
        actually EXECUTES the rendered script (with a vp-tool shim), so
        the emitted os/shutil tasks must be valid runnable Python."""
        import stat
        import textwrap
        from rajepy_tpu.casa_compat import Mkdir, Rmdir, Script

        bindir = tmp_path / 'bin'
        bindir.mkdir()
        stub = bindir / 'casa'
        stub.write_text(textwrap.dedent('''\
            #!/usr/bin/env python3
            import sys
            args = sys.argv[1:]
            assert args[:3] == ['--nogui', '--nologger', '--agg'], args
            log = args[args.index('--logfile') + 1]
            script = args[args.index('-c') + 1]
            class _VP:
                def setpbgauss(self, **kw):
                    pass
            with open(log, 'w') as f:
                f.write('stub casa ran %s\\n' % script)
            src = open(script).read()
            exec(compile(src, script, 'exec'), {'vp': _VP()})
        '''))
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv('PATH', f"{bindir}:{os.environ['PATH']}")

        work = tmp_path / 'work'
        work.mkdir()
        (work / 'togo').mkdir()
        sc = Script()
        sc.add_task(Mkdir(name=str(work / 'made_by_casa')))
        sc.add_task(Rmdir(path=str(work / 'togo')))
        res = sc.execute(dcy=str(work), dryrun=False)
        assert res is not None and res.returncode == 0
        assert (work / 'made_by_casa').is_dir()   # Mkdir task ran
        assert not (work / 'togo').exists()       # Rmdir task ran
        assert 'stub casa ran' in (work / sc.logfile).read_text()


class TestReviewRegressionsR3S6:
    """Pins for the second round-3 session-6 review batch."""

    def test_format_hmsdms_sexagesimal_carry(self):
        from rajepy_tpu.ops.astronomy import format_hmsdms
        s = format_hmsdms(44.999999999999, -0.9999999999999)
        assert '60.0' not in s
        assert s.startswith('03h00m00.000000s')
        assert s.endswith('-01d00m00.000000s')
        # the carry at the top of the RA range wraps to 0h, never 24h
        s24 = format_hmsdms(359.9999999999998, 0.0)
        assert s24.startswith('00h00m00.000000s')

    def test_casatask_mutable_defaults_isolated(self):
        from rajepy_tpu.casa_compat import Tclean
        t = Tclean(vis='a.ms')
        t._values['scales'].extend([0, 3])
        # the class default and fresh instances are untouched...
        assert Tclean.PARAMS['scales'][1] == []
        assert Tclean(vis='b.ms')._values['scales'] == []
        # ...and the changed value now renders (an aliased default would
        # compare equal to itself and be omitted)
        assert 'scales=[0, 3]' in str(t)

    def test_pipeline_save_restores_live_paths(self, tmp_path,
                                               model_params):
        """Pipeline.save relativises paths in the PICKLE only: the
        reference mutates run.dcy/params in place (classes.py:2215-2258),
        so using the pipeline after execute() saw literal '~' paths."""
        import copy
        import pickle
        from rajepy_tpu import JetModel, Pipeline
        home = os.path.expanduser('~')
        mdcy = os.path.join(home, '.rajepy_tpu_test_save')
        pparams = {
            'min_el': 20.,
            'dcys': {'model_dcy': mdcy},
            'continuum': {'times': np.array([0.]),
                          'freqs': np.array([6e9]), 't_obs': None,
                          'tscps': None, 't_ints': None, 'bws': None,
                          'chanws': None},
            'rrls': {'times': np.array([]), 'lines': None, 't_obs': None,
                     'tscps': None, 't_ints': None, 'bws': None,
                     'chanws': None},
        }
        p = copy.deepcopy(model_params)
        jm = JetModel(p)
        try:
            pline = Pipeline(jm, pparams)
            f = str(tmp_path / 'p.save')
            pline.save(f)
            # pickle holds ~-relative paths; the live object keeps
            # absolute ones
            with open(f, 'rb') as fh:
                saved = pickle.load(fh)
            assert saved['params']['dcys']['model_dcy'].startswith('~')
            assert saved['runs'][0].dcy.startswith('~')
            assert pline.params['dcys']['model_dcy'] == mdcy
            assert pline.runs[0].dcy.startswith(home)
        finally:
            import shutil
            shutil.rmtree(mdcy, ignore_errors=True)

    def test_observatory_unknown_coordsys_raises(self):
        from rajepy_tpu.synthobs import observatories
        carma = os.path.join(observatories._CFG_DIR, 'carma.a.cfg')
        if not os.path.exists(carma):
            pytest.skip('carma cfg not bundled')
        with pytest.raises(ValueError, match='coordsys'):
            observatories.read_antenna_config(carma)

    def test_observatory_table_empty_quoted_fields(self):
        from rajepy_tpu.synthobs import observatories
        assert observatories._split_quoted('a "" b') == ['a', '', 'b']
        tab = observatories.observatory_table()
        # the ACA row ends '"Remy Indebetouw" "" "alma/..."' — the empty
        # Comment field must not shift later columns left
        aca = tab['ACA']
        assert aca['AntennaResponses'].endswith('AntennaResponses')

    def test_plan_scans_small_remainder_keeps_time(self):
        from rajepy_tpu.synthobs import uvgen
        plan = uvgen.plan_scans(3 * 3600.0 + 5.0, 3600.0, ew_int=True)
        assert np.all(plan['durations'] > 0)
        np.testing.assert_allclose(plan['durations'].sum(),
                                   3 * 3600.0 + 5.0)

    def test_moment_maps_single_channel_clear_error(self):
        from rajepy_tpu.models import analysis
        with pytest.raises(ValueError, match='>= 2 channels'):
            analysis.moment_maps(np.zeros((1, 4, 4)), np.array([1e10]),
                                 1e10)

    def test_validator_returns_on_none_target_fields(self, model_params):
        """The validators RETURN exceptions (module contract); None
        epoch/ra/dec used to escape as AttributeError."""
        import copy
        for key in ('epoch', 'ra', 'dec'):
            p = copy.deepcopy(model_params)
            p['target'][key] = None
            err = validation.check_model_params(p)
            assert isinstance(err, (ValueError, TypeError)), key

    def test_reorder_axes_axis4_without_axis3(self):
        with pytest.raises(ValueError, match='axis4 requires axis3'):
            misc.reorder_axes(np.zeros((2, 3, 4, 5)), ra_axis=3,
                              dec_axis=2, axis4=0, axis4_type='freq')


class TestStageTimeSplit:
    """The pipeline's stage registry (utils.profiling) splits
    device-compute from transfer/IO seconds for bench.py and
    chip_smoke.py."""

    def test_registry_and_split(self):
        from rajepy_tpu.utils import profiling
        profiling.collect_stage_times(True)
        try:
            profiling.record_stage('rt stage: device compute', 1.0)
            profiling.record_stage('rt stage: device compute', 0.5)
            profiling.record_stage(
                'rt stage: product transfer + FITS write', 0.25)
            profiling.record_stage('synthobs: vis npz write', 0.25)
            profiling.record_stage('synthobs: mfs imaging (64px)', 2.0)
            profiling.record_stage('unclassified thing', 0.125)
            with profiling.KernelTimer('synthobs: uv tracks') as kt:
                pass
            times = profiling.stage_times()
            assert times['rt stage: device compute'] == 1.5
            assert 'synthobs: uv tracks' in times
            dev, tr, other = profiling.split_stage_times(times)
            assert tr == 0.5
            assert other == 0.125
            assert dev == pytest.approx(
                3.5 + times['synthobs: uv tracks'])
        finally:
            profiling.collect_stage_times(False)
        # disabled: record_stage is a no-op and the registry is frozen
        profiling.record_stage('rt stage: device compute', 99.0)
        assert profiling.stage_times()['rt stage: device compute'] == 1.5

    def test_nested_timers_record_disjoint_seconds(self):
        """A timer firing inside another (cold execute: 'grid fill'
        inside 'rt stage: device compute' — both device-marked) must not
        double-count: the parent records its EXCLUSIVE time, so the
        registry totals sum to the real wall time."""
        import time as _t
        from rajepy_tpu.utils import profiling
        profiling.collect_stage_times(True)
        try:
            with profiling.KernelTimer('rt stage: device compute') as po:
                with profiling.KernelTimer(
                        'grid fill (fields + fill factors)') as ci:
                    _t.sleep(0.05)
                _t.sleep(0.02)
            times = profiling.stage_times()
        finally:
            profiling.collect_stage_times(False)
        child = times['grid fill (fields + fill factors)']
        parent = times['rt stage: device compute']
        assert child >= 0.05
        # exclusive: the parent's recorded time excludes the child's
        assert parent == pytest.approx(po.elapsed - ci.elapsed, abs=1e-9)
        assert 0.0 < parent < 0.05
        # the log-facing elapsed stays inclusive
        assert po.elapsed >= child + 0.02
        dev, _, _ = profiling.split_stage_times(times)
        assert dev == pytest.approx(po.elapsed, rel=1e-6)

    def test_pipeline_execute_records_stages(self, model_params,
                                             tmp_path):
        import copy
        import rajepy_tpu
        from rajepy_tpu.utils import profiling
        p = copy.deepcopy(model_params)
        p['grid'].update(n_x=16, n_y=32, n_z=16)
        pparams = {
            'min_el': 20.,
            'dcys': {'model_dcy': str(tmp_path / 'out')},
            'continuum': {'times': np.array([0.]),
                          'freqs': np.array([6e9]),
                          't_obs': np.array([1200]),
                          'tscps': np.array([('VLA', 'A')]),
                          't_ints': np.array([60]),
                          'bws': np.array([1e8]),
                          'chanws': np.array([1e8])},
            'rrls': {'times': np.array([]), 'lines': None, 't_obs': None,
                     'tscps': None, 't_ints': None, 'bws': None,
                     'chanws': None},
        }
        pline = rajepy_tpu.Pipeline(rajepy_tpu.JetModel(p), pparams)
        profiling.collect_stage_times(True)
        try:
            pline.execute(simobserve=True, verbose=False, resume=False,
                          clobber=True, plot=False)
            dev, tr, other = profiling.split_stage_times()
        finally:
            profiling.collect_stage_times(False)
        assert dev > 0.0       # grid fill + rt compute + sampling/imaging
        assert tr > 0.0        # FITS/npz writes
        names = profiling.stage_times()
        assert any('rt stage: device compute' in k for k in names)
        assert any('product transfer' in k for k in names)
