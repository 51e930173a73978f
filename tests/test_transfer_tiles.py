"""The ordered LOS transfer scan and the compacted-tile XLA forms of the
per-epoch products (ops.tiles) against float64 oracles, plus the f32
Voigt evaluators the RRL tile path uses."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rajepy_tpu import constants as cnsts
from rajepy_tpu.models import ejection as ej
from rajepy_tpu.ops import physics as mphys
from rajepy_tpu.ops import radtrans as rt
from rajepy_tpu.ops import tiles


def _scan_oracle(src, dtau, observer_near_y0=False):
    """float64 numpy ordered transfer integral along axis 1."""
    d = np.asarray(dtau, np.float64)
    s = np.asarray(src, np.float64)
    if not observer_near_y0:
        d, s = d[:, ::-1], s[:, ::-1]
    front = np.cumsum(d, axis=1) - d
    return np.sum(s * np.exp(-front) * -np.expm1(-d), axis=1)


def _bursts(spec_r, spec_b):
    out = []
    for spec, is_red in ((spec_r, True), (spec_b, False)):
        for t0, peak, sig in zip(spec.t_0, spec.peak_jml, spec.sigma):
            out.append((float(t0), float(1.0 / (2.0 * sig ** 2)),
                        float((peak - spec.ss_jml) / spec.ss_jml), is_red))
    return tuple(out)


_SPEC_R = ej.EjectionSpec(1e-7, np.array([0.4 * 3.15e7, 1.1 * 3.15e7]),
                          np.array([5e-7, 3e-7]), np.array([4.7e6, 2.4e6]))
_SPEC_B = ej.EjectionSpec(2e-7, np.array([0.8 * 3.15e7]), np.array([6e-7]),
                          np.array([4.7e6]))


def _jet(shape, seed, empty_x=None, empty_y=None):
    """Random jet cells (with the ``empty_x``/``empty_y`` index ranges
    emptied, so whole tiles drop out), temperatures, densities and
    travel times — NEGATIVE ones included (the off-axis launch-surface
    case)."""
    rng = np.random.default_rng(seed)
    inside = rng.random(shape) < 0.3
    if empty_x is not None:
        inside[empty_x] = False
    if empty_y is not None:
        inside[:, empty_y] = False
    temp = np.where(inside, 1e4 * (0.5 + rng.random(shape)), 1.0)
    n_es = np.where(inside, 1e7 * rng.random(shape), 0.0)
    ts = np.where(inside, 3e7 * rng.random(shape) - 2e6, 0.0)
    red = rng.random(shape) < 0.5
    return inside, temp, n_es, ts, red


@pytest.mark.parametrize("shape", [(16, 24, 128), (8, 16, 130)])
@pytest.mark.parametrize("observer_near_y0", [False, True])
def test_transfer_scan_matches_f64_oracle(shape, observer_near_y0):
    """rt.transfer_scan in float32 vs the float64 host oracle, both
    observer ends, including a shape with a padded-width edge."""
    rng = np.random.default_rng(0)
    src = rng.random(shape)
    dtau = 0.2 * rng.random(shape)
    got = rt.transfer_scan(jnp.asarray(src, jnp.float32),
                           jnp.asarray(dtau, jnp.float32),
                           observer_near_y0=observer_near_y0)
    want = _scan_oracle(src, dtau, observer_near_y0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=1e-6)


def test_opaque_limit():
    # an opaque cell near the observer hides everything behind it
    shape = (8, 16, 128)
    src = jnp.ones(shape, jnp.float32)
    dtau = jnp.zeros(shape, jnp.float32)
    # observer at +y (default): cell at y = ny-1 is in front
    dtau = dtau.at[:, -1, :].set(50.0)
    np.testing.assert_allclose(np.asarray(rt.transfer_scan(src, dtau)), 1.0,
                               rtol=1e-6)


def test_transparent_is_zero():
    shape = (8, 16, 128)
    src = jnp.ones(shape, jnp.float32)
    dtau = jnp.zeros(shape, jnp.float32)
    np.testing.assert_array_equal(np.asarray(rt.transfer_scan(src, dtau)),
                                  0.0)
    np.testing.assert_array_equal(np.asarray(rt.cumulative_tau(dtau)), 0.0)


def test_burst_factor_matches_chi_field():
    """tiles.burst_factor on a packed launch-time cube (static burst
    unroll) vs models/ejection.chi_field, NEGATIVE travel times
    included — the packing offset must transport them exactly."""
    inside, _, _, ts, red = _jet((12, 40, 130), seed=2)
    off = tiles.pack_offset_for(ts.min())
    assert off > 1.0
    tss = tiles.pack_launch_time(jnp.asarray(ts, jnp.float32),
                                 jnp.asarray(red), jnp.float32, offset=off)
    bursts = _bursts(_SPEC_R, _SPEC_B)
    for t_now in (0.0, 0.5 * 3.15e7, 1.2 * 3.15e7):
        got = np.asarray(tiles.burst_factor(tss, t_now, bursts, off))
        want = np.asarray(ej.chi_field(jnp.asarray(red),
                                       t_now - jnp.asarray(ts), _SPEC_R,
                                       _SPEC_B))
        np.testing.assert_allclose(got, want, rtol=2e-6)
    # no bursts: chi = 1 exactly
    np.testing.assert_array_equal(
        np.asarray(tiles.burst_factor(tss, 0.0, (), off)), 1.0)


@pytest.mark.parametrize("shape,tile", [
    ((12, 40, 130), dict(block_x=8, block_z=128, y_chunk=16)),
    ((16, 64, 128), dict(block_x=8, block_z=128, y_chunk=32)),
])
def test_epoch_tiles_match_f64_chi_scan(shape, tile):
    """Both collapsed epoch maps over COMPACTED tiles (padded grids,
    dropped empty tiles) vs the full-grid float64 chi_field LOS sums."""
    inside, temp, n_es, ts, red = _jet(shape, seed=3,
                                       empty_x=slice(0, shape[0] // 2),
                                       empty_y=slice(shape[1] // 2, None))
    rng = np.random.default_rng(4)
    a = np.where(inside, rng.random(shape), 0.0)
    em = np.where(inside, rng.random(shape) ** 2, 0.0)
    off = tiles.pack_offset_for(ts.min())
    ids, seg = tiles.active_tiles(jnp.asarray(inside), **tile)
    nx, ny, nz = shape
    n_total = (-(-nx // 8)) * (-(-ny // tile['y_chunk'])) * (-(-nz // 128))
    assert 0 < ids.size < n_total
    ids_d = jnp.asarray(ids)
    f32 = jnp.float32
    a_t = tiles.gather_tiles(jnp.asarray(a, f32), ids_d, **tile)
    em_t = tiles.gather_tiles(jnp.asarray(em, f32), ids_d, **tile)
    tss = tiles.pack_launch_time(jnp.asarray(ts, f32), jnp.asarray(red),
                                 f32, offset=off)
    tss_t = tiles.gather_tiles(tss, ids_d, fill=1.0, **tile)
    bursts = _bursts(_SPEC_R, _SPEC_B)
    for t_now in (0.0, 0.5 * 3.15e7, 1.2 * 3.15e7):
        got_a, got_em = tiles.epoch_base_maps_tiles(
            (a_t, em_t), tss_t, jnp.asarray(seg), t_now, bursts, nx, nz,
            pack_offset=off)
        chi = np.asarray(ej.chi_field(jnp.asarray(red),
                                      t_now - jnp.asarray(ts), _SPEC_R,
                                      _SPEC_B))
        for got, base in ((got_a, a), (got_em, em)):
            want = np.sum(base * chi * chi, axis=1)
            assert got.shape == want.shape
            np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                       atol=5e-6 * want.max())


def _emergent_case(shape, tile, seed, with_bursts, reynolds_gaunt=True):
    """Compacted emergent scan vs the float64 host oracle on the same
    inputs; returns the max error relative to each channel map's max."""
    inside, temp, n_es, ts, red = _jet(shape, seed,
                                       empty_x=slice(shape[0] // 2, None),
                                       empty_y=slice(0, shape[1] // 4))
    ds = np.where(inside, 7.5e12, 0.0)
    freqs = np.linspace(1e9, 5e10, 4)
    t_0, t_now = 1e4, 0.9 * 3.15e7
    off = tiles.pack_offset_for(ts.min())
    bursts = _bursts(_SPEC_R, _SPEC_B) if with_bursts else ()
    base = np.asarray(rt.tau_ff_base(jnp.asarray(temp), jnp.asarray(n_es),
                                     jnp.asarray(ds), jnp.asarray(inside),
                                     reynolds_gaunt))
    scale = np.asarray(rt.tau_ff_channel_scale(jnp.asarray(freqs), t_0,
                                               reynolds_gaunt))
    cnu = 2.0 * cnsts.H_CGS * freqs ** 3 / cnsts.C_CGS ** 2
    hnuk = cnsts.H_CGS * freqs / cnsts.K_CGS
    f32 = jnp.float32
    tss = tiles.pack_launch_time(jnp.asarray(ts, f32), jnp.asarray(red),
                                 f32, offset=off)
    ids, seg, jt, it, kt = tiles.active_tiles_scan_order(
        jnp.flip(jnp.asarray(inside), 1), **tile)
    assert ids.size
    ids_d = jnp.asarray(ids)

    def gather(cube, fill=0.0):
        return tiles.gather_tiles(jnp.flip(jnp.asarray(cube, f32), 1),
                                  ids_d, fill=fill, **tile)

    n_yt = -(-shape[1] // tile['y_chunk'])
    parts, tau_parts = tiles.emergent_ff_tiles(
        jnp.asarray(cnu, f32), jnp.asarray(hnuk, f32),
        jnp.asarray(scale, f32), gather(temp, 1.0), gather(base),
        tiles.gather_tiles(jnp.flip(tss, 1), ids_d, fill=1.0, **tile),
        jnp.asarray(seg), jnp.asarray(jt), t_now, bursts,
        int(seg.max()) + 1, n_yt, pack_offset=off)
    n_xt, n_zt = -(-shape[0] // 8), -(-shape[2] // 128)
    inten = np.asarray(tiles.scatter_tile_maps(
        parts, jnp.asarray(it), jnp.asarray(kt), n_xt, n_zt, shape[0],
        shape[2]))
    tau_map = np.asarray(tiles.scatter_tile_maps(
        tau_parts, jnp.asarray(it), jnp.asarray(kt), n_xt, n_zt, shape[0],
        shape[2]))
    # the oracle's burst factor from the same f32-packed launch times
    # (the packing quantises ts to ~2 s, ~1e-5 of chi^2 at these bursts)
    ts_q = np.abs(np.asarray(tss, np.float64)) - off
    chi = np.asarray(ej.chi_field(jnp.asarray(red), t_now - ts_q, _SPEC_R,
                                  _SPEC_B)) if with_bursts else 1.0
    dbase = base * chi * chi
    errs = []
    for c in range(len(freqs)):
        src = np.where(inside, cnu[c] / np.expm1(hnuk[c] / temp), 0.0)
        want = _scan_oracle(src, dbase * scale[c])
        assert want.max() > 0
        errs.append(np.abs(inten[c] - want).max() / want.max())
        want_tau = np.sum(dbase * scale[c], axis=1)
        np.testing.assert_allclose(tau_map[c], want_tau, rtol=0,
                                   atol=2e-6 * want_tau.max())
    return max(errs)


@pytest.mark.parametrize("reynolds_gaunt", [True, False])
def test_emergent_tiles_dense_matches_f64(reynolds_gaunt):
    """Multi-channel compacted emergent scan (both gaunt branches, no
    bursts, every tile of a dense jet present) vs the f64 oracle."""
    err = _emergent_case((12, 40, 130), dict(block_x=8, block_z=128,
                                             y_chunk=8), 1, False,
                         reynolds_gaunt)
    assert err < 1e-5, err


@pytest.mark.parametrize("with_bursts", [False, True])
def test_emergent_tiles_sparse_matches_f64(with_bursts):
    """The compacted ordered emergent scan (sorted jet-occupied tiles,
    segment attenuation across tiles, burst factor per tile) with
    inactive tiles and an empty leading y range."""
    err = _emergent_case((16, 48, 130), dict(block_x=8, block_z=128,
                                             y_chunk=16), 5, with_bursts)
    # with bursts, the f32 epoch time minus an f32 launch time of ~3e7 s
    # is good to ~2 s, which these sharp test bursts (sigma 2.4e6 s,
    # amplitude 2-4) turn into ~2e-5 of chi^2
    assert err < (5e-5 if with_bursts else 1e-5), err


class TestEmergentF32Decomposition:
    """The f32 emergent-scan deviation is float32 summation-order noise,
    not a formulation error: (a) the compacted tile form lands within a
    small factor of the f32 XLA full-cube scan's own deviation from f64;
    (b) an independent float64 numpy evaluation of the same algebra
    (exclusive prefix via a strictly-lower-triangular product, the expm1
    emission factor, the attenuated sum) matches the f64 XLA scan to
    ~1e-12."""

    def _setup(self):
        rng = np.random.default_rng(5)
        nx, ny, nz = 8, 64, 128
        src = rng.random((nx, ny, nz))
        dtau = 0.2 * rng.random((nx, ny, nz))
        return src, dtau

    def test_f32_xla_deviation_sets_the_scale(self):
        src, dtau = self._setup()
        i64 = np.asarray(rt.transfer_scan(jnp.asarray(src),
                                          jnp.asarray(dtau)))
        i32 = np.asarray(rt.transfer_scan(
            jnp.asarray(src, jnp.float32), jnp.asarray(dtau, jnp.float32)))
        # the tile form with a unit "source" channel: cnu = 1 and
        # hnuk chosen so cnu / expm1(hnuk / T) = src with T = 1
        tile = dict(block_x=8, block_z=128, y_chunk=16)
        f32 = jnp.float32
        inside = jnp.ones(src.shape, bool)
        ids, seg, jt, it, kt = tiles.active_tiles_scan_order(inside, **tile)
        ids_d = jnp.asarray(ids)
        hnuk_t = np.log1p(1.0 / src)           # per-cell hnuk / T
        parts, _ = tiles.emergent_ff_tiles(
            jnp.ones(1, f32), jnp.ones(1, f32), jnp.ones(1, f32),
            tiles.gather_tiles(jnp.flip(jnp.asarray(1.0 / hnuk_t, f32), 1),
                               ids_d, fill=1.0, **tile),
            tiles.gather_tiles(jnp.flip(jnp.asarray(dtau, f32), 1), ids_d,
                               **tile),
            tiles.gather_tiles(jnp.ones(src.shape, f32), ids_d, fill=1.0,
                               **tile),
            jnp.asarray(seg), jnp.asarray(jt), 0.0, (), int(seg.max()) + 1,
            4)
        it_ = tiles.scatter_tile_maps(parts, jnp.asarray(it),
                                      jnp.asarray(kt), 1, 1, 8, 128)[0]
        scale = np.max(np.abs(i64))
        e_xla32 = np.max(np.abs(i32 - i64)) / scale
        e_tiles = np.max(np.abs(np.asarray(it_) - i64)) / scale
        assert e_xla32 > 1e-8          # f32 noise is real at this depth
        assert e_tiles < 10 * e_xla32

    def test_f64_replication_proves_formulation(self):
        src, dtau = self._setup()
        i64 = np.asarray(rt.transfer_scan(jnp.asarray(src),
                                          jnp.asarray(dtau)))
        # the algebra in float64 numpy: observer at +y, so flip;
        # exclusive prefix via the strictly-lower-triangular product;
        # emission factor src*(1-e^-dtau); attenuated sum
        d_o = dtau[:, ::-1, :]
        s_o = src[:, ::-1, :]
        ny = d_o.shape[1]
        l_excl = np.tril(np.ones((ny, ny)), k=-1)
        out = np.empty((d_o.shape[0], d_o.shape[2]))
        for ix in range(d_o.shape[0]):
            p = l_excl @ d_o[ix]                       # exclusive prefix
            w = np.exp(-p)
            emit = s_o[ix] * (-np.expm1(-d_o[ix]))
            out[ix] = np.sum(emit * w, axis=0)
        np.testing.assert_allclose(out, i64, rtol=1e-12)


class TestVoigtF32Evaluators:
    """The float32 Voigt evaluators of the RRL tile path
    (ops.voigt.voigt_re_*) against scipy's Faddeeva function in each
    one's domain."""

    @staticmethod
    def _grid(far):
        x = np.linspace(0.0, 40.0, 401)
        y = np.geomspace(1e-5, 30.0, 61)
        xx, yy = np.meshgrid(x, y)
        s = xx + yy
        sel = s > 8.0 if far else s <= 8.0
        return xx[sel], yy[sel]

    def test_far_series(self):
        from scipy.special import wofz
        from rajepy_tpu.ops.voigt import voigt_re_far
        x, y = self._grid(far=True)
        got = np.asarray(voigt_re_far(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(y, jnp.float32)))
        assert np.max(np.abs(got - wofz(x + 1j * y).real)) < 1e-6

    def test_weideman16(self):
        from scipy.special import wofz
        from rajepy_tpu.ops.voigt import voigt_re_weideman, weideman16
        ell, coeffs = weideman16()
        x, y = self._grid(far=False)
        got = np.asarray(voigt_re_weideman(
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
            ell=ell, coeffs=coeffs))
        assert np.max(np.abs(got - wofz(x + 1j * y).real)) < 2e-6

    def test_mixed_selects_per_element(self):
        """voigt_re_mixed selects per element and is finite everywhere,
        including at the origin and the far series' singular region."""
        from scipy.special import wofz
        from rajepy_tpu.ops.voigt import voigt_re_mixed, weideman16
        ell, coeffs = weideman16()
        x = np.concatenate([self._grid(True)[0], self._grid(False)[0],
                            [0.0, 1e-3]])
        y = np.concatenate([self._grid(True)[1], self._grid(False)[1],
                            [0.0, 0.0]])
        got = np.asarray(voigt_re_mixed(
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
            ell=ell, coeffs=coeffs))
        assert np.isfinite(got).all()
        assert np.max(np.abs(got - wofz(x + 1j * y).real)) < 2e-6
