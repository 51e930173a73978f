"""RRL optical depths over compacted jet-occupied tiles: the Triton-route
Pallas kernel (in the Pallas interpreter here) and the XLA tile form
against float64 rt.tau_rrl_maps."""
import numpy as np
import pytest
import jax.numpy as jnp

from rajepy_tpu.ops import radtrans as rt
from rajepy_tpu.ops import tiles
from rajepy_tpu.ops.rrl_tiles import rrl_tiles_pallas, rrl_tiles_xla

_TILE = dict(block_x=8, block_z=128, y_chunk=16)


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    inside = rng.random(shape) < 0.3
    temp = np.where(inside, 1e4 * (1 + 0.2 * rng.random(shape)), 1.0)
    n_es = np.where(inside, 1e7 * rng.random(shape), 0.0)
    vy = np.where(inside, 40 * rng.standard_normal(shape), 0.0)
    ds = np.where(inside, 7.5e12, 0.0)
    return temp, n_es, vy, ds, inside


def _tile_maps(partials, fields, freqs, tile=_TILE, **kw):
    """(n_chan, nx, nz) maps through ``partials`` on compacted f32
    tiles of ``fields``."""
    temp, n_es, vy, ds, inside = fields
    coeffs = rt.RRLCoeffs('H58a')
    ids, seg = tiles.active_tiles(jnp.asarray(inside), **tile)
    assert ids.size
    ids_d = jnp.asarray(ids)
    f32 = jnp.float32

    def g(a, fill=0.0):
        return tiles.gather_tiles(jnp.asarray(a), ids_d, fill=fill, **tile)

    fac = rt.tau_rrl_tile_factors(
        coeffs, freqs, g(temp.astype(np.float32), 1.0),
        g(n_es.astype(np.float32)), g(vy.astype(np.float32)),
        g(ds.astype(np.float32)), g(inside, False))
    assert all(a.dtype == f32 for a in fac)
    parts = partials(*fac, nu0=coeffs.nu0, **kw)
    return np.asarray(tiles.segment_tile_maps(parts, jnp.asarray(seg),
                                              inside.shape[0],
                                              inside.shape[2]))


def _reference(fields, freqs):
    temp, n_es, vy, ds, inside = map(jnp.asarray, fields)
    return np.asarray(rt.tau_rrl_maps(rt.RRLCoeffs('H58a'),
                                      jnp.asarray(freqs), temp, n_es, vy,
                                      ds, inside))


def _err(got, ref, floor=1e-6):
    """Max error relative to each channel map's maximum."""
    assert got.shape == ref.shape
    return max(np.max(np.abs(g - r)) / max(np.max(np.abs(r)), floor)
               for g, r in zip(got, ref))


@pytest.mark.parametrize("shape", [(8, 24, 128), (16, 40, 130)])
def test_kernel_matches_f64(shape):
    """The Triton kernel (interpreted) vs float64, including a grid
    whose z extent pads the last tile."""
    fields = _fields(shape)
    coeffs = rt.RRLCoeffs('H58a')
    freqs = np.linspace(coeffs.nu0 - 5e6, coeffs.nu0 + 5e6, 12)
    got = _tile_maps(rrl_tiles_pallas, fields, freqs, interpret=True)
    assert _err(got, _reference(fields, freqs)) < 1e-5


@pytest.mark.parametrize("shape", [(8, 24, 128), (16, 48, 130)])
def test_xla_tile_form_matches_f64(shape):
    """The XLA tile form (the path off the GPU) through
    rt.tau_rrl_maps_tiles vs float64, with fully-empty tile rows and a
    padded grid; kernel and XLA form agree to f32 rounding."""
    temp, n_es, vy, ds, inside = _fields(shape, seed=7)
    inside[: shape[0] // 2] = False
    fields = (np.where(inside, temp, 1.0), np.where(inside, n_es, 0.0),
              np.where(inside, vy, 0.0), np.where(inside, ds, 0.0), inside)
    coeffs = rt.RRLCoeffs('H58a')
    freqs = np.linspace(coeffs.nu0 - 5e6, coeffs.nu0 + 5e6, 6)
    ids, seg = tiles.active_tiles(jnp.asarray(inside), **_TILE)
    ids_d = jnp.asarray(ids)

    def g(a, fill=0.0):
        return tiles.gather_tiles(jnp.asarray(a), ids_d, fill=fill, **_TILE)

    f32 = np.float32
    got = np.asarray(rt.tau_rrl_maps_tiles(
        coeffs, freqs, g(fields[0].astype(f32), 1.0),
        g(fields[1].astype(f32)), g(fields[2].astype(f32)),
        g(fields[3].astype(f32)), g(inside, False), jnp.asarray(seg),
        shape[0], shape[2]))
    assert _err(got, _reference(fields, freqs)) < 1e-5
    kern = _tile_maps(rrl_tiles_pallas, fields, freqs, interpret=True)
    np.testing.assert_allclose(kern, got, rtol=0,
                               atol=1e-6 * np.abs(got).max())


def test_kernel_line_profile_shape():
    # tau spectrum at the brightest pixel is a line profile peaking at the
    # (Doppler-shifted) centre
    temp, n_es, vy, ds, inside = _fields((8, 16, 128), seed=3)
    fields = (temp, n_es, np.zeros_like(vy), ds, inside)  # no shift
    coeffs = rt.RRLCoeffs('H58a')
    freqs = np.linspace(coeffs.nu0 - 8e6, coeffs.nu0 + 8e6, 33)
    got = _tile_maps(rrl_tiles_pallas, fields, freqs, interpret=True)
    ix = np.unravel_index(np.argmax(got[16]), got[16].shape)
    spectrum = got[:, ix[0], ix[1]]
    assert np.argmax(spectrum) == 16  # centre channel
    assert spectrum[0] < 0.5 * spectrum[16]  # wings fall off


def _branches(fields, freqs, tile):
    """Which of the kernel's per-(block, channel) branches — all-far
    wings, all-near core, mixed — these fields and channels take, at the
    kernel's z block width."""
    from rajepy_tpu.ops import rrl_tiles
    temp, n_es, vy, ds, inside = fields
    coeffs = rt.RRLCoeffs('H58a')
    ids, _ = tiles.active_tiles(jnp.asarray(inside), **tile)
    ids_d = jnp.asarray(ids)

    def g(a, fill=0.0):
        return tiles.gather_tiles(jnp.asarray(a), ids_d, fill=fill, **tile)

    fo, amp, rest, scale, yv, _ = rt.tau_rrl_tile_factors(
        coeffs, freqs, g(temp, 1.0), g(n_es), g(vy), g(ds),
        g(inside, False))
    bz = rrl_tiles._BZ
    live = np.asarray(amp) > 0

    def blocks(a):
        n_act, bx, yc, nz = a.shape
        return a.reshape(n_act, bx, yc, nz // bz, bz).transpose(
            0, 1, 3, 2, 4).reshape(-1, yc * bz)

    out = set()
    for f in np.asarray(fo):
        s = np.abs((f - np.asarray(rest)) * np.asarray(scale)) + \
            np.asarray(yv)
        lo = blocks(np.where(live, s, 9.0)).min(axis=1)
        hi = blocks(np.where(live, s, 0.0)).max(axis=1)
        out |= {'far' for v in lo if v > 8}
        out |= {'core' for v in hi if v <= 8}
        out |= {'mixed' for a, b in zip(lo, hi) if a <= 8 < b}
    return out


def test_wing_fast_path_wide_band():
    """A wide band takes the kernel's all-far branch (Weideman skipped)
    and the mixed branch in one dispatch; every channel map must match
    float64 relative to its own (tiny, in the wings) maximum."""
    fields = _fields((8, 24, 128), seed=11)
    coeffs = rt.RRLCoeffs('H58a')
    # centre channel, near wing, and channels 30-3,000 Doppler widths out
    freqs = coeffs.nu0 + np.array([0.0, 1e6, 1e7, 1e8, 1e9])
    tile = dict(block_x=8, block_z=128, y_chunk=8)
    ref = _reference(fields, freqs)
    assert np.max(ref[-1]) > 0          # Lorentzian wings are not zero
    for partials, kw in ((rrl_tiles_pallas, dict(interpret=True)),
                         (rrl_tiles_xla, {})):
        got = _tile_maps(partials, fields, freqs, tile, **kw)
        assert _err(got, ref, floor=0.0) < 1e-5
    assert {'far', 'mixed'} <= _branches(fields, freqs, tile)


def test_all_near_core_branch():
    """A low-density jet (tiny Stark y) at line-centre channels makes
    every (block, channel) pair all-near, so the kernel runs the branch
    that skips the wing series entirely — and must still match."""
    temp, n_es, vy, ds, inside = _fields((8, 24, 128), seed=3)
    fields = (temp, n_es * 1e-3, vy * 0.3, ds, inside)
    coeffs = rt.RRLCoeffs('H58a')
    freqs = coeffs.nu0 + np.array([-5e5, 0.0, 5e5])
    got = _tile_maps(rrl_tiles_pallas, fields, freqs, interpret=True)
    assert _err(got, _reference(fields, freqs)) < 1e-5
    assert _branches(fields, freqs, _TILE) == {'core'}
