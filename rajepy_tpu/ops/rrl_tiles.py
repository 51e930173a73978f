"""RRL optical-depth partial maps over compacted jet-occupied tiles.

Both functions take the channel-independent per-cell factors of
:func:`rajepy_tpu.ops.radtrans.tau_rrl_precompute`, gathered onto the
jet-occupied tiles of :mod:`rajepy_tpu.ops.tiles` and cast to float32,
and return per-tile partial LOS sums (n_act, n_chan, bx, bz):

* :func:`rrl_tiles_xla` — plain JAX, one ``lax.map`` step per channel;
  every step re-reads all five factor streams.
* :func:`rrl_tiles_pallas` — a Pallas kernel on the Triton route.  Each
  program loads one (y_chunk, _BZ) block of the five factors into
  registers once and runs a block of ``_CB`` channels over it, summing
  along y inside the program.  The product is bound by the Voigt
  arithmetic (Weideman-16 recurrence plus the 3-term wing series per cell
  and channel), which the kernel also trims per (block, channel): a block
  whose jet cells are all in the far wings skips the Weideman recurrence,
  and one whose jet cells are all near the line centre skips the wing
  series.  Cells off the jet (amp = 0) do not take part in that choice.

Frequencies arrive as offsets from the line centre nu0, so float32 keeps
~10 Hz resolution (an absolute ~1.5e10 Hz quantises at ~2 kHz).
:func:`rrl_tile_partials` picks the kernel on a GPU and the XLA form
elsewhere (ops.paths.use_triton_rrl).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from . import paths
from .voigt import voigt_re_far, voigt_re_mixed, voigt_re_weideman, \
    weideman16

# Block shape of the Triton kernel: _BZ z lanes of a tile row by the
# tile's whole y extent, and _CB channels per program.  Powers of two, as
# Triton requires; a (64, 16) f32 block of five factors is 20 KB, held in
# registers across the channel block.
_BZ = 16
_CB = 16
_NUM_WARPS = 4


def rrl_tiles_xla(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t,
                  nu0: float):
    """Per-tile partial RRL optical depths (n_act, n_chan, bx, bz), plain
    JAX: the same arithmetic as :func:`rrl_tiles_pallas`, evaluated
    branch-free for every (cell, channel)."""
    ell, coeffs = weideman16()

    def one_channel(fo):
        x = (fo - rest_t) * scale_t
        stim = -jnp.expm1(-(fo + nu0) * hkt_t)
        re = voigt_re_mixed(x, yv_t, ell=ell, coeffs=coeffs)
        return jnp.sum(amp_t * re * stim, axis=2)

    return lax.map(one_channel, freqs_off).transpose(1, 0, 2, 3)


def _rrl_kernel(freqs_ref, amp_ref, rest_ref, scale_ref, yv_ref, hkt_ref,
                out_ref, *, nu0: float, ell: float, coeffs: tuple):
    """One program: a (y_chunk, _BZ) block of one tile row, _CB channels.
    Writes the (_CB, _BZ) LOS sums of amp * Re[w] * (1 - e^{-h nu/kT})."""
    amp = amp_ref[...]
    rest = rest_ref[...]
    scale = scale_ref[...]
    yv = yv_ref[...]
    hkt = hkt_ref[...]
    cb, bz = out_ref.shape
    row_id = lax.broadcasted_iota(jnp.int32, (cb, bz), 0)
    live = amp > 0.0

    def core(x):
        return voigt_re_weideman(x, yv, ell=ell, coeffs=coeffs)

    def mixed(x):
        return voigt_re_mixed(x, yv, ell=ell, coeffs=coeffs)

    def wings(x):
        # off-jet cells may sit at the series' singular point x = y = 0
        return voigt_re_far(jnp.where(live, x, 10.0), yv)

    def channel(c, acc):
        fo = freqs_ref[c]
        x = (fo - rest) * scale
        stim = -jnp.expm1(-(fo + nu0) * hkt)
        s = jnp.abs(x) + yv
        all_far = jnp.min(jnp.where(live, s, 9.0)) > 8.0
        any_far = jnp.max(jnp.where(live, s, 0.0)) > 8.0
        branch = jnp.where(all_far, 2, jnp.where(any_far, 1, 0))
        re = lax.switch(branch, (core, mixed, wings), x)
        row = jnp.sum(amp * re * stim, axis=0)
        return jnp.where(row_id == c, row[None, :], acc)

    out_ref[...] = lax.fori_loop(jnp.int32(0), jnp.int32(cb), channel,
                                 jnp.zeros((cb, bz), out_ref.dtype))


@functools.partial(jax.jit, static_argnames=('nu0', 'interpret'))
def rrl_tiles_pallas(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t,
                     nu0: float, interpret: bool = False):
    """Per-tile partial RRL optical depths (n_act, n_chan, bx, bz) through
    the Triton-route Pallas kernel.  ``interpret=True`` runs it in the
    Pallas interpreter (CPU tests)."""
    n_chan = int(freqs_off.shape[0])
    n_act, bx, yc, bz = amp_t.shape
    if bz % _BZ:
        raise ValueError(f"tile z width {bz} is not a multiple of {_BZ}")
    n_cb = -(-n_chan // _CB)
    pad = n_cb * _CB - n_chan
    if pad:   # repeat the last channel; its rows are sliced off below
        freqs_off = jnp.concatenate(
            [freqs_off, jnp.broadcast_to(freqs_off[-1:], (pad,))])
    ell, coeffs = weideman16()
    kernel = functools.partial(_rrl_kernel, nu0=float(nu0), ell=ell,
                               coeffs=coeffs)
    cell_spec = pl.BlockSpec((None, None, yc, _BZ),
                             lambda a, x, zb, cb: (a, x, 0, zb))
    out = pl.pallas_call(
        kernel,
        grid=(n_act, bx, bz // _BZ, n_cb),
        in_specs=[pl.BlockSpec((_CB,), lambda a, x, zb, cb: (cb,))] +
                 [cell_spec] * 5,
        out_specs=pl.BlockSpec((None, _CB, None, _BZ),
                               lambda a, x, zb, cb: (a, cb, x, zb)),
        out_shape=jax.ShapeDtypeStruct((n_act, n_cb * _CB, bx, bz),
                                       amp_t.dtype),
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name='rrl_tiles',
    )(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t)
    return out[:, :n_chan]


def rrl_tile_partials(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t,
                      nu0: float):
    """Per-tile partial RRL optical depths by the implementation this
    platform runs (see the module docstring)."""
    fn = rrl_tiles_pallas if paths.use_triton_rrl() else rrl_tiles_xla
    return fn(freqs_off, amp_t, rest_t, scale_t, yv_t, hkt_t, nu0=nu0)
