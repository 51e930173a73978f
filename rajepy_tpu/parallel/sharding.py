"""Device-mesh sharding of the radiative-transfer step.

The reference is strictly single-process (SURVEY §2.9: no parallelism of
any kind; README.md:379 lists it as future work).  The device-mesh
equivalents built here:

* **LOS (sequence/context-parallel analogue)** — the voxel grid is sharded
  along the line-of-sight axis (y); every RT product is an associative
  masked reduction along that axis (SURVEY §5.7), so under ``jit`` with
  `NamedSharding` annotations XLA partitions the elementwise work and
  inserts the `psum`/reduce-scatter collectives automatically.
* **Channel data-parallelism** — frequency channels are independent;
  sharding the channel axis fans the per-channel maps out across devices
  with no communication at all.
* **Epoch/frequency fan-out** — whole runs are embarrassingly parallel
  (classes.py:2358's sequential loop); :mod:`rajepy_tpu.parallel.fanout`
  evaluates a whole group of pipeline runs in one sharded program, and
  `Pipeline.execute` uses it automatically on multi-device backends.

Everything works on any `jax.sharding.Mesh` — the cards of one host or
the virtual `xla_force_host_platform_device_count` CPU mesh used in
tests.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import radtrans as rt

LOS_AXIS = rt.LOS_AXIS


def make_mesh(n_los: Optional[int] = None, n_chan: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('chan', 'los') device mesh.  By default all devices go to the
    LOS axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_los is None:
        n_los = len(devices) // n_chan
    dev_arr = np.array(devices[:n_chan * n_los]).reshape(n_chan, n_los)
    return Mesh(dev_arr, axis_names=('chan', 'los'))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Voxel grids (nx, ny, nz) sharded along the LOS (y) axis."""
    return NamedSharding(mesh, P(None, 'los', None))


def chan_sharding(mesh: Mesh) -> NamedSharding:
    """Per-channel arrays sharded along the channel axis."""
    return NamedSharding(mesh, P('chan'))


def map_sharding(mesh: Mesh) -> NamedSharding:
    """Collapsed (n_chan, nx, nz) maps: channel axis sharded, image
    replicated."""
    return NamedSharding(mesh, P('chan', None, None))


def shard_fields(fields, mesh: Mesh):
    """Device-put every grid in a StaticFields pytree with LOS sharding."""
    sh = grid_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sh) if jnp.ndim(a) == 3 else a, fields)


def sharded_static_fields(mesh: Mesh, static_params, rb_frac: float,
                          nx: int, ny: int, nz: int, csize: float,
                          dtype=None, with_time: bool = True):
    """Mesh-sharded grid fill: build every static field cube already
    LOS-sharded, so a model whose working set exceeds one device's HBM
    can be constructed on a pod without EVER materialising an unsharded
    cube (``shard_fields`` reshards after a single-device fill and so
    still pays the full-cube peak).

    The fill (:func:`rajepy_tpu.models.fields.compute_static_fields`) is
    per-cell pure — geometry, power laws and the closed-form travel-time
    integral have no cross-cell terms (the reference likewise evaluates
    cell-by-cell, classes.py:521-870) — so pinning LOS-sharded
    ``out_shardings`` makes XLA partition all the elementwise work with
    zero collectives.  The inputs are the (nx,1,1)/(1,ny,1)/(1,1,nz)
    broadcastable index arrays, bytes-free either way.  Outputs feed
    :func:`sharded_rt_products` / :func:`sharded_rrl_tau_maps` directly.

    ``static_params``/``rb_frac`` as JetModel passes them
    (``JetModel._static_params()`` / ``_ss_jml_rb_frac``); ``ny`` must
    tile over the mesh's 'los' axis.
    """
    fill, coords = _fill_program(mesh, static_params, rb_frac, nx, ny,
                                 nz, csize, dtype, with_time)
    return fill(*coords)


def _freeze(obj):
    """Nested dicts/lists of scalars -> a hashable key."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


_FILL_PROGRAMS: dict = {}


def _fill_program(mesh: Mesh, static_params, rb_frac, nx, ny, nz, csize,
                  dtype, with_time):
    """(jitted LOS-sharded fill, its coordinate args) — shared by
    :func:`sharded_static_fields` and :func:`fill_memory_stats`.

    Memoised on the full argument key so both entry points reuse ONE jit
    object (and so one compile: ``lower().compile()`` and the call path
    share the dispatch cache only for the same function object) — a
    dryrun calling ``sharded_static_fields`` then ``fill_memory_stats``
    at the same shape previously compiled the identical SPMD program
    twice."""
    from ..models import grid as mgrid
    from ..models.fields import StaticFields, compute_static_fields
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    key = (mesh, _freeze(static_params), float(rb_frac), nx, ny, nz,
           float(csize), np.dtype(dtype).name, bool(with_time))
    hit = _FILL_PROGRAMS.get(key)
    if hit is not None:
        return hit
    sh = grid_sharding(mesh)
    out_sh = StaticFields(*([sh] * len(StaticFields._fields)))

    @partial(jax.jit, out_shardings=out_sh)
    def fill(xx, yy, zz):
        return compute_static_fields(static_params, xx, yy, zz, rb_frac,
                                     with_time=with_time)

    out = fill, mgrid.grid_corner_coords(nx, ny, nz, csize, dtype)
    if len(_FILL_PROGRAMS) > 32:   # bound the per-process cache
        _FILL_PROGRAMS.clear()
    _FILL_PROGRAMS[key] = out
    return out


def fill_memory_stats(mesh: Mesh, static_params, rb_frac: float,
                      nx: int, ny: int, nz: int, csize: float,
                      dtype=None, with_time: bool = True):
    """Compiler-reported PER-DEVICE bytes for the mesh-sharded grid fill.

    Proves the beyond-single-HBM claim (SURVEY §2.9(b)): XLA's buffer
    assignment for the SPMD fill program gives the true per-device live
    footprint (arguments + outputs + temporaries), so a test can assert
    ``per_device_bytes < full cube-set bytes`` — i.e. a model too big
    for one device's HBM really builds shard-by-shard across the mesh.

    Returns ``{'per_device_bytes', 'full_output_bytes', 'n_los'}`` or
    ``None`` when the backend doesn't expose
    :meth:`~jax.stages.Compiled.memory_analysis` (assert availability in
    tests — the CPU backend supports it).
    """
    from ..models.fields import StaticFields  # noqa: F401 — doc link
    fill, coords = _fill_program(mesh, static_params, rb_frac, nx, ny,
                                 nz, csize, dtype, with_time)
    lowered = fill.lower(*coords)
    ma = lowered.compile().memory_analysis()
    if ma is None:
        return None
    n_los = int(mesh.shape['los'])
    per_dev = (int(ma.argument_size_in_bytes) +
               int(ma.output_size_in_bytes) +
               int(ma.temp_size_in_bytes))
    # the full cube-set size comes from the LOGICAL output shapes
    # (sharding-independent), NOT per_device * n_los: if XLA replicated
    # the outputs, per_device_output_bytes would itself be the full size
    # and a derived 'full' would hide it (r5 review).  The lowered
    # program already knows its output avals — no second trace
    try:
        abstract = lowered.out_info
    except AttributeError:      # older jax.stages without out_info
        abstract = jax.eval_shape(fill, *coords)
    leaf_bytes = [
        int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for leaf in jax.tree_util.tree_leaves(abstract)]
    return {'per_device_bytes': per_dev,
            'per_device_output_bytes': int(ma.output_size_in_bytes),
            'full_output_bytes': sum(leaf_bytes),
            # replication detection threshold: replicating even the
            # SMALLEST output cube inflates the per-device share by
            # (n_los-1)/n_los of this, far above buffer alignment
            'min_leaf_bytes': min(leaf_bytes),
            'n_los': n_los}


def sharded_continuum_step(mesh: Mesh, t_0: float, reynolds_gaunt: bool):
    """Build the jit-compiled multi-device continuum RT step.

    Inputs arrive LOS-sharded; the masked LOS sum runs locally per shard
    and XLA inserts the inter-device reduction; the resulting per-channel
    maps are produced with the channel axis sharded across the 'chan' mesh
    axis.  Returns fn(freqs, temp, n_es, ds_cm, inside) -> tau maps
    (n_chan, nx, nz).
    """

    @partial(jax.jit,
             out_shardings=map_sharding(mesh),
             static_argnames=())
    def step(freqs, temp, n_es, ds_cm, inside):
        return rt.tau_ff_maps(freqs, temp, n_es, ds_cm, inside, t_0,
                              reynolds_gaunt)

    return step


def sharded_rt_products(mesh: Mesh, t_0: float, reynolds_gaunt: bool,
                        csize_au: float, dist_pc: float):
    """Full sharded RT step: EM map, per-channel tau maps, flux maps.

    This is the multi-chip 'training-step' equivalent used by
    ``__graft_entry__.dryrun_multichip``: grids sharded over 'los',
    channels over 'chan', outputs assembled through XLA collectives.
    """

    @partial(jax.jit, out_shardings=(NamedSharding(mesh, P(None, None)),
                                     map_sharding(mesh),
                                     map_sharding(mesh)))
    def step(freqs, nd, xi, temp, ff, area, inside):
        n_es = nd * xi
        ds = rt.path_length_cm(ff, area, csize_au)
        em = rt.emission_measure_map(nd, xi, ff, area, csize_au)
        taus = rt.tau_ff_maps(freqs, temp, n_es, ds, inside, t_0,
                              reynolds_gaunt)
        tbar, any_in = rt.mean_temperature_map(temp, inside)
        fluxes = rt.flux_ff_maps(freqs, taus, tbar, any_in, csize_au,
                                 dist_pc)
        return em, taus, fluxes

    return step


def sharded_rrl_tau_maps(mesh: Mesh, coeffs, freqs, temp, n_es, vy, ds_cm,
                         inside):
    """Collapsed RRL optical-depth maps on a ('chan', 'los') mesh.

    The most expensive product (the RRL cube, classes.py:1130-1229) sharded
    both ways: channels split over the 'chan' mesh axis with zero
    communication; the voxel grid split along the LOS (y) axis, each shard
    computing its local masked sum, combined with one `psum` over 'los'
    (SURVEY §5.7's context-parallel analogue).  Returns (n_chan, nx, nz)
    with the channel axis sharded.
    """
    from ..ops import radtrans as rt

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P('chan'), P(None, 'los', None), P(None, 'los', None),
                       P(None, 'los', None), P(None, 'los', None),
                       P(None, 'los', None)),
             out_specs=P('chan', None, None))
    def step(freqs_l, temp_l, n_es_l, vy_l, ds_l, inside_l):
        partial_maps = rt.tau_rrl_maps(coeffs, freqs_l, temp_l, n_es_l,
                                       vy_l, ds_l, inside_l)
        return jax.lax.psum(partial_maps, 'los')

    return jax.jit(step)(freqs, temp, n_es, vy, ds_cm, inside)


def sharded_transfer_scan(mesh: Mesh, source, dtau,
                          observer_near_y0: bool = False):
    """Ordered LOS transfer integral sharded along the LOS axis.

    Each LOS shard runs the local ordered scan, producing its shard's
    emergent intensity I_s and total opacity tau_s; shards compose through
    the (attenuation, accumulated-intensity) monoid

        I = sum_s I_s * exp(-sum_{t in front of s} tau_t)

    with a single small all_gather of the (nx, nz) shard opacities over
    'los' — the one genuinely non-trivial collective this workload owns
    (the LOS analogue of ring/context parallelism for attention).

    Returns (intensity, tau_total), both (nx, nz), replicated; equal to
    ops.radtrans.transfer_scan / summed dtau on one device.
    """
    from ..ops import radtrans as rt

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(None, 'los', None), P(None, 'los', None)),
             out_specs=(P(None, None), P(None, None)))
    def step(src_l, dtau_l):
        i_loc = rt.transfer_scan(src_l, dtau_l,
                                 observer_near_y0=observer_near_y0)
        tau_loc = jnp.sum(dtau_l, axis=LOS_AXIS)
        idx = jax.lax.axis_index('los')
        taus = jax.lax.all_gather(tau_loc, 'los')       # (n_shards, nx, nz)
        n_shards = taus.shape[0]
        shard_ids = jnp.arange(n_shards)[:, None, None]
        # shards in front of this one (between it and the observer)
        in_front = (shard_ids < idx) if observer_near_y0 \
            else (shard_ids > idx)
        tau_front = jnp.sum(jnp.where(in_front, taus, 0.0), axis=0)
        total_i = jax.lax.psum(i_loc * jnp.exp(-tau_front), 'los')
        total_tau = jax.lax.psum(tau_loc, 'los')
        return total_i, total_tau

    return jax.jit(step)(source, dtau)


def sharded_clean_cube(mesh: Mesh, uvw_m, freqs, vis_re, vis_im, weights,
                       n_pix: int, cell_rad: float, mask, beam_kernel,
                       **clean_kwargs):
    """Cube imaging with the channel axis sharded over the 'chan' mesh
    axis: each device grids, FFTs, CLEANs and restores its own channel
    shard with zero communication (channels are independent — the
    synthetic-observation analogue of data parallelism; the reference
    tclean cube at classes.py:2771-2782 is strictly sequential).

    Arguments mirror :func:`rajepy_tpu.synthobs.imaging.clean_cube`;
    ``n_chan`` must divide by the mesh's 'chan' extent.  Returns
    (restored, dirty), channel-sharded (n_chan, n_pix, n_pix).

    The channel axis is dispatched in chunks of 256 channels PER DEVICE
    from the host, which bounds peak device memory: chunking inside the
    jitted shard_map would just unroll into one long device program
    (see imaging.clean_cube).
    """
    from ..synthobs import imaging

    # chunking happens HERE at the global level: a caller-supplied
    # chan_chunk bounds each DEVICE's per-dispatch channel count (it must
    # not reach the traced per-shard call, whose host-chunking branch
    # cannot run under a trace)
    per_dev_chunk = int(clean_kwargs.pop('chan_chunk', 256))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(None, None), P('chan'), P('chan', None),
                       P('chan', None), P(None), P(None, None),
                       P(None, None)),
             out_specs=(P('chan', None, None), P('chan', None, None)))
    def step(uvw_l, freqs_l, re_l, im_l, w_l, mask_l, kern_l):
        # each shard sees at most per_dev_chunk channels by construction;
        # forward that bound so the inner call never takes its (trace-
        # incompatible) host-chunking branch when per_dev_chunk > 256
        return imaging.clean_cube(uvw_l, freqs_l, re_l, im_l, w_l, n_pix,
                                  cell_rad, mask_l, kern_l,
                                  chan_chunk=per_dev_chunk,
                                  **clean_kwargs)

    step_j = jax.jit(step)
    uvw2 = jnp.asarray(uvw_m)[:, :2]
    freqs = jnp.asarray(freqs)
    vis_re = jnp.asarray(vis_re)
    vis_im = jnp.asarray(vis_im)
    weights = jnp.asarray(weights)
    mask = jnp.asarray(mask)
    beam_kernel = jnp.asarray(beam_kernel)

    n_chan = int(freqs.shape[0])
    n_chan_mesh = int(mesh.shape['chan'])
    max_global = per_dev_chunk * n_chan_mesh

    def dispatch(fr, vr, vi, n_valid, pad_to):
        # pad with duplicated last frequency / zero visibilities so every
        # dispatch in a chunked cube reuses ONE compiled program shape
        pad = pad_to - n_valid
        if pad:
            fr = jnp.concatenate([fr, jnp.broadcast_to(fr[-1:], (pad,))])
            zpad = jnp.zeros((pad,) + vr.shape[1:], vr.dtype)
            vr = jnp.concatenate([vr, zpad])
            vi = jnp.concatenate([vi, zpad])
        r, d = step_j(uvw2, fr, vr, vi, weights, mask, beam_kernel)
        return r[:n_valid], d[:n_valid]

    if n_chan <= max_global:
        # single dispatch, padded only to mesh divisibility
        pad_to = -(-n_chan // n_chan_mesh) * n_chan_mesh
        return dispatch(freqs, vis_re, vis_im, n_chan, pad_to)
    outs_r, outs_d = [], []
    for s in range(0, n_chan, max_global):
        e = min(s + max_global, n_chan)
        r, d = dispatch(freqs[s:e], vis_re[s:e], vis_im[s:e], e - s,
                        max_global)
        outs_r.append(r)
        outs_d.append(d)
    return jnp.concatenate(outs_r), jnp.concatenate(outs_d)


def sharded_epoch_base_map_tiles(mesh: Mesh, base_t, tss_t, seg, t,
                                 spec_r, spec_b, nx: int, nz: int,
                                 pack_offset: float = 1.0):
    """Tile-parallel LOS-collapsed sum_y base * chi(t - ts)^2 over
    COMPACTED jet-occupied tiles (ops.tiles.gather_tiles).

    The production single-chip epoch path compacts the grid to its
    jet-occupied tiles; this shards that same tile axis across ALL mesh
    devices — each device evaluates the burst factor and partial
    segment-sums for its local tiles, and one `psum` of the small
    (n_xz_tiles, bx, bz) partial maps combines them.  Works on any
    backend (pure-XLA formulation).  Returns the (nx, nz) collapsed map,
    identical to the single-device epoch map.
    """
    from ..models import ejection as ej

    axes = tuple(mesh.axis_names)
    n_dev = int(mesh.devices.size)
    n_act = base_t.shape[0]
    pad = (-n_act) % n_dev
    if pad:
        # zero base => padded tiles contribute nothing (seg 0 is safe)
        base_t = jnp.pad(base_t, ((0, pad),) + ((0, 0),) * 3)
        tss_t = jnp.pad(tss_t, ((0, pad),) + ((0, 0),) * 3,
                        constant_values=1.0)
        seg = jnp.pad(seg, (0, pad))
    bx, yc, bz = base_t.shape[1:]
    n_xt = -(-nx // bx)
    n_zt = -(-nz // bz)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axes), P(axes), P(axes), P()),
             out_specs=P(), check_vma=False)
    def step(base_l, tss_l, seg_l, t):
        red = tss_l < 0.0
        # |tss| - pack_offset recovers the (possibly negative) launch time
        chi = ej.chi_field(red, t - (jnp.abs(tss_l) - pack_offset),
                           spec_r, spec_b)
        parts = jnp.sum(base_l * chi * chi, axis=2)
        m = jax.ops.segment_sum(parts, seg_l, num_segments=n_xt * n_zt)
        m = jax.lax.psum(m, axis_name=axes)
        # reassemble inside the program: one dispatch, no eager post-ops
        m = m.reshape(n_xt, n_zt, bx, bz).transpose(0, 2, 1, 3)
        return m.reshape(n_xt * bx, n_zt * bz)[:nx, :nz]

    return jax.jit(step)(base_t, tss_t, seg, jnp.asarray(t, base_t.dtype))


def light_curve_sharded(model, times_yr, freqs,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
    """Multi-epoch light curve with epochs fanned out across all devices.

    Epochs are embarrassingly parallel (the reference iterates them
    sequentially, classes.py:2358): the time axis is sharded over a 1-D
    device mesh, static fields are replicated, and each device evaluates
    its epochs' burst factor -> opacity -> flux chain with zero
    communication.  Returns (n_times, n_chan) integrated fluxes [Jy],
    identical to models.analysis.light_curve.
    """
    from ..models import ejection as ej

    devices = mesh.devices.ravel() if mesh is not None else \
        np.array(jax.devices())
    n_dev = len(devices)
    t_mesh = Mesh(devices.reshape(-1), axis_names=('t',))

    f = model._ensure_fields()
    freqs = jnp.atleast_1d(jnp.asarray(freqs, dtype=model._dtype))
    times = np.atleast_1d(np.asarray(times_yr, dtype=float)) * 31536000.0
    n_times = len(times)
    pad = (-n_times) % n_dev
    times_p = jnp.asarray(np.pad(times, (0, pad), mode='edge'),
                          model._dtype)

    t_0 = model.params['properties']['T_0']
    reyn = model._use_reynolds_gaunt()
    csize = model.csize
    dist = model.params['target']['dist']
    spec_r, spec_b = model._spec_r, model._spec_b
    ds = rt.path_length_cm(f.ff, f.area, csize)
    tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)

    # shard_map, not jit+in_shardings: a lax.map over a sharded leading
    # axis under GSPMD is free to reshard and run the scan sequentially;
    # shard_map guarantees each device scans only ITS local epochs
    @partial(jax.shard_map, mesh=t_mesh,
             in_specs=(P('t'), P(), P(), P(), P(), P()),
             out_specs=P('t'), check_vma=False)
    def fan_out(ts_shard, f, ds, tbar, any_in, freqs):
        # all grids enter as (replicated) runtime arguments: a closure
        # would capture them as multi-GB compiled-program constants
        def per_epoch(t):
            chi = ej.chi_field(f.red, t - f.ts, spec_r, spec_b)
            n_es = f.nd * chi * f.xi
            taus = rt.tau_ff_maps(freqs, f.temp, n_es, ds, f.inside, t_0,
                                  reyn)
            fluxes = rt.flux_ff_maps(freqs, taus, tbar, any_in, csize,
                                     dist)
            return jnp.sum(fluxes, axis=(1, 2))
        return jax.lax.map(per_epoch, ts_shard)

    out = jax.jit(fan_out)(times_p, f, ds, tbar, any_in, freqs)
    return np.asarray(out)[:n_times]
