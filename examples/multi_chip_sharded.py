#!/usr/bin/env python3
"""Multi-chip execution over a jax.sharding.Mesh: the voxel grid sharded
along the line of sight (context-parallel analogue) with XLA-inserted
collectives, channels fanned out over a second mesh axis, and epochs
fanned across devices.

Runs on the cards of one host or on a virtual CPU mesh:
    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/multi_chip_sharded.py
"""
import numpy as np
import jax
import jax.numpy as jnp

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import rajepy_tpu
from rajepy_tpu import JetModel
from rajepy_tpu.parallel import sharding

print("devices:", jax.devices())
n_dev = jax.device_count()
n_chan_axis = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
mesh = sharding.make_mesh(n_los=n_dev // n_chan_axis, n_chan=n_chan_axis)
print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))

params = JetModel.py_to_dict(
    rajepy_tpu.cfg.dcys['files'] + '/example-model-params.py')
params['grid'].update(n_x=64, n_y=16 * (n_dev // n_chan_axis), n_z=64,
                      l_z=None)
jm = JetModel(params)

freqs = jnp.linspace(1e9, 5e10, 4 * n_chan_axis)
with mesh:
    step = sharding.sharded_rt_products(
        mesh, jm.params['properties']['T_0'], False, jm.csize,
        jm.params['target']['dist'])
    # the grid fill itself runs mesh-sharded: no unsharded cube is ever
    # materialised, so the model size is bounded by POD memory, not by
    # one device's HBM (shard_fields would reshard a single-device fill)
    fs = sharding.sharded_static_fields(
        mesh, jm._static_params(), jm._ss_jml_rb_frac,
        jm.nx, jm.ny, jm.nz, jm.csize, with_time=jm._has_bursts)
    em, taus, fluxes = step(
        jax.device_put(freqs, sharding.chan_sharding(mesh)),
        fs.nd, fs.xi, fs.temp, fs.ff, fs.area, fs.inside)
print("EM map:", em.shape, "| flux maps:", fluxes.shape,
      "| total S(6GHz)~ %.3e Jy" % float(jnp.sum(fluxes[0])))

# epoch fan-out across every device
lc = sharding.light_curve_sharded(jm, np.linspace(0., 2., 2 * n_dev),
                                  freqs[:2])
print("sharded light curve:", lc.shape)

# run-level fan-out: a whole group of pipeline runs (epoch x frequency)
# evaluated in ONE sharded program — what Pipeline.execute does
# automatically on any multi-device backend (device_fanout=None default)
from rajepy_tpu.parallel import fanout

years = np.linspace(0.0, 2.0, n_dev)
freqs_mat = np.tile(np.array([6e9, 2.2e10]), (n_dev, 1))
em_r, tau_r, flux_r = fanout.continuum_runs_fanout(jm, years, freqs_mat)
print("fanned runs:", flux_r.shape,
      "| per-run totals:", np.round(flux_r.sum(axis=(1, 2, 3)), 6))
