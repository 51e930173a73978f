#!/usr/bin/env python3
"""Production single-chip run: 512^3 float32 model, multi-frequency SED,
spectral-index/turnover maps, RRL cube, multi-epoch light curve.

NB first execution of each distinct kernel shape compiles (seconds);
steady-state times are well under that.

All heavy work runs as cached jitted kernels on the default device (the
GPU when available).  Float32 selects the fast Faddeeva path and the
compacted-tile products, with the Triton RRL kernel on a GPU,
automatically.
"""
import time

import numpy as np
import jax.numpy as jnp

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere without installing

import rajepy_tpu
from rajepy_tpu import JetModel
from rajepy_tpu.models import analysis

params = JetModel.py_to_dict(
    rajepy_tpu.cfg.dcys['files'] + '/example-model-params.py')
params['grid'].update(n_x=512, n_y=512, n_z=512, l_z=None, c_size=0.25)

t0 = time.perf_counter()
jm = JetModel(params, dtype=jnp.float32)
jm._ensure_fields()
print(f"grid fill (fields + travel times): {time.perf_counter()-t0:.1f}s")

# 0.3-300 GHz SED + derived maps (BASELINE config 4)
freqs = np.logspace(np.log10(3e8), np.log10(3e11), 24).astype(np.float32)
t0 = time.perf_counter()
seds = analysis.sed(jm, freqs)
alpha = analysis.spectral_index_map(jm, 5e9, 1.5e10, min_flux_jy=1e-12)
nu_turn = analysis.turnover_map(jm, freqs)
print(f"SED + index + turnover maps: {time.perf_counter()-t0:.1f}s")
print("  S(1.5GHz, 44GHz) =", seds[8], seds[18], "Jy")

# H58a RRL cube (BASELINE config 3) over the compacted jet tiles
from rajepy_tpu.ops.radtrans import RRLCoeffs
nu0 = RRLCoeffs('H58a').nu0
chans = np.linspace(nu0 - 5e6, nu0 + 5e6, 128)
t0 = time.perf_counter()
tau_cube = jm.optical_depth_rrl('H58a', chans)
print(f"H58a 128-channel cube: {time.perf_counter()-t0:.1f}s "
      f"(shape {tau_cube.shape})")

# multi-epoch light curve (BASELINE config 2)
t0 = time.perf_counter()
lc = analysis.light_curve(jm, np.linspace(0., 3., 25), [6e9, 2.2e10])
print(f"25-epoch light curve: {time.perf_counter()-t0:.1f}s; "
      f"6GHz range {lc[:,0].min():.3e} - {lc[:,0].max():.3e} Jy")

# conservation diagnostics (mass / angular momentum per r-slice, any
# inclination) and the three-projection occupancy maps — the device-side
# reductions behind plotting.diagnostic_plot / geometry_plot
t0 = time.perf_counter()
prof = jm.conservation_profiles()
proj = jm.occupancy_projections()
print(f"conservation + occupancy diagnostics: "
      f"{time.perf_counter()-t0:.1f}s; total jet mass "
      f"{prof['mass'].sum():.3e} kg over "
      f"{int((prof['mass'] > 0).sum())} r-bins")
