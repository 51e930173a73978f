"""JetModel — the physical jet model and its radiative-transfer products.

API-compatible rebuild of the reference's ``JetModel``
(classes.py:42-1713) on a functional JAX core:

* the params dict (same schema as files/example-model-params.py, with
  ``n_0`` optional/derived — fixing the validator/example mismatch noted in
  SURVEY §2.1) defines a *static* model; all grids are computed by fused,
  jit-compiled kernels in :mod:`rajepy_tpu.models.fields` and cached as
  device arrays;
* ejection bursts are data (:mod:`rajepy_tpu.models.ejection`), not nested
  closures (classes.py:383-463), so the burst factor is one fused kernel
  and models pickle cleanly;
* radiative transfer (free-free + RRL) runs through
  :mod:`rajepy_tpu.ops.radtrans`: per-channel work is factorised off the
  grid for the continuum and channel-batched via ``lax.map`` for RRL cubes
  (the reference loops channels in Python over full-grid numpy algebra,
  classes.py:1384-1400 and 1179-1189);
* public properties reproduce the reference's NaN-outside-the-jet
  convention at the API boundary; internally everything is masked and
  NaN-free.

Precision: ``dtype`` defaults to ``'auto'`` — float32 on an accelerator
(the compacted-tile production path; see :mod:`rajepy_tpu.ops.paths`) and
float64 on the CPU (oracle-grade parity, jax x64 enabled by package
import).  Pass ``dtype='parity'`` for parity-grade results on an
accelerator, or ``dtype=jnp.float32`` for the compacted-tile path on the
CPU.
"""
from __future__ import annotations

import os
import pickle
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as cnsts
from ..io import fits as fitsio
from ..ops import astronomy as astro
from ..ops import geometry as mgeom
from ..ops import paths
from ..ops import physics as mphys
from ..ops import radtrans as rt
from ..ops import rrls as mrrl
from ..ops import tiles
from ..utils import misc as miscf
from ..utils.logger import Log
from ..utils.validation import check_model_params
from . import ejection as ej
from . import grid as mgrid
from .fields import Geometry, StaticFields, compute_static_fields


def _freeze(obj):
    """Canonical hashable form of a nested scalar dict (cache keys)."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    return obj


# Compiled grid-fill programs shared across JetModel instances with
# identical static parameters.  Without this every instance re-jits its
# own closure and recompiles the fill — ruinous for parameter sweeps; a
# cache hit here costs the execution only.
_FILL_CACHE: Dict = {}


class RTStatic(NamedTuple):
    """Epoch-independent RT precomputations (one jitted pass per model).

    ``a``/``em_base`` are the full base cubes (all paths); ``a_t``/
    ``em_t``/``tss_t``/``seg`` are their jet-occupied-tile compactions
    (ops.tiles.gather_tiles) feeding the bandwidth-bound epoch pass —
    ``None`` off the compacted-tile path (ops.paths.use_tiles).
    """
    a: jnp.ndarray          # free-free base-opacity cube tau_ff_base
    em_base: jnp.ndarray    # per-cell EM contribution (nd xi)^2 ds_pc
    tbar: jnp.ndarray       # LOS-mean temperature map
    any_in: jnp.ndarray     # jet silhouette (bool map)
    ts_signed: jnp.ndarray  # packed launch time + jet side cube
    a_t: Optional[jnp.ndarray] = None    # (n_act, bx, yc, bz)
    em_t: Optional[jnp.ndarray] = None   # (n_act, bx, yc, bz)
    tss_t: Optional[jnp.ndarray] = None  # (n_act, bx, yc, bz)
    seg: Optional[jnp.ndarray] = None    # (n_act,) xz-tile segment ids


# Sub-threshold fill factors / areas present as NaN at the public API
# boundary (classes.py:663-666's "sub-1e-6 -> NaN" convention); shared by
# the property views and the device-side diagnostic maps.
FF_MIN = 1e-6


# Compacted-tile dims: (8, y, 128) tiles with a 64-cell y granularity
# read ~3% of the cube for the example jet at 512^3.  The z width must be
# a multiple of the RRL kernel's z block (ops.rrl_tiles._BZ).
_TILE = dict(block_x=8, block_z=128, y_chunk=64)


class JetModel:
    """Physical model of an ionised YSO jet (reference classes.py:42-1713)."""

    _arr_indexing = 'ij'

    # ------------------------------------------------------------------ #
    # Construction / persistence
    # ------------------------------------------------------------------ #
    @classmethod
    def load_model(cls, model_file: str) -> "JetModel":
        """Rebuild a model from a saved state (classes.py:48-88).  Accepts
        both this framework's .pkl checkpoints and ones missing cached
        grids."""
        model_file = os.path.expanduser(model_file)
        with open(model_file, 'rb') as f:
            loaded = pickle.load(f)
        log = loaded.get('log')
        new_jm = cls(loaded['params'], log=log)
        if loaded.get('ffs') is not None and loaded.get('areas') is not None:
            new_jm._inject_cached_ff(loaded['ffs'], loaded['areas'])
        new_jm.time = loaded.get('time', 0.0)
        return new_jm

    @staticmethod
    def lz_to_grid_dims(params: Dict) -> Tuple[int, int, int]:
        """classes.py:90-122 (see models.grid)."""
        return mgrid.lz_to_grid_dims(params)

    @staticmethod
    def py_to_dict(py_file: str) -> Dict:
        """Import an executable-python params file and validate
        (classes.py:124-142)."""
        if not os.path.exists(py_file):
            raise FileNotFoundError(py_file + " does not exist")
        # execute by PATH, not by module import: __import__ caches on
        # the bare filename, so two different 'model-params.py' files
        # loaded in one process would silently alias the first
        import runpy
        params = runpy.run_path(os.path.abspath(py_file))['params']
        err = check_model_params(params)
        if err is not None:
            raise err
        return params

    @staticmethod
    def resolve_dtype(dtype):
        """Resolve the dtype presets (ops.paths.compute_dtype):
        ``'auto'`` gives float32 on an accelerator and float64 on the
        CPU; ``'parity'`` always gives float64, the configuration behind
        the 1e-9 (continuum) / 1e-6 (RRL) reference-parity numbers.
        Explicit dtypes pass through untouched."""
        return paths.compute_dtype(dtype)

    def __init__(self, params: Union[dict, str],
                 log: Union[None, Log] = None,
                 dtype='auto'):
        if isinstance(params, dict):
            err = check_model_params(params)
            if err is not None:
                raise err
            self._params = params
        elif isinstance(params, str):
            self._params = JetModel.py_to_dict(params)
        else:
            raise TypeError("Supplied arg params must be dict or file path "
                            "(str)")

        self._dtype = JetModel.resolve_dtype(dtype)
        self._name = self.params['target']['name']
        self._csize = self.params['grid']['c_size']

        # Derived parameters (classes.py:169-181)
        g = self._params['geometry']
        pl = self._params['power_laws']
        mr0 = float(mgeom.mod_r_0(g['opang'], g['epsilon'], g['w_0']))
        q_n = mphys.q_n(g['epsilon'], pl['q_v'])
        g['mod_r_0'] = mr0
        pl['q_n'] = q_n
        pl['q_tau'] = mphys.q_tau(g['epsilon'], pl['q_x'], q_n, pl['q_T'])

        self._log = log if log is not None else Log(
            os.path.expanduser('~') + os.sep + 'temp.log', verbose=False)
        if dtype in ('auto', None) and self._dtype == jnp.float32:
            self._log.add_entry(
                "INFO",
                "Accelerator backend detected: dtype='auto' selected "
                "float32 (the compacted-tile production path). Pass "
                "dtype='parity' for oracle-grade float64 results.")

        # Grid dimensions (classes.py:188-213)
        if self.params['grid'].get('l_z') is not None:
            nx, ny, nz = mgrid.lz_to_grid_dims(self.params)
            self.log.add_entry(
                "INFO",
                'For a (bipolar) jet length of {:.1f}", cell size of '
                '{:.2f}au and distance of {:.0f}pc, a grid size of '
                '(n_x, n_y, n_z) = ({}, {}, {}) voxels is calculated'.format(
                    self.params['grid']['l_z'],
                    self.params['grid']['c_size'],
                    self.params['target']['dist'], nx, ny, nz))
        else:
            nx = (self.params['grid']['n_x'] + 1) // 2 * 2
            ny = (self.params['grid']['n_y'] + 1) // 2 * 2
            nz = (self.params['grid']['n_z'] + 1) // 2 * 2
        self.params['grid']['n_x'] = nx
        self.params['grid']['n_y'] = ny
        self.params['grid']['n_z'] = nz
        self._nx, self._ny, self._nz = nx, ny, nz

        # Steady-state mass-loss rates (classes.py:228-242)
        props = self.params['properties']
        self._ss_jml_rb_frac = props['mlr_rj'] / props['mlr_bj']
        self._ss_jml_bj = props['mlr_bj'] * 1.989e30 / cnsts.YEAR
        self._ss_jml_rj = self._ss_jml_bj * self._ss_jml_rb_frac

        # n_0 is always (re-)derived from mlr_bj, matching the reference
        # (classes.py:234-242 overrides any user-specified value); the
        # params key is therefore optional (SURVEY §2.1 defect fixed)
        props['n_0'] = mphys.n_0_from_mlr(
            props['mlr_bj'], props['v_0'], g['w_0'], props['mu'],
            pl['q^d_n'], pl['q^d_v'], self.params['target']['R_1'],
            self.params['target']['R_2'])

        # Ejection events (classes.py:244-264)
        self._ejections: Dict[str, dict] = {}
        spec_r, spec_b = ej.build_ejection_specs(
            self.params, self._ss_jml_bj, self._ss_jml_rj)
        self._spec_r, self._spec_b = spec_r, spec_b
        which_arr = np.atleast_1d(np.asarray(self.params['ejection']['which']))
        for idx, t0 in enumerate(np.atleast_1d(
                np.asarray(self.params['ejection']['t_0'], dtype=float))):
            which = str(which_arr[idx])
            for side, ss in (('R', self._ss_jml_rj), ('B', self._ss_jml_bj)):
                if side in which.upper():
                    self._ejections[str(len(self._ejections) + 1)] = {
                        't_0': t0 * cnsts.YEAR,
                        'peak_jml': ss * self.params['ejection']['chi'][idx],
                        'half_life':
                            self.params['ejection']['hl'][idx] * cnsts.YEAR,
                        'which': side}

        self._time = 0.0
        self._fields: Optional[StaticFields] = None
        self._ts_valid = False   # True once f.ts holds real travel times
        self._rt_static_cache = None
        self._emergent_tiles_cache = None
        self._rrl_tiles_cache = None
        self._tile_ids_cache = None
        self._host_ff_cache = None
        self._ts_pack_offset = 1.0  # finalised by _rt_static (ts can go
        #                             negative off-axis)
        self._has_bursts = (len(spec_r.t_0) + len(spec_b.t_0)) > 0
        # Per-instance cache of jit-compiled kernels.  All public RT entry
        # points run through these: each product is one compiled program
        # (one dispatch, fused temporaries) rather than an eager op chain.
        self._jit_cache: Dict[str, object] = {}

    # ------------------------------------------------------------------ #
    # Core field computation (lazy, fused, cached on device)
    # ------------------------------------------------------------------ #
    @property
    def _grid_coords(self):
        return mgrid.grid_corner_coords(self._nx, self._ny, self._nz,
                                        self._csize, self._dtype)

    def _ensure_fields(self) -> StaticFields:
        if self._fields is None:
            if self.log:
                self._log.add_entry(
                    "INFO", "Calculating cells' fill factors/projected "
                            "areas and physical fields (one fused pass)")
            xx, yy, zz = self._grid_coords
            # Model params are compile-time constants: close over them so
            # every scalar folds into the compiled program.  The jitted
            # closure is memoised across instances (see _FILL_CACHE).
            sp = self._static_params()
            rbf = self._ss_jml_rb_frac
            wt = self._has_bursts
            key = (_freeze(sp), rbf, wt, str(self._dtype))
            fn = _FILL_CACHE.get(key)
            if fn is None:
                @jax.jit
                def fn(xx_, yy_, zz_):
                    return compute_static_fields(sp, xx_, yy_, zz_, rbf,
                                                 with_time=wt)
                _FILL_CACHE[key] = fn

            from ..utils.profiling import KernelTimer
            with KernelTimer("grid fill (fields + fill factors)",
                             self._log) as t:
                self._fields = fn(xx, yy, zz)
                self._ts_valid = wt
                t.set_result(self._fields.ff)
        return self._fields

    def _static_params(self) -> Dict:
        """Hashable-safe shallow copy of params with only scalar leaves
        (ejection arrays excluded — they live in the EjectionSpecs)."""
        p = self._params
        return {
            'target': {k: p['target'][k] for k in
                       ('dist', 'v_lsr', 'M_star', 'R_1', 'R_2')},
            'grid': {'c_size': p['grid']['c_size']},
            'geometry': dict(p['geometry']),
            'power_laws': dict(p['power_laws']),
            'properties': dict(p['properties']),
        }

    def _inject_cached_ff(self, ffs, areas):
        """Accept previously computed fill factors/areas from a checkpoint
        (classes.py:78-85).  NaN-style inputs are converted back to masked
        zeros.

        NB this is a PARITY hook, not a compute saver: the fused fill
        runs anyway (one compiled program produces all fields incl. the
        t_rw travel times, which the checkpoint does not carry — in the
        reference the 8-corner test was the slow part worth caching;
        here it is a minor slice of one kernel) and the loaded ff/area
        then override the recomputed ones, exactly reproducing the
        reference's load contract."""
        fields = self._ensure_fields()
        ffs = np.nan_to_num(np.asarray(ffs), nan=0.0)
        areas = np.nan_to_num(np.asarray(areas), nan=0.0)
        # intersect with the recomputed mask: a cell the checkpoint
        # claims inside but the current params place outside has NO
        # recomputed physical fields (temp=0 -> T**-1.35 = inf would
        # poison every product on that sightline); only cells both
        # agree on carry the loaded ff/area
        inside = jnp.asarray(areas > 0) & fields.inside
        zero = jnp.asarray(0.0, self._dtype)
        self._fields = fields._replace(
            ff=jnp.where(inside, jnp.asarray(ffs, self._dtype), zero),
            area=jnp.where(inside, jnp.asarray(areas, self._dtype), zero),
            inside=inside)
        self._rt_static_cache = None  # derived from ff/area: recompute
        self._emergent_tiles_cache = None
        self._rrl_tiles_cache = None
        self._tile_ids_cache = None
        self._host_ff_cache = None
        # kernel builders close over the launch-time packing offset (a
        # per-field-set scalar): drop them so new fields rebuild
        self._jit_cache = {}

    # ------------------------------------------------------------------ #
    # Simple properties (classes.py:363-381, 1654-1702)
    # ------------------------------------------------------------------ #
    @property
    def los_axis(self) -> int:
        if self._arr_indexing == 'ij':
            return 1
        if self._arr_indexing == 'xy':
            return 0
        raise ValueError(f"Unknown numpy array indexing "
                         f"({self._arr_indexing})")

    @property
    def time(self) -> float:
        """Model time in seconds."""
        return self._time

    @time.setter
    def time(self, new_time: float):
        self._time = float(new_time)

    @property
    def log(self):
        return self._log

    @log.setter
    def log(self, new_log):
        self._log = new_log

    @property
    def csize(self) -> float:
        return self._csize

    @property
    def nx(self) -> int:
        return self._nx

    @property
    def ny(self) -> int:
        return self._ny

    @property
    def nz(self) -> int:
        return self._nz

    @property
    def params(self) -> Dict:
        return self._params

    @property
    def name(self) -> str:
        return self._name

    @property
    def ejections(self) -> Dict:
        return self._ejections

    def ss_jml(self, which: str) -> float:
        """Steady-state jet mass-loss rate [kg/s] (classes.py:1694-1702)."""
        if which == 'R':
            return self._ss_jml_rj
        if which == 'B':
            return self._ss_jml_bj
        if 'R' in which and 'B' in which:
            return self._ss_jml_rj + self._ss_jml_bj
        raise ValueError("which must be one of 'R', 'B', or 'RB'")

    def jml_t(self, which: str):
        """Time-dependent mass-loss rate callable [kg/s]
        (classes.py:383-397)."""
        def func(t):
            jml = 0.0
            if 'R' in which:
                jml = jml + self._spec_r.jml(t)
            if 'B' in which:
                jml = jml + self._spec_b.jml(t)
            return jml
        return func

    def add_ejection_event(self, t_0: float, peak_jml: float,
                           half_life: float, which: str):
        """Register a Gaussian ejection burst (classes.py:399-463).
        Args in SI seconds / kg/s, as the reference."""
        assert which in ('R', 'B')
        spec = self._spec_r if which == 'R' else self._spec_b
        new = ej.EjectionSpec(
            ss_jml=spec.ss_jml,
            t_0=np.append(spec.t_0, t_0),
            peak_jml=np.append(spec.peak_jml, peak_jml),
            half_life=np.append(spec.half_life, half_life))
        if which == 'R':
            self._spec_r = new
        else:
            self._spec_b = new
        self._ejections[str(len(self._ejections) + 1)] = {
            't_0': t_0, 'peak_jml': peak_jml, 'half_life': half_life,
            'which': which}
        was_burst_free = not self._has_bursts
        self._has_bursts = True
        # Invalidate everything that baked the OLD burst set in at trace
        # time: the jitted kernels close over _burst_tuple()/_spec_* as
        # compile-time constants, and a model built burst-free computed
        # its fields with with_time=False (f.ts = zeros — every cell
        # would burst simultaneously).  Without this, RT products after
        # add_ejection_event silently ignore the new burst.
        self._jit_cache.clear()
        self._rt_static_cache = None
        self._emergent_tiles_cache = None
        self._rrl_tiles_cache = None
        # the new burst modulates n_e, so the memoised EM-weighted
        # departure-coefficient conditions are stale too
        self._departure_cache = {}
        if was_burst_free:
            self._fields = None   # recompute with travel times
            self._ts_valid = False

    # ------------------------------------------------------------------ #
    # Coordinate grids (classes.py:465-569) — NaN-free by construction
    # ------------------------------------------------------------------ #
    @property
    def indices(self):
        return tuple(np.meshgrid(np.arange(self.nx), np.arange(self.ny),
                                 np.arange(self.nz),
                                 indexing=self._arr_indexing))

    @property
    def ix(self):
        return self.indices[0]

    @property
    def iy(self):
        return self.indices[1]

    @property
    def iz(self):
        return self.indices[2]

    @property
    def grid(self):
        xx, yy, zz = self._grid_coords
        shape = (self.nx, self.ny, self.nz)
        return tuple(np.broadcast_to(np.asarray(a), shape) for a in
                     (xx, yy, zz))

    @property
    def xx(self):
        return self.grid[0]

    @property
    def yy(self):
        return self.grid[1]

    @property
    def zz(self):
        return self.grid[2]

    @property
    def xs(self):
        return np.asarray(self._grid_coords[0]).ravel()

    @property
    def ys(self):
        return np.asarray(self._grid_coords[1]).ravel()

    @property
    def zs(self):
        return np.asarray(self._grid_coords[2]).ravel()

    @property
    def grid_rwp(self):
        gm = Geometry.from_params(self._static_params())
        xx, yy, zz = self._grid_coords
        half = self.csize / 2.0
        rr, ww, pp = mgeom.xyz_to_rwp(xx + half, yy + half, zz + half,
                                      gm.inc, gm.pa)
        shape = (self.nx, self.ny, self.nz)
        return tuple(np.broadcast_to(np.asarray(a), shape)
                     for a in (rr, ww, pp))

    @property
    def rr(self):
        return self.grid_rwp[0]

    @property
    def ww(self):
        return self.grid_rwp[1]

    @property
    def pp(self):
        return self.grid_rwp[2]

    @property
    def rreff(self):
        gm = Geometry.from_params(self._static_params())
        return np.asarray(mgeom.r_eff(
            jnp.asarray(self.ww), gm.r_1, gm.r_2, gm.w_0,
            jnp.abs(jnp.asarray(self.rr)), gm.mod_r_0, gm.r_0, gm.epsilon))

    # ------------------------------------------------------------------ #
    # Cached field views — NaN outside the jet, as the reference's API
    # ------------------------------------------------------------------ #
    def _nan_view(self, arr, mask=None) -> np.ndarray:
        f = self._ensure_fields()
        mask = f.inside if mask is None else mask
        return np.asarray(jnp.where(mask, arr, jnp.nan))

    @property
    def fill_factor(self) -> np.ndarray:
        """classes.py:571-769 (NaN outside the jet boundary)."""
        f = self._ensure_fields()
        return self._nan_view(f.ff, f.ff > FF_MIN)

    @property
    def areas(self) -> np.ndarray:
        """classes.py:771-784."""
        f = self._ensure_fields()
        return self._nan_view(f.area, f.area > FF_MIN)

    @property
    def ts(self) -> np.ndarray:
        """Launch time of each cell's material: model time minus travel
        time [s], computed for every cell like the reference
        (classes.py:838-855 — unmasked)."""
        f = self._ensure_fields()
        if not self._has_bursts and not self._ts_valid:
            # travel time not yet computed (no bursts at construction).
            # One jitted kernel, and the host-side _ts_valid flag
            # replaces an any() that pulled the whole cube to host on
            # EVERY access
            gm = Geometry.from_params(self._static_params())
            half = self.csize / 2.0
            sp = self._static_params()
            shape = f.ff.shape

            def build():
                def kernel(xx, yy, zz):
                    from .fields import travel_time_years
                    rr, ww, _ = mgeom.xyz_to_rwp(
                        xx + half, yy + half, zz + half, gm.inc, gm.pa)
                    ts = travel_time_years(gm, sp, rr, ww) * cnsts.YEAR
                    return jnp.broadcast_to(ts, shape)
                return kernel

            xx, yy, zz = self._grid_coords
            self._fields = f._replace(
                ts=self._jitted('ts_fill', build)(xx, yy, zz))
            self._ts_valid = True
            f = self._fields
        return np.asarray(self.time - f.ts)

    @property
    def chi_xyz(self) -> np.ndarray:
        """Burst factor per cell (classes.py:861-870), evaluated by one
        jitted kernel (the burst spec is a compile-time constant; model
        time is traced)."""
        # burst models always fill travel times at the fused grid fill
        # (with_time=True; add_ejection_event nulls stale fields), so no
        # ts guard is needed — and the ts property's return would be a
        # discarded full-cube host transfer
        f = self._ensure_fields()

        def build():
            def kernel(f, t):
                return ej.chi_field(f.red, t - f.ts, self._spec_r,
                                    self._spec_b)
            return kernel

        chi = self._jitted('chi_xyz', build)(f, self.time)
        return np.asarray(chi)

    def _nd_device(self):
        """Device-side time-dependent number density (masked zeros)."""
        f = self._ensure_fields()
        fn = self._jitted('nd', lambda: self._nd_chi)
        return fn(f, self.time)

    def diagnostic_maps(self) -> Dict[str, np.ndarray]:
        """LOS diagnostics for the standard plots, reduced ON DEVICE:
        nan-mean maps of number density, temperature, ionisation fraction
        and LOS velocity, plus the LOS fill-factor sum.

        Equivalent to ``np.nanmean(jm.<field>, axis=jm.los_axis)`` etc.,
        but only the (nx, nz) maps cross the host boundary — each full
        NaN-view cube is ~0.5-1 GB at 512^3 while the maps are ~1 MB in
        total.
        """
        f = self._ensure_fields()

        def build():
            def kernel(f, t):
                cnt = jnp.sum(f.inside, axis=rt.LOS_AXIS)
                pos = cnt > 0
                safe = jnp.maximum(cnt, 1).astype(f.temp.dtype)

                def mean(v):
                    s = jnp.sum(jnp.where(f.inside, v, 0),
                                axis=rt.LOS_AXIS)
                    return jnp.where(pos, s / safe, jnp.nan)

                ffs = jnp.sum(jnp.where(f.ff > FF_MIN, f.ff, 0.0),
                              axis=rt.LOS_AXIS)
                return (mean(self._nd_chi(f, t)), mean(f.temp),
                        mean(f.xi), mean(f.vy), ffs)
            return kernel

        nd, temp, xi, vy, ffs = self._jitted('diag_maps', build)(
            f, self.time)
        return {'n_e': np.asarray(nd), 'T': np.asarray(temp),
                'x_i': np.asarray(xi), 'v_los': np.asarray(vy),
                'ff_sum': np.asarray(ffs)}

    def occupancy_projections(self) -> Dict[str, np.ndarray]:
        """Fill-factor sums along each grid axis — the three projected
        silhouettes of :func:`plotting.functions.geometry_plot`
        (functions.py:1019-1023), reduced on device so only the three
        2-D maps cross the host boundary."""
        f = self._ensure_fields()

        def build():
            def kernel(f):
                ff = jnp.where(f.ff > FF_MIN, f.ff, 0.0)
                return (jnp.sum(ff, axis=0), jnp.sum(ff, axis=1),
                        jnp.sum(ff, axis=2))
            return kernel

        yz, xz, xy = self._jitted('occ_proj', build)(f)
        return {'yz': np.asarray(yz), 'xz': np.asarray(xz),
                'xy': np.asarray(xy)}

    def conservation_profiles(self) -> Dict[str, np.ndarray]:
        """Mass and angular momentum per signed-r slice along the jet —
        the conservation diagnostics behind the reference's
        ``diagnostic_plot`` (plotting/functions.py:368-458).

        The reference computes these only for ``inc == 90, pa == 0`` and
        is dead at head anyway (it reads the commented-out
        ``JetModel.mass`` property, classes.py:787-835); its generic
        branch is a per-radius Python loop of whole-grid masked sums.
        Here the per-cell mass and angular momentum about the jet axis
        are binned by signed jet radius with one on-device
        ``segment_sum``, valid for any inclination/position angle (the
        azimuthal speed comes from the rotation law itself rather than
        the observer-frame components, so no small-angle assumption).

        Returns ``{'r': bin centres [au], 'mass': kg per csize-thick
        slice, 'angmom': kg m^2 s^-1 per slice}``.
        """
        f = self._ensure_fields()
        sp = self._static_params()
        gm = Geometry.from_params(sp)
        csize = self.csize
        half = csize / 2.0
        # static bin layout: |r| is bounded by the grid's half-diagonal
        r_max = 0.5 * csize * float(np.sqrt(self._nx ** 2 +
                                            self._ny ** 2 +
                                            self._nz ** 2)) + csize
        nbins = 2 * int(np.ceil(r_max / csize))
        r_lo = -0.5 * nbins * csize
        cell_vol_cm3 = (csize * cnsts.AU * 1e2) ** 3
        m_part_kg = sp['properties']['mu'] * cnsts.atomic_mass('H')
        m_star = sp['target']['M_star']

        def build():
            def kernel(xx, yy, zz, f, t):
                from .fields import centre_rwp, effective_radius
                from ..ops import geometry as geom
                rr, ww, _ = centre_rwp(gm, xx + half, yy + half,
                                       zz + half)
                rr = jnp.broadcast_to(rr, f.ff.shape)
                ww = jnp.broadcast_to(ww, f.ff.shape)
                reff = effective_radius(gm, rr, ww)
                nd = self._nd_chi(f, t)
                m = nd * f.ff * (cell_vol_cm3 * m_part_kg)      # kg
                vphi = mphys.v_rot(rr, reff,
                                   geom.rho(rr, gm.r_0, gm.mod_r_0),
                                   gm.epsilon, m_star)          # km/s
                ang = m * (vphi * 1e3) * (ww * cnsts.AU)        # kg m^2/s
                m = jnp.where(f.inside, m, 0.0).ravel()
                ang = jnp.where(f.inside, ang, 0.0).ravel()
                seg = jnp.clip(jnp.floor((rr - r_lo) / csize),
                               0, nbins - 1).astype(jnp.int32).ravel()
                return (jax.ops.segment_sum(m, seg, nbins),
                        jax.ops.segment_sum(ang, seg, nbins))
            return kernel

        xx, yy, zz = self._grid_coords
        mp, lp = self._jitted('conservation', build)(xx, yy, zz, f,
                                                     self.time)
        rs = r_lo + csize * (np.arange(nbins) + 0.5)
        return {'r': rs, 'mass': np.asarray(mp), 'angmom': np.asarray(lp)}

    def velocity_midplane(self) -> Tuple[np.ndarray, np.ndarray]:
        """(v_x, v_z) [km/s] on the mid-LOS plane (y index ny//2),
        computed and sliced on device so only (nx, nz) maps cross the
        host boundary.  NaN outside the jet.  Feeds the working velocity
        quiver in :func:`plotting.functions.model_plot` (the reference's
        own quiver overlay is disabled as broken,
        plotting/functions.py:594-637)."""
        f = self._ensure_fields()
        sp = self._static_params()
        gm = Geometry.from_params(sp)
        half = self.csize / 2.0
        mid = self._ny // 2

        def build():
            def kernel(xx, yy, zz, inside):
                from .fields import (centre_rwp, effective_radius,
                                     velocity)
                yy_m = yy[:, mid:mid + 1, :]
                ins = inside[:, mid:mid + 1, :]
                rr, ww, pp = centre_rwp(gm, xx + half, yy_m + half,
                                        zz + half)
                reff = effective_radius(gm, rr, ww)
                vx, _, vz = velocity(gm, sp, rr, pp, reff, ins)
                return vx[:, 0, :], vz[:, 0, :], ins[:, 0, :]
            return kernel

        xx, yy, zz = self._grid_coords
        vx, vz, ins = self._jitted('vel_mid', build)(xx, yy, zz, f.inside)
        pad = np.where(np.asarray(ins), 0.0, np.nan)
        return np.asarray(vx) + pad, np.asarray(vz) + pad

    def _rt_inputs(self):
        """(fields, n_es, ds) — building blocks for custom RT compositions
        (used by the sharding layer and tests).  Runs one jitted kernel."""
        f = self._ensure_fields()
        csize = self.csize

        def build():
            def kernel(f, t):
                n_es = self._nd_chi(f, t) * f.xi
                ds = rt.path_length_cm(f.ff, f.area, csize)
                return n_es, ds
            return kernel

        n_es, ds = self._jitted('rt_inputs', build)(f, self.time)
        return f, n_es, ds

    @property
    def number_density(self) -> np.ndarray:
        """Time-modulated number density [cm^-3] (classes.py:872-899)."""
        return self._nan_view(self._nd_device())

    @property
    def mass_density(self) -> np.ndarray:
        """[g cm^-3] (classes.py:901-908)."""
        av_m = self.params['properties']['mu'] * cnsts.atomic_mass('H')
        return av_m * 1e3 * self.number_density

    @property
    def ion_fraction(self) -> np.ndarray:
        """classes.py:910-936."""
        f = self._ensure_fields()
        return self._nan_view(f.xi)

    @property
    def temperature(self) -> np.ndarray:
        """[K] (classes.py:942-996; au/cm slip fixed, see models.fields)."""
        f = self._ensure_fields()
        return self._nan_view(f.temp)

    @property
    def pressure(self) -> np.ndarray:
        """[Ba] (classes.py:1002-1007)."""
        return self.number_density * self.temperature * cnsts.K_B * 1e7

    @property
    def vel(self):
        """(vx, vy, vz) [km/s] (classes.py:1009-1099).  The full 3-D
        velocity is recomputed on demand (only the LOS component is part
        of the cached RT working set)."""
        f = self._ensure_fields()
        sp = self._static_params()
        gm = Geometry.from_params(sp)
        half = self.csize / 2.0

        def build():
            def kernel(xx, yy, zz, inside):
                from .fields import centre_rwp, effective_radius, velocity
                rr, ww, pp = centre_rwp(gm, xx + half, yy + half,
                                        zz + half)
                reff = effective_radius(gm, rr, ww)
                return velocity(gm, sp, rr, pp, reff, inside)
            return kernel

        xx, yy, zz = self._grid_coords
        vx, vy, vz = self._jitted('vel', build)(xx, yy, zz, f.inside)
        return (self._nan_view(vx), self._nan_view(vy),
                self._nan_view(vz))

    # ------------------------------------------------------------------ #
    # Radiative transfer — device-side products.
    #
    # Every public entry point routes through a per-instance jit-compiled
    # kernel (cached in self._jit_cache).  Model time enters as a traced
    # scalar so epoch changes never recompile.
    # ------------------------------------------------------------------ #
    def _jitted(self, key, builder):
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = jax.jit(builder())
            self._jit_cache[key] = fn
        return fn

    def _use_reynolds_gaunt(self) -> bool:
        # classes.py:1388-1393: van Hoof scalar gaunt iff q_T == 0
        return self.params['power_laws']['q_T'] != 0.0

    def _nd_chi(self, f, t):
        """Traced: time-modulated number density (masked zeros)."""
        if self._has_bursts:
            return f.nd * ej.chi_field(f.red, t - f.ts, self._spec_r,
                                       self._spec_b)
        return f.nd

    def _chi2(self, f, t):
        """Traced: squared burst factor — the only way epoch time enters
        the free-free/EM products (n_e is chi-modulated then squared,
        classes.py:872-899 + 1395)."""
        if self._has_bursts:
            chi = ej.chi_field(f.red, t - f.ts, self._spec_r, self._spec_b)
            return chi * chi
        return jnp.asarray(1.0, self._dtype)

    def _rt_constants(self):
        return (self.params['properties']['T_0'],
                self._use_reynolds_gaunt(), self.csize,
                self.params['target']['dist'])

    def _rt_static(self):
        """Cached epoch-independent RT precomputations, one jitted pass:

        - ``A``: free-free base-opacity cube tau_ff_base(nd * xi) — per
          epoch, tau = scale(nu) * sum_los A * chi^2
        - ``em_base``: per-cell EM contribution (nd * xi)^2 ds_pc
        - ``tbar``/``any_in``: LOS-mean temperature and jet silhouette
        - ``ts_signed``: launch time + jet side packed into one cube
          (for the compacted epoch pass)

        Computed once per model instance; the per-epoch chain then streams
        only (A, ts_signed) — 2 cube reads instead of ~8 — or, on the
        compacted-tile path, just their jet-occupied tiles (a further
        15-30x read cut; see ops.tiles).
        """
        if self._rt_static_cache is None:
            f = self._ensure_fields()
            t_0, reyn, csize, _ = self._rt_constants()

            # travel times can be NEGATIVE near the launch surface for
            # off-axis geometries; the packing offset must keep |tss| > 0
            # (in f32 — pack_offset_for scales its margin accordingly)
            ts_min = float(self._jitted('ts_min',
                                        lambda: jnp.min)(f.ts))
            self._ts_pack_offset = tiles.pack_offset_for(ts_min)

            @jax.jit
            def fn(f, pack_offset):
                n_es0 = f.nd * f.xi
                ds = rt.path_length_cm(f.ff, f.area, csize)
                a = rt.tau_ff_base(f.temp, n_es0, ds, f.inside, reyn)
                em_base = rt.emission_measure_base(f.nd, f.xi, f.ff,
                                                   f.area, csize)
                tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)
                ts_signed = tiles.pack_launch_time(f.ts, f.red,
                                                   self._dtype, pack_offset)
                return a, em_base, tbar, any_in, ts_signed

            a, em_base, tbar, any_in, ts_signed = fn(
                f, self._ts_pack_offset)
            a_t = em_t = tss_t = seg_d = None
            if self._tiled():
                ids, seg = self._active_tile_ids()
                ids_d = jnp.asarray(ids)
                a_t = tiles.gather_tiles(a, ids_d, **_TILE)
                em_t = tiles.gather_tiles(em_base, ids_d, **_TILE)
                tss_t = tiles.gather_tiles(ts_signed, ids_d, fill=1.0,
                                           **_TILE)
                seg_d = jnp.asarray(seg)
            self._rt_static_cache = RTStatic(a, em_base, tbar, any_in,
                                             ts_signed, a_t, em_t, tss_t,
                                             seg_d)
        return self._rt_static_cache

    def _burst_tuple(self):
        """Static, hashable burst parameters for ops.tiles.burst_factor:
        (t0 [s], 1/(2 sigma^2), relative amplitude, is_red) per burst —
        the data behind models/ejection.chi_field."""
        out = []
        for spec, is_red in ((self._spec_r, True), (self._spec_b, False)):
            for t0, peak, sig in zip(spec.t_0, spec.peak_jml, spec.sigma):
                out.append((float(t0), float(1.0 / (2.0 * sig ** 2)),
                            float((peak - spec.ss_jml) / spec.ss_jml),
                            is_red))
        return tuple(out)

    def _epoch_base_maps(self, bases_t, st: RTStatic, t):
        """Traced: the compacted-tile epoch pass over ``bases_t`` (one
        burst-factor evaluation shared by every base stream)."""
        return tiles.epoch_base_maps_tiles(
            bases_t, st.tss_t, st.seg, t, self._burst_tuple(), self._nx,
            self._nz, pack_offset=getattr(self, '_ts_pack_offset', 1.0))

    def _epoch_base_map(self, kind: str, f, st: RTStatic, t):
        """Traced: LOS-collapsed sum_y base * chi(t)^2 for ``kind`` in
        {'a', 'em'} — over the compacted tiles when they are live, the
        full-cube XLA burst scan otherwise."""
        if st.seg is not None:
            base_t = st.a_t if kind == 'a' else st.em_t
            return self._epoch_base_maps((base_t,), st, t)[0]
        base = st.a if kind == 'a' else st.em_base
        return jnp.sum(base * self._chi2(f, t), axis=rt.LOS_AXIS)

    def _compact_flag(self, st: RTStatic) -> bool:
        """Whether the compacted-tile epoch path is live (part of jit
        cache keys: the traced kernels branch on it at build time)."""
        return st.seg is not None

    def _epoch_base_maps_both(self, f, st: RTStatic, t):
        """Traced: BOTH collapsed epoch maps (sum_y a*chi^2,
        sum_y em_base*chi^2) from one chi evaluation — one pass over 3
        tile streams on the compacted path, a shared-chi XLA pass
        elsewhere."""
        if st.seg is not None:
            return self._epoch_base_maps((st.a_t, st.em_t), st, t)
        chi2 = self._chi2(f, t)
        return (jnp.sum(st.a * chi2, axis=rt.LOS_AXIS),
                jnp.sum(st.em_base * chi2, axis=rt.LOS_AXIS))

    def continuum_rt_products(self, freq, as_numpy: bool = True):
        """The complete per-run continuum RT stage — EM map, per-channel
        optical-depth maps and flux maps — in ONE fused device program.

        Equivalent to calling ``emission_measure`` + ``optical_depth_ff``
        + ``flux_ff`` separately (the reference's per-run sequence,
        classes.py:2397-2423) but runs a single epoch pass: the burst
        factor is evaluated once and both base streams are collapsed in
        one pass (:meth:`_epoch_base_maps_both`), one dispatch per run.
        Returns numpy ``(em, taus, fluxes)``; ``Pipeline.execute`` uses
        this for fresh continuum runs.  ``as_numpy=False`` returns the
        device arrays so callers can time (and overlap) the host transfer
        separately from the device compute.
        """
        f = self._ensure_fields()
        st = self._rt_static()
        t_0, reyn, csize, dist = self._rt_constants()

        def build():
            def kernel(f, st, t, freqs):
                a_map, em = self._epoch_base_maps_both(f, st, t)
                scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                taus = scale[:, None, None] * a_map[None]
                fluxes = rt.flux_ff_maps(freqs, taus, st.tbar, st.any_in,
                                         csize, dist)
                return em, taus, fluxes
            return kernel

        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        em, taus, fluxes = self._jitted(
            ('ff_products', self._compact_flag(st)), build)(
            f, st, self.time, freqs)
        if not as_numpy:
            return em, taus, fluxes
        return np.asarray(em), np.asarray(taus), np.asarray(fluxes)

    def emission_measure(self, savefits: Union[bool, str] = False
                         ) -> np.ndarray:
        """EM map [pc cm^-6] (classes.py:1101-1128)."""
        f = self._ensure_fields()
        st = self._rt_static()

        def build():
            def kernel(f, st, t):
                return self._epoch_base_map('em', f, st, t)
            return kernel

        em = np.asarray(self._jitted(
            ('em', self._compact_flag(st)), build)(f, st, self.time))
        if savefits:
            self.save_fits(miscf.reorder_axes(em, ra_axis=0, dec_axis=1),
                           savefits, 'em')
        return em

    def _continuum_kernel(self, kind: str, collapse: bool = True):
        """Jitted (fields, rt_static, t, freqs) -> tau/intensity/flux
        product, fed from the cached static base cube (or its compacted
        tiles)."""
        t_0, reyn, csize, dist = self._rt_constants()

        def build():
            def kernel(f, st, t, freqs):
                if kind == 'tau' and not collapse:
                    scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                    return scale[:, None, None, None] * \
                        (st.a * self._chi2(f, t))[None]
                base_map = self._epoch_base_map('a', f, st, t)
                scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                taus = scale[:, None, None] * base_map[None]
                if kind == 'tau':
                    return taus
                if kind == 'intensity':
                    return rt.intensity_ff_maps(freqs, taus, st.tbar,
                                                st.any_in)
                return rt.flux_ff_maps(freqs, taus, st.tbar, st.any_in,
                                       csize, dist)
            return kernel

        st = self._rt_static()
        inner = self._jitted(('ff', kind, collapse, self._compact_flag(st)),
                             build)

        def call(f, t, freqs):
            return inner(f, st, t, freqs)

        # callers composing their own jit (bench loops) must pass the
        # static arrays as runtime arguments — a closure would embed the
        # O(N^3) cube as an HLO constant (multi-GB programs compile slowly
        # or not at all)
        call.inner = inner
        call.statics = (st,)
        return call

    def optical_depth_ff(self, freq, savefits: Union[bool, str] = False,
                         collapse: bool = True) -> np.ndarray:
        """Free-free optical depth (classes.py:1353-1447): collapsed
        (nx, nz) maps per channel, or the full per-cell cube."""
        f = self._ensure_fields()
        scalar = np.isscalar(freq)
        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        tff = np.asarray(self._continuum_kernel('tau', collapse)(
            f, self.time, freqs))
        if savefits:
            self._save_rt_fits(tff, savefits, 'tau', freq, scalar, collapse)
        return tff[0] if scalar else tff

    def intensity_ff(self, freq, savefits: Union[bool, str] = False
                     ) -> np.ndarray:
        """Free-free intensity [W m^-2 Hz^-1 sr^-1] (classes.py:1449-1496)."""
        f = self._ensure_fields()
        scalar = np.isscalar(freq)
        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        ints = np.asarray(self._continuum_kernel('intensity')(
            f, self.time, freqs))
        if savefits:
            self._save_rt_fits(ints, savefits, 'intensity', freq, scalar,
                               True)
        return ints[0] if scalar else ints

    def flux_ff(self, freq, savefits: Union[bool, str] = False) -> np.ndarray:
        """Free-free flux [Jy/pixel] (classes.py:1498-1541)."""
        f = self._ensure_fields()
        scalar = np.isscalar(freq)
        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        fluxes = np.asarray(self._continuum_kernel('flux')(
            f, self.time, freqs))
        if savefits:
            self._save_rt_fits(fluxes, savefits, 'flux', freq, scalar, True)
        return fluxes[0] if scalar else fluxes

    def _tiled(self) -> bool:
        """Whether the RT products run on the compacted jet-occupied tiles
        (ops.paths.use_tiles: a float32 model with a non-empty tile
        set)."""
        return paths.use_tiles(self._dtype,
                               lambda: self._active_tile_ids()[0].size)

    def _active_tile_ids(self):
        """Cached (ids, seg) of jet-occupied tiles at the shared _TILE
        dims — used by both the epoch-map and RRL compactions (one
        full-cube activity pass per model)."""
        if getattr(self, '_tile_ids_cache', None) is None:
            f = self._ensure_fields()
            self._tile_ids_cache = tiles.active_tiles(f.inside, **_TILE)
        return self._tile_ids_cache

    def _rrl_tiles(self):
        """Cached compacted jet-occupied field tiles for the RRL path:
        (temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, seg).  The
        chi-independent fields are gathered once; the per-epoch burst
        factor is applied to the compacted density tiles."""
        if getattr(self, '_rrl_tiles_cache', None) is None:
            f = self._ensure_fields()
            st = self._rt_static()
            ids, seg = self._active_tile_ids()
            csize = self.csize

            @jax.jit
            def prep(f):
                ds = rt.path_length_cm(f.ff, f.area, csize)
                return f.temp, f.vy, f.nd * f.xi, ds

            temp, vy, ndxi, ds = prep(f)
            ids_d = jnp.asarray(ids)
            self._rrl_tiles_cache = (
                tiles.gather_tiles(temp, ids_d, fill=1.0, **_TILE),
                tiles.gather_tiles(vy, ids_d, **_TILE),
                tiles.gather_tiles(ndxi, ids_d, **_TILE),
                tiles.gather_tiles(ds, ids_d, **_TILE),
                tiles.gather_tiles(f.inside, ids_d, fill=False, **_TILE),
                st.tss_t,
                jnp.asarray(seg))
        return self._rrl_tiles_cache

    @staticmethod
    def _nonlte_tau(st, freqs, tau_l, b_n1, b_n2):
        """Stimulated-corrected non-LTE line opacity b_n1 beta tau_L*
        (G&S 2.141) — delegates to the ONE ops-level definition
        (ops.radtrans.tau_rrl_maps_nonlte), shared by _rrl_kernel's tau
        branch, rrl_rt_products and parallel.fanout (a composition fix
        must not be applied twice, and must reach every path)."""
        return rt.tau_rrl_maps_nonlte(freqs, st.tbar, st.any_in, tau_l,
                                      b_n1, b_n2)

    def _rrl_kernel(self, line: str, kind: str, collapse: bool = True,
                    nonlte: bool = False):
        """Jitted (fields, t, freqs, b_n1, b_n2) -> RRL tau/intensity
        product.  ``b_n1``/``b_n2`` are departure coefficients for the
        non-LTE mode (pass 1.0 for LTE — they are traced, so switching
        values never recompiles)."""
        t_0, reyn, csize, dist = self._rt_constants()
        coeffs = rt.RRLCoeffs(line)
        tiled = self._tiled()
        tl = self._rrl_tiles() if (tiled and collapse) else None
        st = self._rt_static()

        def build():
            tau_maps = self._tau_rrl_dispatch(coeffs, tl is not None, csize)

            def kernel(f, st, tl, t, freqs, b_n1, b_n2):
                if kind == 'tau' and not collapse:
                    n_es = self._nd_chi(f, t) * f.xi
                    ds = rt.path_length_cm(f.ff, f.area, csize)
                    return rt.tau_rrl_cube(coeffs, freqs, f.temp, n_es,
                                           f.vy, ds, f.inside)
                tau_l = tau_maps(f, tl, t, freqs)
                if kind == 'tau':
                    if not nonlte:
                        return tau_l
                    return self._nonlte_tau(st, freqs, tau_l, b_n1,
                                            b_n2)
                if tiled:
                    # continuum opacity from the cached factorised base
                    # (identical maths to tau_ff_maps; no full-grid pass)
                    scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                    tau_c = scale[:, None, None] * \
                        self._epoch_base_map('a', f, st, t)[None]
                else:
                    n_es = self._nd_chi(f, t) * f.xi
                    ds = rt.path_length_cm(f.ff, f.area, csize)
                    tau_c = rt.tau_ff_maps(freqs, f.temp, n_es, ds,
                                           f.inside, t_0, reyn)
                if nonlte:
                    return rt.intensity_rrl_maps_nonlte(
                        freqs, st.tbar, tau_c, tau_l, st.any_in, b_n1,
                        b_n2)
                return rt.intensity_rrl_maps(freqs, st.tbar, tau_c, tau_l,
                                             st.any_in)
            return kernel

        inner = self._jitted(('rrl', line, kind, collapse, tiled, nonlte,
                              tl is not None), build)

        def call(f, t, freqs, b_n1, b_n2):
            return inner(f, st, tl, t, freqs, b_n1, b_n2)
        return call

    def rrl_rt_products(self, line: str, freq, contsub: bool = False,
                        lte: bool = True, departure_coeffs=None,
                        as_numpy: bool = True):
        """The complete per-run RRL RT stage — EM map, line optical-depth
        maps and line(+continuum when ``contsub=False``) flux maps — in
        ONE fused device program (the reference's per-run sequence at
        classes.py:2437-2450).

        The separate ``optical_depth_rrl`` + ``flux_rrl`` calls each
        evaluate the full line-opacity chain (Doppler shift, widths,
        Voigt, kappa_L); here it runs once and feeds both products, the
        continuum opacity comes from the factorised epoch base, and the
        EM map rides the same dual-base pass — one dispatch instead of
        three, and the line chain's cost once instead of twice.  Returns
        numpy ``(em, tau_l, fluxes)`` (device arrays with
        ``as_numpy=False``, so callers can account the host transfer
        separately).

        ``lte=False`` (beyond-reference; the pipeline's optional
        ``rrls.lte`` array routes here) swaps in the G&S non-LTE slab
        composition: tau becomes the stimulated-corrected line opacity
        b_n1 beta tau_L* and the flux uses the eta/beta forms —
        departure coefficients auto-derived (:meth:`_check_nonlte`)
        or supplied.  The b values are traced, so LTE and non-LTE runs
        of the same line share nothing but the compiled-program key.
        """
        b_n1, b_n2 = self._check_nonlte(lte, departure_coeffs, line)
        t_0, reyn, csize, dist = self._rt_constants()
        coeffs = rt.RRLCoeffs(line)
        tl = self._rrl_tiles() if self._tiled() else None
        st = self._rt_static()
        fscale = float(rt.flux_scale_jy(csize, dist))
        f = self._ensure_fields()
        nonlte = not lte

        def build():
            tau_maps = self._tau_rrl_dispatch(coeffs, tl is not None, csize)

            def kernel(f, st, tl, t, freqs, b1, b2):
                tau_l = tau_maps(f, tl, t, freqs)
                a_map, em = self._epoch_base_maps_both(f, st, t)
                scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                tau_c = scale[:, None, None] * a_map[None]
                if nonlte:
                    tau_out = self._nonlte_tau(st, freqs, tau_l, b1, b2)
                    ints = rt.intensity_rrl_maps_nonlte(
                        freqs, st.tbar, tau_c, tau_l, st.any_in, b1, b2)
                else:
                    tau_out = tau_l
                    ints = rt.intensity_rrl_maps(freqs, st.tbar, tau_c,
                                                 tau_l, st.any_in)
                fluxes = ints * jnp.asarray(fscale, ints.dtype)
                if not contsub:
                    fluxes = fluxes + rt.flux_ff_maps(
                        freqs, tau_c, st.tbar, st.any_in, csize, dist)
                return em, tau_out, fluxes
            return kernel

        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        em, tau_l, fluxes = self._jitted(
            ('rrl_products', line, contsub, nonlte, tl is not None),
            build)(f, st, tl, self.time, freqs, b_n1, b_n2)
        if not as_numpy:
            return em, tau_l, fluxes
        return np.asarray(em), np.asarray(tau_l), np.asarray(fluxes)

    def _tau_rrl_dispatch(self, coeffs, use_tiles: bool, csize: float,
                          partials=None):
        """The RRL line-opacity dispatch shared by _rrl_kernel and
        rrl_rt_products: compacted jet-occupied tiles, or the XLA channel
        map over the full cube.  Returns ``tau_maps(f, tl, t, freqs)`` for
        use inside a jitted kernel (one definition — a fix in the
        dispatch must not be applied twice).  ``partials`` overrides the
        per-tile Voigt sums (rt.tau_rrl_maps_tiles); the default is the
        platform's choice."""
        def tau_maps(f, tl, t, freqs):
            if use_tiles:
                temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, seg = tl
                n_es_t = ndxi_t * tiles.burst_factor(
                    tss_t, t, self._burst_tuple(),
                    getattr(self, '_ts_pack_offset', 1.0))
                return rt.tau_rrl_maps_tiles(
                    coeffs, freqs, temp_t, n_es_t, vy_t, ds_t,
                    inside_t, seg, self._nx, self._nz, partials=partials)
            n_es = self._nd_chi(f, t) * f.xi
            ds = rt.path_length_cm(f.ff, f.area, csize)
            return rt.tau_rrl_maps(coeffs, freqs, f.temp, n_es, f.vy,
                                   ds, f.inside)
        return tau_maps

    def characteristic_conditions(self):
        """Emission-measure-weighted (T_e [K], n_e [cm^-3]) over the jet
        at the current model time — the slab-characteristic conditions
        the auto-derived departure coefficients are evaluated at (n_e is
        averaged in log space; it spans decades along the jet).

        Memoised per model time: the reduction is a device dispatch and
        a host pull, and every departure-coefficient entry point —
        central, rate-scale edges, systematic — needs the same pair."""
        cache = getattr(self, '_char_cond_cache', None)
        if cache is None:
            cache = self._char_cond_cache = {}
        key = float(self.time)
        hit = cache.get(key)
        if hit is not None:
            return hit
        f = self._ensure_fields()

        def build():
            def kernel(f, t):
                n_e = self._nd_chi(f, t) * f.xi
                w = jnp.where(f.inside, n_e * n_e, 0.0)
                wsum = jnp.maximum(jnp.sum(w), 1e-30)
                t_char = jnp.sum(w * f.temp) / wsum
                safe_ne = jnp.where(f.inside, jnp.maximum(n_e, 1e-30),
                                    1.0)
                ln_char = jnp.sum(w * jnp.log10(safe_ne)) / wsum
                return t_char, ln_char
            return kernel

        t_char, ln_char = self._jitted('char_conditions', build)(
            f, self.time)
        out = (float(t_char), 10.0 ** float(ln_char))
        cache[key] = out
        return out

    def departure_coefficients(self, line: str):
        """(b_n1, b_n2) for ``line`` from the bundled case-B hydrogenic
        b_n(n, T_e, n_e) table (ops.departure) at the jet's
        emission-weighted characteristic conditions.

        This is what ``lte=False`` uses when no explicit
        ``departure_coeffs`` are passed — completing the reference's
        unfinished non-LTE intent (classes.py:1258-1262 raises there;
        the scaffolding at maths/rrls.py:467-543 had no coefficient
        source).  The table is hydrogenic: for He/C RRLs at these
        principal quantum numbers the single-electron-around-a-core
        approximation holds to well below the solver's own rate-model
        accuracy, so the same b_n serve every supported element.

        Memoised per (line, model time): every non-LTE entry point calls
        here, and the characteristic-conditions reduction is a device
        dispatch and a host pull."""
        from ..ops import departure as dep
        cache = getattr(self, '_departure_cache', None)
        if cache is None:
            cache = self._departure_cache = {}
        key = (line, float(self.time))
        hit = cache.get(key)
        if hit is not None:
            return hit
        _, n, dn = mrrl.rrl_parser(line)
        t_char, ne_char = self.characteristic_conditions()
        b_n1, b_n2 = dep.b_n_pair(n, dn, t_char, ne_char)
        self._log.add_entry(
            "INFO",
            "Departure coefficients for {}: b_n1 = {:.4f}, b_n2 = {:.4f} "
            "(case-B table at EM-weighted T_e = {:.0f} K, "
            "n_e = {:.2e} cm^-3)".format(line, b_n1, b_n2, t_char,
                                         ne_char),
            timestamp=False)
        cache[key] = (b_n1, b_n2)
        return b_n1, b_n2

    def departure_coefficient_systematic(self, line: str):
        """(s_n1, s_n2): the collisional-rate-prescription systematic of
        :meth:`departure_coefficients` (ops.departure.b_n_systematic —
        the spread of the table under x0.5/x2 rate scaling, the van
        Regemorter/Thomson accuracy class).  Propagate into non-LTE fit
        uncertainties via :func:`rajepy_tpu.fit.rrl_departure_systematic`
        when the fit used table-derived coefficients."""
        from ..ops import departure as dep
        _, n, dn = mrrl.rrl_parser(line)
        t_char, ne_char = self.characteristic_conditions()
        return dep.b_n_pair_systematic(n, dn, t_char, ne_char)

    def departure_coefficients_at_scale(self, line: str, which: str):
        """(b_n1, b_n2) from the rate-scale-band edge tables
        (``which`` in 'lo'/'hi'/'central') at the jet's characteristic
        conditions — the COHERENT shifted pairs the systematic
        propagation uses (both levels at the same rate scale)."""
        from ..ops import departure as dep
        _, n, dn = mrrl.rrl_parser(line)
        t_char, ne_char = self.characteristic_conditions()
        return dep.b_n_pair(n, dn, t_char, ne_char, which)

    def departure_coefficient_maps(self, line: str):
        """Per-sightline (b_n1, b_n2) maps, shape (nx, nz): the case-B
        table evaluated at each LOS column's EM-weighted (T_e, n_e) —
        finer-grained than the global scalars of
        :meth:`departure_coefficients` (the slab composition itself
        operates per column on the LOS-mean temperature, so this is its
        natural granularity).  Columns with no jet cells return b = 1.
        Accepted directly as ``departure_coeffs=`` by the non-LTE entry
        points (the G&S coefficient algebra broadcasts)."""
        from ..ops import departure as dep
        _, n, dn = mrrl.rrl_parser(line)
        f = self._ensure_fields()

        def build():
            def kernel(f, t):
                n_e = self._nd_chi(f, t) * f.xi
                w = jnp.where(f.inside, n_e * n_e, 0.0)
                wsum = jnp.sum(w, axis=rt.LOS_AXIS)
                any_in = wsum > 0.0
                ws = jnp.where(any_in, wsum, 1.0)
                t_map = jnp.sum(w * f.temp, axis=rt.LOS_AXIS) / ws
                safe_ne = jnp.where(f.inside, jnp.maximum(n_e, 1e-30),
                                    1.0)
                ln_map = jnp.sum(w * jnp.log10(safe_ne),
                                 axis=rt.LOS_AXIS) / ws
                return t_map, ln_map, any_in
            return kernel

        t_map, ln_map, any_in = [np.asarray(a) for a in self._jitted(
            'char_condition_maps', build)(f, self.time)]
        t_q = np.where(any_in, t_map, 1e4)
        ne_q = 10.0 ** np.where(any_in, ln_map, 4.0)
        b1 = np.where(any_in, dep.b_n(n, t_q, ne_q), 1.0)
        b2 = np.where(any_in, dep.b_n(n + int(dn), t_q, ne_q), 1.0)
        return b1, b2

    def _check_nonlte(self, lte, departure_coeffs, line):
        """(b_n1, b_n2): 1 for LTE, the user-supplied pair (scalars or
        per-sightline (nx, nz) maps — see
        :meth:`departure_coefficient_maps`), or the table-derived scalar
        pair (the reference raises here, classes.py:1258-1262 — see
        :meth:`departure_coefficients`)."""
        if lte:
            return 1.0, 1.0
        if departure_coeffs is None:
            return self.departure_coefficients(line)
        b_n1, b_n2 = departure_coeffs
        if np.ndim(b_n1) or np.ndim(b_n2):
            return (jnp.asarray(b_n1, self._dtype),
                    jnp.asarray(b_n2, self._dtype))
        return float(b_n1), float(b_n2)

    def optical_depth_rrl(self, rrl: str, freq, lte: bool = True,
                          savefits: Union[bool, str] = False,
                          collapse: bool = True,
                          departure_coeffs=None) -> np.ndarray:
        """RRL optical depth (classes.py:1130-1229).  ``lte=False`` with
        ``departure_coeffs=(b_n1, b_n2)`` returns the non-LTE line
        opacity b_n1 beta tau_L* (beyond-reference; the reference raises
        on lte=False)."""
        b_n1, b_n2 = self._check_nonlte(lte, departure_coeffs, rrl)
        if not lte and not collapse:
            raise ValueError("non-LTE opacities are slab quantities: "
                             "collapse=False is LTE-only")
        f = self._ensure_fields()
        scalar = np.isscalar(freq)
        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        taus = np.asarray(self._rrl_kernel(rrl, 'tau', collapse,
                                           nonlte=not lte)(
            f, self.time, freqs, b_n1, b_n2))
        if savefits:
            self._save_rt_fits(taus, savefits, 'tau', freq, scalar, collapse)
        return taus[0] if scalar else taus

    def intensity_rrl(self, rrl: str, freq, lte: bool = True,
                      savefits: Union[bool, str] = False,
                      departure_coeffs=None) -> np.ndarray:
        """RRL intensity (classes.py:1231-1290; the reference's
        whole-array-inside-the-channel-loop defect is fixed — each channel
        uses its own frequency).  ``lte=False`` with
        ``departure_coeffs=(b_n1, b_n2)`` evaluates the non-LTE slab form
        (G&S eqs. 2.130/2.139/2.141) — beyond-reference; the reference
        raises on lte=False."""
        b_n1, b_n2 = self._check_nonlte(lte, departure_coeffs, rrl)
        f = self._ensure_fields()
        scalar = np.isscalar(freq)
        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        ints = np.asarray(self._rrl_kernel(rrl, 'intensity',
                                           nonlte=not lte)(
            f, self.time, freqs, b_n1, b_n2))
        if savefits:
            self._save_rt_fits(ints, savefits, 'intensity', freq, scalar,
                               True)
        return ints[0] if scalar else ints

    def flux_rrl(self, rrl: str, freq, lte: bool = True,
                 contsub: bool = True,
                 savefits: Union[bool, str] = False,
                 departure_coeffs=None) -> np.ndarray:
        """RRL flux [Jy/pixel], optionally with continuum
        (classes.py:1292-1351)."""
        scalar = np.isscalar(freq)
        freqs = np.atleast_1d(np.asarray(freq, dtype=float))
        ints = self.intensity_rrl(rrl, freqs, lte=lte,
                                  departure_coeffs=departure_coeffs)
        fluxes = ints * float(rt.flux_scale_jy(
            self.csize, self.params['target']['dist']))
        if not contsub:
            fluxes = fluxes + self.flux_ff(freqs)
        if savefits:
            self._save_rt_fits(fluxes, savefits, 'flux', freq, scalar, True)
        return fluxes[0] if scalar else fluxes

    # ------------------------------------------------------------------ #
    # Ordered RT along the LOS (beyond-reference capability)
    # ------------------------------------------------------------------ #
    def _emergent_tiles(self):
        """Cached compacted observer-ordered tiles for the emergent scan:
        (temp_t, a_t, tss_t, seg, jt, it, kt, n_seg, n_yt, n_xt, n_zt).
        Cubes are flipped along the LOS so y=0 faces the observer, then
        compacted in scan order (ops.tiles.active_tiles_scan_order)."""
        if getattr(self, '_emergent_tiles_cache', None) is None:
            f = self._ensure_fields()
            st = self._rt_static()

            @jax.jit
            def flipped(a, temp, inside, ts_signed):
                return (jnp.flip(a, 1), jnp.flip(jnp.where(inside, temp,
                                                           1.0), 1),
                        jnp.flip(inside, 1), jnp.flip(ts_signed, 1))

            a_f, temp_f, inside_f, tss_f = flipped(st.a, f.temp, f.inside,
                                                   st.ts_signed)
            ids, seg, jt, it, kt = tiles.active_tiles_scan_order(inside_f,
                                                                 **_TILE)
            ids_d = jnp.asarray(ids)
            self._emergent_tiles_cache = (
                tiles.gather_tiles(temp_f, ids_d, fill=1.0, **_TILE),
                tiles.gather_tiles(a_f, ids_d, **_TILE),
                tiles.gather_tiles(tss_f, ids_d, fill=1.0, **_TILE),
                jnp.asarray(seg), jnp.asarray(jt), jnp.asarray(it),
                jnp.asarray(kt), int(seg.max()) + 1,
                -(-self._ny // _TILE['y_chunk']),
                -(-self._nx // _TILE['block_x']),
                -(-self._nz // _TILE['block_z']))
        return self._emergent_tiles_cache

    def emergent_intensity_ff(self, freq) -> np.ndarray:
        """Emergent free-free intensity from the ordered transfer integral
        sum S_i e^-tau (1-e^-dtau) along the LOS (BASELINE north-star), in
        W m^-2 Hz^-1 sr^-1.  Reduces to the reference's slab form for an
        isothermal jet."""
        scalar = np.isscalar(freq)
        freqs = jnp.atleast_1d(jnp.asarray(freq, dtype=self._dtype))
        fn, args = self._emergent_program(self._tiled())
        ints = np.asarray(fn(*args, self.time, freqs))
        return ints[0] if scalar else ints

    def _emergent_program(self, tiled: bool):
        """``(fn, args)`` of the emergent scan, called as
        ``fn(*args, t, freqs)``: the ordered scan over the compacted
        jet-occupied tiles, or the XLA full-cube form."""
        t_0, reyn, csize, _ = self._rt_constants()

        if tiled:
            temp_t, a_t, tss_t, seg, jt, it, kt, n_seg, n_yt, n_xt, n_zt = \
                self._emergent_tiles()
            bursts = self._burst_tuple()
            off = getattr(self, '_ts_pack_offset', 1.0)

            def build():
                def kernel(temp_t, a_t, tss_t, seg, jt, it, kt, t, freqs):
                    # compacted ordered scan over jet-occupied tiles:
                    # burst factor per tile, no full-cube pre-pass
                    dt = temp_t.dtype
                    scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                    freqs64 = freqs.astype(jnp.float64)
                    cnu = 2.0 * cnsts.H_CGS * freqs64 ** 3 / cnsts.C_CGS ** 2
                    hnuk = cnsts.H_CGS * freqs64 / cnsts.K_CGS
                    parts, _ = tiles.emergent_ff_tiles(
                        cnu.astype(dt), hnuk.astype(dt), scale.astype(dt),
                        temp_t, a_t, tss_t, seg, jt, t, bursts, n_seg,
                        n_yt, pack_offset=off)
                    inten = tiles.scatter_tile_maps(parts, it, kt, n_xt,
                                                    n_zt, self._nx,
                                                    self._nz)
                    return inten * 1e-7 * 1e4
                return kernel

            return (self._jitted(('emergent_ff_tiles', bursts, n_seg), build),
                    (temp_t, a_t, tss_t, seg, jt, it, kt))

        def build():
            def kernel(f, a, t, freqs):
                # XLA formulation: channel axis vmapped over the 3-D scan
                base = a * self._chi2(f, t)
                scale = rt.tau_ff_channel_scale(freqs, t_0, reyn)
                dtau = scale[:, None, None, None] * base[None]
                src = mphys.blackbody_nu(
                    freqs[:, None, None, None],
                    jnp.where(f.inside, f.temp, 1.0)[None])
                src = jnp.where(f.inside[None], src, 0.0)
                scan = jax.vmap(rt.transfer_scan)
                return scan(src, dtau) * 1e-7 * 1e4
            return kernel

        return (self._jitted('emergent_ff', build),
                (self._ensure_fields(), self._rt_static()[0]))

    # ------------------------------------------------------------------ #
    # FITS output (classes.py:1543-1652)
    # ------------------------------------------------------------------ #
    def _save_rt_fits(self, data: np.ndarray, savefits: str, image_type: str,
                      freq, scalar: bool, collapse: bool):
        """Reorder axes per the reference's conventions and write."""
        if scalar:
            img = data[0]
            if collapse or img.ndim == 2:
                out = miscf.reorder_axes(img, ra_axis=0, dec_axis=1)
                los = False
            else:
                out = miscf.reorder_axes(img, ra_axis=0, dec_axis=2,
                                         axis3=1, axis3_type='y')
                los = True
            self.save_fits(out, savefits, image_type,
                           freq if np.ndim(freq) else [freq],
                           los_axis3=los)
        else:
            if collapse or data.ndim == 3:
                out = miscf.reorder_axes(data, ra_axis=1, dec_axis=2,
                                         axis3=0, axis3_type='freq')
                los = False
            else:
                out = miscf.reorder_axes(data, ra_axis=1, dec_axis=3,
                                         axis3=2, axis3_type='y',
                                         axis4=0, axis4_type='freq')
                los = True
            self.save_fits(out, savefits, image_type, freq,
                           los_axis3=los)

    def save_fits(self, data: np.ndarray, filename: str, image_type: str,
                  freq=None, los_axis3: bool = False):
        """Write a 2-D/3-D/4-D FITS image with the reference's WCS/units
        header (classes.py:1543-1652).

        ``los_axis3=True`` marks axis 3 (FITS counting) as the
        uncollapsed line-of-sight axis of a ``collapse=False`` product —
        written as a LINEAR axis in au, with the frequency axis (if any)
        as axis 4.  The reference crashes on both uncollapsed savefits
        shapes (its 4-D array fails the ndims check; its scalar 3-D call
        hits ``len()`` on a float, classes.py:1585/1619-1623) — writing
        a correct header instead is a deliberate fidelity deviation
        (PARITY.md)."""
        if image_type not in ('flux', 'tau', 'em', 'intensity'):
            raise ValueError("arg image_type must be one of 'flux', 'tau' "
                             "or 'em'")
        ra_deg = astro.parse_ra(self.params['target']['ra'])
        dec_deg = astro.parse_dec(self.params['target']['dec'])
        csize_deg = np.degrees(np.arctan(
            self.csize * cnsts.AU /
            (self.params['target']['dist'] * cnsts.PARSEC)))

        ndims = np.ndim(data)
        if ndims not in (2, 3) and not (ndims == 4 and los_axis3):
            raise ValueError(f"Unexpected number of data dimensions "
                             f"({ndims})")

        hdr = fitsio.Header()
        hdr['AUTHOR'] = 'rajepy_tpu'
        hdr['OBJECT'] = self.params['target']['name']
        hdr['CTYPE1'] = 'RA---TAN'
        hdr.comments['CTYPE1'] = 'x-coord type is RA Tan Gnomonic projection'
        hdr['CTYPE2'] = 'DEC--TAN'
        hdr.comments['CTYPE2'] = 'y-coord type is DEC Tan Gnomonic projection'
        hdr['EQUINOX'] = 2000.0
        hdr.comments['EQUINOX'] = 'Equinox of coordinates'
        hdr['CRPIX1'] = self.nx / 2 + 0.5
        hdr.comments['CRPIX1'] = 'Reference pixel in RA'
        hdr['CRPIX2'] = self.nz / 2 + 0.5
        hdr.comments['CRPIX2'] = 'Reference pixel in DEC'
        hdr['CRVAL1'] = ra_deg
        hdr.comments['CRVAL1'] = 'Reference pixel value in RA (deg)'
        hdr['CRVAL2'] = dec_deg
        hdr.comments['CRVAL2'] = 'Reference pixel value in DEC (deg)'
        hdr['CDELT1'] = -csize_deg
        hdr.comments['CDELT1'] = 'Pixel increment in RA (deg)'
        hdr['CDELT2'] = csize_deg
        hdr.comments['CDELT2'] = 'Pixel size in DEC (deg)'

        if los_axis3 and ndims >= 3:
            # uncollapsed line-of-sight axis (collapse=False products)
            n_y = np.shape(data)[-3]
            hdr['CTYPE3'] = 'LINEAR'
            hdr.comments['CTYPE3'] = 'Line-of-sight axis (uncollapsed)'
            hdr['CRPIX3'] = n_y / 2.0 + 0.5
            hdr.comments['CRPIX3'] = 'Reference pixel along the LOS'
            hdr['CRVAL3'] = 0.0
            hdr.comments['CRVAL3'] = 'LOS distance at reference pixel (au)'
            hdr['CDELT3'] = float(self.csize)
            hdr.comments['CDELT3'] = 'LOS pixel increment (au)'

        def _freq_axis(n: str):
            """The reference's spectral-axis cards (classes.py:1617-1639)
            on FITS axis ``n``, minus a defect: CRVAL is the frequency AT
            the reference pixel CRPIX for odd/single channel counts too
            (the reference is half a channel low there; even counts are
            bit-identical)."""
            fr = np.atleast_1d(np.asarray(freq, dtype=float))
            nchan = len(fr)
            chan_width = fr[1] - fr[0] if nchan != 1 else 1.0
            hdr[f'CTYPE{n}'] = 'FREQ'
            hdr.comments[f'CTYPE{n}'] = 'Spectral axis (frequency)'
            hdr[f'CRPIX{n}'] = nchan / 2.0 + 0.5
            hdr.comments[f'CRPIX{n}'] = \
                'Reference frequency (channel number)'
            hdr[f'CRVAL{n}'] = float(fr[0] + (nchan - 1) / 2.0 * chan_width)
            hdr.comments[f'CRVAL{n}'] = 'Reference frequency (Hz)'
            hdr[f'CDELT{n}'] = float(chan_width)
            hdr.comments[f'CDELT{n}'] = 'Frequency increment (Hz)'

        if image_type in ('flux', 'tau', 'intensity'):
            if ndims == 4:
                _freq_axis('4')
            elif ndims == 3 and not los_axis3:
                _freq_axis('3')
            elif ndims == 3:
                # scalar-frequency LOS cube: record the image frequency
                # without usurping the LOS axis-3 cards above
                fr = np.atleast_1d(np.asarray(freq, dtype=float))
                hdr['RESTFRQ'] = float(fr[0])
                hdr.comments['RESTFRQ'] = 'Image frequency (Hz)'
            else:
                freq_arr = np.atleast_1d(np.asarray(freq, dtype=float))
                hdr['CDELT3'] = 1.0
                hdr.comments['CDELT3'] = 'Frequency increment (Hz)'
                hdr['CRPIX3'] = 0.5
                hdr.comments['CRPIX3'] = \
                    'Reference frequency (channel number)'
                hdr['CRVAL3'] = float(freq_arr[0])
                hdr.comments['CRVAL3'] = 'Reference frequency (Hz)'

        hdr['BUNIT'] = {'flux': 'Jy pixel^-1',
                        'intensity': 'W m^-2 Hz^-1 sr^-1',
                        'em': 'pc cm^-6',
                        'tau': 'dimensionless'}[image_type]

        for line in str(self).split('\n'):
            hdr['HISTORY'] = line

        fitsio.write_fits(filename, np.nan_to_num(np.asarray(data), nan=0.0),
                          hdr, overwrite=True)

    # ------------------------------------------------------------------ #
    # Persistence (classes.py:1704-1713)
    # ------------------------------------------------------------------ #
    def _save_signature(self, with_fields: bool) -> str:
        """Fingerprint of everything :meth:`save` would write: the params
        tree (array bytes included — repr truncates), model time, and
        whether the fill-factor/area caches are part of the payload."""
        import hashlib
        h = hashlib.blake2b(digest_size=16)

        def feed(obj):
            if isinstance(obj, dict):
                for k in sorted(obj, key=str):
                    h.update(repr(k).encode())
                    feed(obj[k])
            elif isinstance(obj, (list, tuple)):
                h.update(b'[')
                for v in obj:
                    feed(v)
            elif isinstance(obj, np.ndarray):
                h.update(repr((obj.shape, str(obj.dtype))).encode())
                h.update(np.ascontiguousarray(obj).tobytes())
            else:
                h.update(repr(obj).encode())

        feed(self._params)
        h.update(repr((float(self.time), bool(with_fields),
                       str(self._dtype))).encode())
        return h.hexdigest()

    def save(self, filename: str):
        """Pickle params + expensive caches + model time
        (classes.py:1704-1713).  The fill-factor/area host copies are
        immutable per model and cached after the first pull — a pipeline
        saves several times per execute, and each is a full-cube
        device->host transfer.

        Writing the caches costs seconds of disk per save at 256^3+, so
        an up-to-date checkpoint (same content signature, recorded in a
        ``<filename>.sig`` sidecar alongside the pickle's byte size) is
        left untouched instead of rewritten — every ``Pipeline.execute``
        ends with a save of a model whose state rarely changed."""
        f = self._fields
        sig = self._save_signature(with_fields=f is not None)
        sig_file = filename + '.sig'
        if os.path.exists(filename) and os.path.exists(sig_file):
            try:
                with open(sig_file, 'rt') as fh:
                    old_sig, old_size = fh.read().split()
                unchanged = (old_sig == sig and
                             int(old_size) == os.path.getsize(filename))
            except (ValueError, OSError):
                unchanged = False
            if unchanged:
                if self.log:
                    self.log.add_entry(
                        "INFO", f"Model checkpoint {filename} is "
                                "up to date, not rewriting")
                return
        if f is not None and getattr(self, '_host_ff_cache', None) is None:
            self._host_ff_cache = (np.asarray(self.areas),
                                   np.asarray(self.fill_factor))
        areas, ffs = self._host_ff_cache if f is not None else (None, None)
        ps = {'params': self._params,
              'areas': areas,
              'ffs': ffs,
              'time': self.time,
              'log': None}
        if self.log:
            self.log.add_entry("INFO",
                               f"Saving physical model to {filename}")
        with miscf.atomic_write(filename) as fh:
            pickle.dump(ps, fh)
        with miscf.atomic_write(sig_file, mode='wt') as fh:
            fh.write(f"{sig} {os.path.getsize(filename)}")

    # ------------------------------------------------------------------ #
    def __str__(self) -> str:
        """Tabulated summary (classes.py:268-361)."""
        p = self.params
        rows = [
            ('epsilon', format(p['geometry']['epsilon'], '+.3f')),
            ('opang', format(p['geometry']['opang'], '+.0f') + ' deg'),
            ('q_v', format(p['power_laws']['q_v'], '+.3f')),
            ('q_T', format(p['power_laws']['q_T'], '+.3f')),
            ('q_x', format(p['power_laws']['q_x'], '+.3f')),
            ('q_n', format(p['power_laws']['q_n'], '+.3f')),
            ('q^d_v', format(p['power_laws']['q^d_v'], '+.3f')),
            ('q^d_T', format(p['power_laws']['q^d_T'], '+.3f')),
            ('q^d_x', format(p['power_laws']['q^d_x'], '+.3f')),
            ('q^d_n', format(p['power_laws']['q^d_n'], '+.3f')),
            ('q_tau', format(p['power_laws']['q_tau'], '+.3f')),
            ('cell', format(p['grid']['c_size'], '.1f') + ' au'),
            ('w_0', format(p['geometry']['w_0'], '.2f') + ' au'),
            ('r_0', format(p['geometry']['r_0'], '.2f') + ' au'),
            ('v_0', format(p['properties']['v_0'], '.0f') + ' km/s'),
            ('x_0', format(p['properties']['x_0'], '.3f')),
            ('n_0', format(p['properties']['n_0'], '.3e') + ' cm^-3'),
            ('T_0', format(p['properties']['T_0'], '.0e') + ' K'),
            ('f_R2B', format(self._ss_jml_rb_frac, '.2e')),
            ('i', format(p['geometry']['inc'], '+.1f') + ' deg'),
            ('theta', format(p['geometry']['pa'], '+.1f') + ' deg'),
            ('D', format(p['target']['dist'], '+.0f') + ' pc'),
            ('M*', format(p['target']['M_star'], '+.1f') + ' Msol'),
            ('R_1', format(p['target']['R_1'], '+.1f') + ' au'),
            ('R_2', format(p['target']['R_2'], '+.1f') + ' au'),
        ]
        t0s = np.atleast_1d(np.asarray(p['ejection']['t_0'], dtype=float))
        if len(t0s) > 0:
            rows.append(('t_now',
                         format(self.time / cnsts.YEAR, '+.3f') + ' yr'))

        w1 = max(len(r[0]) for r in rows + [('Parameter', '')]) + 2
        w2 = max(len(r[1]) for r in rows + [('', 'Value')]) + 2
        width = w1 + w2 + 3
        hline = width * '-'
        out = [hline, '/' + format('JET MODEL', '^' + str(width - 2)) + '/',
               hline,
               '|' + format('Parameter', '^' + str(w1)) + '|' +
               format('Value', '^' + str(w2)) + '|', hline]
        for key, val in rows:
            out.append('|' + format(key, '^' + str(w1)) + '|' +
                       format(val, '^' + str(w2)) + '|')
        out.append(hline)
        out.append('/' + format('BURSTS', '^' + str(width - 2)) + '/')
        out.append(hline)
        if len(t0s) == 0:
            out.append('|' + format(' None ', '-^' + str(width - 2)) + '|')
            out.append(hline)
            return '\n'.join(out) + '\n'
        cw = (width - 4) // 3
        cws = [cw + (1 if (width - 4) % 3 > i else 0) for i in range(3)]
        for hdr_row in (('t_0', 'FWHM', 'chi'), ('[yr]', '[yr]', '')):
            out.append('|' + '|'.join(
                format(h, '^' + str(cws[i]))
                for i, h in enumerate(hdr_row)) + '|')
        out.append(hline)
        hls = np.atleast_1d(np.asarray(p['ejection']['hl'], dtype=float))
        chis = np.atleast_1d(np.asarray(p['ejection']['chi'], dtype=float))
        for i, t0 in enumerate(t0s):
            vals = (format(t0, '.2f'), format(hls[i], '.2f'),
                    format(chis[i], '.2f'))
            out.append('|' + '|'.join(
                format(v, '^' + str(cws[j]))
                for j, v in enumerate(vals)) + '|')
        out.append(hline)
        return '\n'.join(out) + '\n'
