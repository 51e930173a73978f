"""CASA-free synthetic interferometric observations, entirely on device.

High-level driver mirroring the reference's simobserve/tclean/imfit stage
(classes.py:2490-2851 + casa/), with the external CASA binary replaced by:

1. uv-track generation from the bundled antenna configurations and
   observatory geometry (:mod:`.uvgen`, :mod:`.observatories`), including
   the reference's elevation windows and the east-west-interferometer
   8-scan hour-angle split (classes.py:2510-2586);
2. FFT sampling of the model FITS sky image at the uv points plus
   radiometer-equation thermal noise (:mod:`.sampler`) — the measurement
   set becomes an in-memory/npz visibility set;
3. Briggs-weighted gridding, FFT dirty imaging, Hogbom CLEAN
   (niter=500, nsigma=3, briggs robust=0.5 as tclean's defaults at
   classes.py:2771-2782) and Gaussian restoration (:mod:`.imaging`);
4. elliptical-Gaussian source fitting with CASA-imfit-compatible summary
   files (:mod:`.imfit`), estimates seeded from the Reynolds tau=1 surface
   exactly like the reference (classes.py:2720-2808).
"""
from __future__ import annotations

import hashlib
import os
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as cnsts
from ..io import fits as fitsio
from ..ops import astronomy as astro
from ..ops import geometry as mgeom
from ..ops import physics as mphys
from ..ops import paths
from ..utils.misc import atomic_write, casa_imfit_file_to_dict
from ..utils.profiling import KernelTimer, record_stage
from . import calibration, imaging, imfit as imfit_mod, observatories, \
    sampler, uvgen

__all__ = ["simulate_observation", "observatories", "uvgen", "sampler",
           "imaging", "imfit_mod", "calibration"]


def _product_path(fitsfile: str, suffix: str) -> str:
    """Sibling product filename: swap the '.fits' extension for
    ``suffix`` ('.pbcor.fits', '.estimates', ...).  A bare str.replace
    corrupts paths whose DIRECTORIES contain the substring (a model_dcy
    like '.../uvfits_demo/' turned the estimates path into a
    nonexistent directory — review r4)."""
    root, ext = os.path.splitext(fitsfile)
    if ext != '.fits':
        raise ValueError(f"expected a .fits product path, got {fitsfile}")
    return root + suffix


def _elevation_window(ra_deg, dec_deg, tscop, min_el):
    """Time above the elevation limit per day [s] (classes.py:2510-2529)."""
    lon, lat, _ = observatories.observatory_location(tscop)
    ra_hour = ra_deg / 15.0
    min_ha = ra_hour - 12.0
    if min_ha < 0:
        min_ha += 24.0
    el_range = (astro.elevation(ra_deg, dec_deg, lat, min_ha),
                astro.elevation(ra_deg, dec_deg, lat, ra_hour))
    if min(el_range) > min_el:
        time_up = int(24. * 60. * 60.)
    else:
        ha_lim = float(astro.ha(ra_deg, dec_deg, lat, min_el))
        if not np.isfinite(ha_lim):
            # arccos out of range: the source never rises above (or
            # never sets below) the elevation limit at this latitude —
            # int(nan) would raise a bare conversion error otherwise
            raise ValueError(
                f"target (dec={dec_deg:.2f} deg) never rises above the "
                f"elevation limit {min_el:.1f} deg at {tscop} "
                f"(latitude {lat:.2f} deg) — no observable time")
        time_up = int(7200.0 * ha_lim)
    return el_range, time_up, lon, lat


def simulate_observation(pipeline, run, min_el: float = 20.0,
                         seed: int = 11111,
                         max_time_samples: int = 512,
                         niter: int = 500, nsigma: float = 3.0,
                         weighting: str = 'briggs', robust: float = 0.5,
                         deconvolver: str = 'hogbom',
                         scales=(0, 3, 10),
                         smallscalebias: float = 0.0,
                         nterms: int = 2,
                         reffreq: Optional[float] = None,
                         cycleniter: int = 100,
                         uvtaper_as: Optional[float] = None,
                         pbcor: bool = False, pblimit: float = 0.2,
                         apply_pb: bool = True,
                         pb_model: str = 'gaussian',
                         pb_blockage_m: float = 0.0,
                         sefd: Optional[float] = None,
                         thermalnoise: str = 'radiometer',
                         user_pwv: float = 1.0,
                         t_ground: float = 270.0,
                         corruption: Optional[Dict] = None,
                         selfcal: Optional[str] = None,
                         selfcal_solint_s: Optional[float] = None,
                         selfcal_rounds: int = 1,
                         applycal_gains: Optional[str] = None,
                         save_products: tuple = (),
                         shard_imaging: bool = False,
                         reuse_vis: bool = False,
                         export_uvfits: bool = False
                         ) -> Dict[str, str]:
    """Synthesise an interferometric observation of ``run``'s sky model.

    Writes (under ``run.rt_dcy``): the visibility sets
    ``SynObs.<cfg>.vis.npz`` (clean) / ``...noisy.vis.npz``, the restored
    image ``SynObs.<cfg>.noisy.imaging.fits`` and, for continuum runs, the
    imfit estimates/summary files.  Returns a products dict using the
    reference's keys ('ms_clean', 'ms_noisy', 'clean_image').

    ``seed`` defaults to simobserve's thermal-noise seed (tasks.py:205).

    ``uvtaper_as`` applies tclean's outer uv taper (casa/tasks.py:254):
    a Gaussian weight rolloff whose image-plane FWHM is the given
    arcseconds, trading resolution for surface-brightness sensitivity.
    ``pbcor=True`` additionally writes a primary-beam-corrected image
    (``...imaging.pbcor.fits``, NaN below ``pblimit`` — tclean's
    ``pbcor``/``pblimit``, casa/tasks.py:241-242).

    ``pb_model`` selects the primary-beam shape used both in sampling
    (``apply_pb``) and in ``pbcor``: ``'gaussian'`` (default —
    FWHM 1.2 lambda/D, the model the reference registers for e-MERLIN)
    or ``'airy'`` (blocked-aperture Airy power pattern with central
    blockage ``pb_blockage_m`` metres — the voltage-pattern family
    CASA's vpmanager applies to VLA/ALMA-class dishes, with the
    characteristic sidelobes the Gaussian lacks).

    ``deconvolver`` selects the continuum (mfs) minor-cycle algorithm
    (cube runs always use the channel-batched Hogbom):

    * ``'hogbom'`` (default) — full-PSF greedy subtraction;
    * ``'clark'`` — tclean's DEFAULT deconvolver (casa/tasks.py:243):
      PSF-patch minor cycles with exact FFT major cycles
      (:func:`imaging.clark_clean`, ``cycleniter`` minor iterations
      per major cycle), same model as Hogbom at a fraction of the
      per-iteration cost on large images;
    * ``'multiscale'`` — :func:`imaging.multiscale_clean` with the
      given ``scales`` (pixels) and ``smallscalebias`` — tclean's
      multiscale mode (casa/tasks.py:242-244);
    * ``'mtmfs'`` — multi-term multi-frequency synthesis (Rau &
      Cornwell 2011; tclean's ``deconvolver='mtmfs'``/``nterms``,
      casa/tasks.py:243-246): Taylor-expands the sky spectrum about
      ``reffreq`` (default: the run centre frequency) and CLEANs the
      ``nterms`` Taylor planes jointly, so a continuum run with more
      than one channel (``chanws < bws``) yields the in-band
      spectral-index map.  Extra products: the tt1 Taylor image
      (``...imaging.tt1.fits``), ``alpha = tt1/tt0``
      (``...imaging.alpha.fits``, NaN where tt0 < 5 sigma) and its
      propagated 1-sigma error map (``...imaging.alpha.error.fits``,
      tclean's ``.alpha.error``).  Requires
      ``n_chan >= nterms``; not combinable with ``selfcal`` (the CLEAN
      component model is per-order, not a flat sky).

    ``thermalnoise='tsys-atm'`` switches the flat catalogue-SEFD
    radiometer noise to the atmosphere-aware model
    (:mod:`.atmosphere`): per-channel sigma scaled by
    Tsys(nu, elevation, ``user_pwv``, ``t_ground``) relative to the
    reference conditions — the analogue of CASA simobserve's
    ``thermalnoise='tsys-atm'`` with its ``user_pwv``/``t_ground`` knobs
    (tasks.py:196-206).  Default 'radiometer' (flat).

    ``corruption`` applies antenna-based complex gain errors to the
    noisy visibilities (the analogue of CASA ``sm.setgain``; the
    reference corrupts with thermal noise only): a dict with any of
    ``amp_rms`` (fractional), ``phase_rms_deg``, ``coherence_s`` (AR(1)
    gain coherence time) and ``seed``.  ``selfcal='phase'`` or
    ``'amp+phase'`` then runs one self-calibration loop on continuum
    runs — CLEAN, degrid the CLEAN component model, StEFCal gain solve
    (:mod:`.calibration`), applycal, re-image — with one gain solution
    per ``selfcal_solint_s`` seconds of track (default: a single
    solution for the whole observation).  ``selfcal_rounds`` iterates
    the loop with the usual reduction ladder — every round solves
    phase-only except the last, which uses the requested mode, and each
    round re-solves against the previous round's (better) CLEAN model.
    The restored image product is the post-selfcal image; the corrected
    visibilities are written as ``SynObs.<cfg>.selfcal.vis.npz``, the
    cumulative gain solutions as ``SynObs.<cfg>.selfcal.gains.npz``
    (``products['gains']``) and the solve is summarised in
    ``run.results['selfcal']``.

    ``applycal_gains`` transfers a gains product from another run to
    this one before imaging (CASA's applycal-with-a-gaintable): the
    standard recipe for line cubes, which lack the per-solint SNR to
    self-calibrate — solve on the continuum, apply to the cube.  The
    antenna count must match; solutions are stretched over this run's
    time axis by the solver's equal-interval rule.

    ``save_products`` exports tclean's auxiliary images alongside the
    restored one (the reference keeps CASA's ``.psf``/``.residual``/
    ``.model`` directories, README "Data products"): any of ``'psf'``,
    ``'dirty'``, ``'model'``, ``'residual'``, written as
    ``...imaging.<name>.fits`` and added to the products dict.  Cube
    runs support ``'psf'`` (common-beam plane) and ``'dirty'``;
    ``'model'``/``'residual'`` are mfs-only (per-channel CLEAN state is
    not drained from the device — a 1,000-channel residual cube is
    another GB of host traffic; re-image from the saved visibility
    products if needed).  Default: none.

    ``shard_imaging=True`` images a line cube with its channels spread
    over all visible devices (parallel.sharding.sharded_clean_cube);
    by default it runs on one device.

    ``reuse_vis=True`` enables stage-level resume: the sampled (clean
    and noisy) visibility sets are written to disk BEFORE imaging, and
    a rerun that finds matching saved sets (same sky model, uv plan,
    seed and corruption signature) loads them and skips straight to
    imaging.  This bounds the cost of an imaging-stage failure: a
    killed process loses all device state, and re-sampling a
    1,000-channel cube is lost work (the role CASA's on-disk measurement
    set plays between simobserve and tclean).  ``Pipeline.execute(resume=True)`` passes this through
    automatically; a changed model or observation invalidates the
    signature and resamples.

    ``export_uvfits=True`` additionally writes the clean and noisy
    visibility sets as standard random-groups UVFITS files (with AIPS
    AN antenna tables) next to the ``.vis.npz`` sets — openable by real
    CASA (``importuvfits``), AIPS and difmap for reprocessing outside
    this framework (:mod:`.uvfits`); products keys ``uvfits_clean``/
    ``uvfits_noisy``.  Enable pipeline-wide via the params file:
    ``params['synthobs'] = {'export_uvfits': True}``.
    """
    if pb_model not in ('gaussian', 'airy'):
        raise ValueError(f"unknown pb_model {pb_model!r} (gaussian/airy)")
    if isinstance(save_products, str):
        save_products = (save_products,)
    unknown = set(save_products) - {'psf', 'dirty', 'model', 'residual'}
    if unknown:
        raise ValueError(f"save_products: unknown name(s) {sorted(unknown)}"
                         " — choose from psf/dirty/model/residual")
    model = pipeline.model
    log = pipeline.log
    tscop, t_cfg = run.tscop
    ant_file = observatories.cfg_file(tscop, t_cfg)
    ant = observatories.read_antenna_config(ant_file)

    ra_deg = astro.parse_ra(model.params['target']['ra'])
    dec_deg = astro.parse_dec(model.params['target']['dec'])

    # --- observation plan (classes.py:2510-2586) ----------------------- #
    el_range, time_up, lon, lat = _elevation_window(ra_deg, dec_deg, tscop,
                                                    min_el)
    ew_int = tscop in observatories.EW_TELESCOPES
    plan = uvgen.plan_scans(run.t_obs, time_up, ew_int)
    if log:
        log.add_entry(
            "INFO",
            "Target elevation range of {:+.0f} to {:+.0f}deg with minimum "
            "elevation of {}deg and total time on target of {:.1f}hr, means "
            "splitting observations over {} run(s)".format(
                el_range[0], el_range[1], min_el, run.t_obs / 3600,
                len(plan['durations'])), timestamp=False)

    # --- uv tracks ------------------------------------------------------ #
    with KernelTimer("synthobs: uv tracks", log):
        bl, _pairs = uvgen.baselines(ant['xyz'])
        uvw_list = []
        n_int_true = 0
        for dur, ha_c in zip(plan['durations'], plan['ha_centres']):
            has = uvgen.scan_hour_angles(ha_c, dur, run.t_int,
                                         max_samples=max_time_samples)
            n_int_true += max(1, int(round(dur / run.t_int)))
            uvw_list.append(uvgen.uvw_tracks(bl, has, dec_deg, lon))
        uvw = np.concatenate(uvw_list, axis=0).reshape(-1, 3)

    # --- sky model ------------------------------------------------------ #
    sky, hdr = fitsio.read_fits(run.fits_flux)
    if sky.ndim == 2:
        sky = sky[None]
    n_chan = sky.shape[0]
    cell_model_rad = abs(float(hdr['CDELT2'])) * np.pi / 180.0
    freqs = np.asarray(run.chan_freqs, dtype=float)[:n_chan]

    # --- beam / image geometry (classes.py:2656-2759) ------------------- #
    max_bl = observatories.max_baseline(ant_file)
    max_bl_uvwave = max_bl / (cnsts.C / run.freq)
    beam_min_as = 1.0 / max_bl_uvwave / cnsts.ARCSEC
    cell_as = beam_min_as / 4.0
    cell_rad = cell_as * cnsts.ARCSEC
    if log:
        log.add_entry(
            "INFO",
            "With maximum baseline length of {:.0e} wavelengths, a beam "
            "width of {:.2e}arcsec is calculated and therefore using a "
            "cell size of {:.2e}arcsec".format(max_bl_uvwave, beam_min_as,
                                               cell_as), timestamp=False)

    ny_m, nx_m = sky.shape[-2:]
    min_imsize_as = max(nx_m, ny_m) * abs(float(hdr['CDELT2'])) * 7200.0
    imsize = max(500, int(np.ceil(min_imsize_as / cell_as)))
    imsize += imsize % 2

    # small-field (coplanar) validity check: the FFT sampler drops the
    # w(n-1) phase; when the a-priori bound says it matters
    # (long-baseline configs — VLBA/LOFAR/ngVLA — at wide model fields)
    # switch the forward model to w-stacking with enough planes to hold
    # the residual under ~1e-3 per unit flux (CASA's simobserve computes
    # the full measurement equation; tclean's default 'standard' gridder
    # images without w-correction, which the imaging stage below matches)
    field_radius_rad = 0.5 * max(nx_m, ny_m) * cell_model_rad
    w_phase = sampler.w_term_max_phase_error(uvw, float(np.max(freqs)),
                                             field_radius_rad)
    w_planes = 0
    if w_phase > 0.1:
        w_planes = sampler.n_wplanes_for(uvw, float(np.max(freqs)),
                                         field_radius_rad)
        if log:
            log.add_entry(
                "INFO",
                "non-coplanar (w-term) phase error bound {:.2f} rad at "
                "the field edge exceeds 0.1 rad (max|w|={:.2e} m, field "
                "radius {:.1f}\"): sampling visibilities by w-stacking "
                "over {} plane(s)".format(
                    w_phase, float(np.max(np.abs(uvw[:, 2]))),
                    field_radius_rad / cnsts.ARCSEC, w_planes),
                timestamp=False)

    # the sky model carries no information beyond its pixel Nyquist
    # 1/(2 cell): baselines out there degrid to 0 (sampler r4) — warn,
    # since it means the model grid is too coarse for this array
    uv_max_wav = float(np.max(np.abs(uvw[:, :2]))) * \
        float(np.max(freqs)) / cnsts.C
    nyq_wav = 0.5 / cell_model_rad
    if uv_max_wav > nyq_wav and log:
        log.add_entry(
            "WARNING",
            "longest baseline ({:.3g} wavelengths) exceeds the sky "
            "model's pixel Nyquist ({:.3g}; model cell {:.2e} rad) — "
            "those visibilities carry zero model flux; use a finer "
            "model grid (smaller c_size or larger n_x/n_z) for this "
            "array".format(uv_max_wav, nyq_wav, cell_model_rad),
            timestamp=False)

    # --- visibilities per channel --------------------------------------- #
    lam = cnsts.C / freqs
    key = jax.random.PRNGKey(seed)
    # per-vis noise; scale so the *imaged* noise matches the true number of
    # integrations even when time samples were decimated
    sefd_val = sefd if sefd is not None else \
        observatories.DEFAULT_SEFD.get(tscop, 500.0)
    n_samp = uvw.shape[0] // bl.shape[0] if bl.shape[0] else 1
    t_int_eff = run.t_int * max(n_int_true / max(n_samp, 1), 1.0)
    sigma = sampler.thermal_noise_sigma(sefd_val, run.chanwidth, t_int_eff)
    if thermalnoise == 'tsys-atm':
        # atmosphere-aware Tsys (CASA tsys-atm analogue): scale the
        # catalogue-SEFD sigma per channel by Tsys(nu, el, pwv)/Tsys_ref
        # at the track-mean elevation.  Elevations are sampled ACROSS
        # each scan's hour-angle span (non-EW plans centre every scan on
        # transit, so the centre alone would always be the transit
        # elevation), and the LST wraps into [0, 24).
        from . import atmosphere
        ra_hour = ra_deg / 15.0
        els, wts = [], []
        for dur, ha_c in zip(plan['durations'], plan['ha_centres']):
            half_h = 0.5 * dur / 3600.0
            for ha in np.linspace(ha_c - half_h, ha_c + half_h, 5):
                els.append(astro.elevation(ra_deg, dec_deg, lat,
                                           (ra_hour + ha) % 24.0))
                wts.append(dur)  # time-weighted track mean
        el_mean = float(np.average(els, weights=wts)) if els else 90.0
        sigma = sigma * atmosphere.sefd_scale(freqs, el_mean, user_pwv,
                                              t_ground)
        if log:
            log.add_entry(
                "INFO",
                "tsys-atm noise: pwv={:.1f}mm, t_ground={:.0f}K, mean "
                "elevation {:.0f}deg -> sigma x{:.2f}-{:.2f} vs flat "
                "radiometer".format(user_pwv, t_ground, el_mean,
                                    float(np.min(sigma)) /
                                    sampler.thermal_noise_sigma(
                                        sefd_val, run.chanwidth,
                                        t_int_eff),
                                    float(np.max(sigma)) /
                                    sampler.thermal_noise_sigma(
                                        sefd_val, run.chanwidth,
                                        t_int_eff)), timestamp=False)
    elif thermalnoise != 'radiometer':
        raise ValueError(f"unknown thermalnoise mode {thermalnoise!r}")

    # compute precision: an accelerator runs the whole uv/imaging chain
    # in f32/c64 (ample dynamic range for noise-dominated synthetic
    # observations, half the bytes of f64/c128); the CPU keeps f64
    rdt = paths.compute_dtype('auto')

    # --- stage-level resume (reuse_vis) ---------------------------------- #
    # visibility products live under run.rt_dcy/SynObs; paths are fixed
    # before sampling so the sets can be written pre-imaging and found
    # again by a resumed process
    base = os.path.basename(ant_file)
    if base.endswith('.cfg'):
        base = base[:-4]
    synobs_dcy = os.path.join(run.rt_dcy, 'SynObs')
    clean_vis_file = os.path.join(synobs_dcy, f'SynObs.{base}.vis.npz')
    noisy_vis_file = os.path.join(synobs_dcy,
                                  f'SynObs.{base}.noisy.vis.npz')
    # primary-beam width input to the sampler — part of the visibility
    # signature (an antenna-diameter edit changes the sampled PB even
    # when the positions, and so the uvw bytes, are unchanged)
    mean_dish = float(np.mean(ant['diam'])) if len(ant['diam']) else 25.0

    def _vis_signature() -> str:
        """Fingerprint of everything upstream of the sampled
        visibilities: sky model bytes, uv plan, noise model, seed and
        the corruption / gain-transfer configuration.  A rerun whose
        signature matches may safely reuse the saved sets."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(sky).tobytes())
        h.update(np.ascontiguousarray(uvw).tobytes())
        h.update(np.ascontiguousarray(np.asarray(sigma)).tobytes())
        h.update(np.asarray(freqs).tobytes())
        # 'centre-fits' tokens the phase-centre convention: vis sets
        # sampled before the r4 WCS re-referencing must not be reused
        parts = [sky.shape, int(seed), bool(apply_pb), pb_model,
                 float(pb_blockage_m), int(w_planes), mean_dish,
                 sorted((corruption or {}).items()), 'centre-fits']
        if applycal_gains:
            st = os.stat(applycal_gains)
            parts.append((os.path.abspath(applycal_gains),
                          st.st_size, st.st_mtime_ns))
        h.update(repr(parts).encode())
        return h.hexdigest()

    vis_sig = _vis_signature()
    reused = False
    if reuse_vis and os.path.exists(clean_vis_file) \
            and os.path.exists(noisy_vis_file):
        try:
            with np.load(clean_vis_file) as fc, \
                    np.load(noisy_vis_file) as fn:
                if (str(fc.get('resume_sig', '')) == vis_sig and
                        str(fn.get('resume_sig', '')) == vis_sig):
                    re_cn, im_cn = fc['vis_re'], fc['vis_im']
                    re_nn, im_nn = fn['vis_re'], fn['vis_im']
                    reused = True
        except (OSError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile):
            reused = False      # unreadable / truncated set: resample
    if reused and log:
        log.add_entry(
            "INFO",
            "Reusing sampled visibilities from {} (signature match — "
            "skipping the sampling/corruption stages)".format(
                os.path.basename(noisy_vis_file)), timestamp=False)

    # all channels batched on device: FFT each channel's sky plane, apply
    # its own Gaussian primary beam (the role of CASA's vpmanager PB,
    # casa/_interface.py:17-27) and sample at its own uv wavelengths
    # (mean_dish computed above, as part of the visibility signature)
    if not reused:
        with KernelTimer("synthobs: vis sampling (+noise)", log) as kt:
            key, sub = jax.random.split(key)
            re_c, im_c, re_n, im_n = sampler.sample_vis_cube_with_noise(
                jnp.asarray(sky, rdt), cell_model_rad,
                jnp.asarray(uvw, rdt),
                jnp.asarray(freqs, rdt), sub, sigma, apply_pb=apply_pb,
                dish_diameter_m=mean_dish, w_planes=w_planes,
                pb_model=pb_model, pb_blockage_m=pb_blockage_m,
                centre='fits')
            kt.set_result((re_c, im_c, re_n, im_n))
        # keep visibilities as (re, im) float pairs end to end: a
        # (2x-sized) complex128 host copy of a 1,000-channel set costs
        # gigabytes for nothing.  ONE device_get for all four arrays
        re_cn, im_cn, re_nn, im_nn = jax.device_get(
            (re_c, im_c, re_n, im_n))

    # --- antenna gain corruption (sm.setgain analogue) ------------------- #
    n_ant = ant['xyz'].shape[0]
    if corruption and not reused:
        g_re, g_im = calibration.simulate_gain_errors(
            int(corruption.get('seed', seed + 1)), n_samp, n_ant,
            amp_rms=float(corruption.get('amp_rms', 0.0)),
            phase_rms_deg=float(corruption.get('phase_rms_deg', 0.0)),
            coherence_s=corruption.get('coherence_s'),
            t_int_s=t_int_eff)
        ant1, ant2, t_index = calibration.vis_metadata(n_samp, _pairs)
        with KernelTimer("synthobs: gain corruption", log):
            re_nn, im_nn = jax.device_get(calibration.apply_gains(
                jnp.asarray(re_nn, rdt), jnp.asarray(im_nn, rdt),
                jnp.asarray(g_re, rdt), jnp.asarray(g_im, rdt),
                ant1, ant2, t_index))
        if log:
            log.add_entry(
                "INFO",
                "Applied antenna gain corruption: amp_rms={:.3f}, "
                "phase_rms={:.1f}deg, coherence={}s over {} antennas x "
                "{} integrations".format(
                    float(corruption.get('amp_rms', 0.0)),
                    float(corruption.get('phase_rms_deg', 0.0)),
                    corruption.get('coherence_s'), n_ant, n_samp),
                timestamp=False)

    # --- gain transfer (applycal with a gains product) ------------------- #
    if applycal_gains and not reused:
        gt = np.load(applycal_gains)
        g_re_t = np.asarray(gt['g_re'])
        g_im_t = np.asarray(gt['g_im'])
        if g_re_t.shape[-1] != n_ant:
            raise ValueError(
                f"applycal_gains has {g_re_t.shape[-1]} antennas, this "
                f"run's array has {n_ant} — gain transfer needs the "
                "same antenna configuration")
        g_mag = np.hypot(g_re_t, g_im_t)
        if not np.all(g_mag > 0.0):
            raise ValueError(
                "applycal_gains contains zero gains (applycal divides "
                "by g_i conj(g_j) — a zero would produce inf/NaN "
                "visibilities); flag the dead antenna's solutions to "
                "1+0j before transfer")
        ant1, ant2, t_index = calibration.vis_metadata(n_samp, _pairs)
        with KernelTimer("synthobs: applycal (gain transfer)", log):
            re_nn, im_nn = jax.device_get(calibration.correct_vis(
                jnp.asarray(re_nn, rdt), jnp.asarray(im_nn, rdt),
                g_re_t, g_im_t, ant1, ant2, t_index, n_samp))
        if log:
            log.add_entry(
                "INFO",
                "Applied transferred gain solutions from {} "
                "({} solution interval(s) stretched over {} "
                "integrations)".format(os.path.basename(applycal_gains),
                                       g_re_t.shape[0], n_samp),
                timestamp=False)

    # --- visibility products, written BEFORE imaging ---------------------- #
    # the measurement-set analogue hits disk as soon as it exists, so an
    # imaging-stage failure (e.g. a killed process) never loses the
    # sampling stage: a reuse_vis rerun resumes from here
    if not reused:
        os.makedirs(synobs_dcy, exist_ok=True)
        with KernelTimer("synthobs: vis npz write", log):
            # uncompressed, (re, im) float pairs at compute precision:
            # noisy visibilities are incompressible, and zlib over a
            # multi-GB complex128 copy dominated the 1,000-channel
            # pipeline's wall time
            with atomic_write(clean_vis_file) as f:
                np.savez(f, uvw=uvw, vis_re=re_cn, vis_im=im_cn,
                         freqs=freqs, sigma=0.0, resume_sig=vis_sig)
            with atomic_write(noisy_vis_file) as f:
                np.savez(f, uvw=uvw, vis_re=re_nn, vis_im=im_nn,
                         freqs=freqs, sigma=sigma, resume_sig=vis_sig)

    uvfits_files = {}
    if export_uvfits:
        # standard-format copies of the visibility sets, openable by
        # real CASA (importuvfits)/AIPS/difmap — the interoperability
        # the reference got for free from CASA's own measurement sets
        from . import uvfits as uvfits_mod
        a1, a2, t_idx = calibration.vis_metadata(n_samp, _pairs)
        time_s = (t_idx + 0.5) * t_int_eff
        for tag, (vr, vi, sg) in {
                'uvfits_clean': (re_cn, im_cn, 0.0),
                'uvfits_noisy': (re_nn, im_nn, sigma)}.items():
            suffix = '.uvfits' if tag.endswith('clean') else \
                '.noisy.uvfits'
            fname = os.path.join(synobs_dcy, f'SynObs.{base}{suffix}')
            with KernelTimer(f"synthobs: {tag} write", log):
                uvfits_mod.write_uvfits(
                    fname, uvw, vr, vi, freqs, ant['xyz'], a1, a2,
                    time_s, ra_deg, dec_deg, sigma=sg,
                    ant_names=ant.get('names'), source='TARGET',
                    telescope=str(tscop))
            uvfits_files[tag] = fname
        if log:
            log.add_entry(
                "INFO",
                "Exported UVFITS visibility sets (clean + noisy) to "
                f"{os.path.basename(uvfits_files['uvfits_noisy'])}",
                timestamp=False)

    # --- imaging (classes.py:2761-2788) ---------------------------------- #
    # multi-frequency synthesis: all channels on one grid (continuum) or a
    # per-channel cube (RRL)
    cube_mode = run.obs_type != 'continuum'

    if weighting not in ('briggs', 'uniform', 'natural'):
        raise ValueError(f"unknown weighting {weighting!r}")
    if deconvolver not in ('hogbom', 'clark', 'multiscale', 'mtmfs'):
        raise ValueError(f"unknown deconvolver {deconvolver!r}")
    if deconvolver != 'hogbom' and cube_mode:
        raise ValueError(f"deconvolver={deconvolver!r} is continuum "
                         "(mfs) only; cube runs use the channel-batched "
                         "Hogbom")
    if deconvolver == 'mtmfs':
        nterms = int(nterms)
        if nterms < 2 or nterms > 4:
            raise ValueError(f"mtmfs needs 2 <= nterms <= 4, got {nterms}")
        if n_chan < nterms:
            raise ValueError(
                f"mtmfs with nterms={nterms} needs at least that many "
                f"channels to constrain the Taylor planes; this run has "
                f"{n_chan} (set the run's chanws below its bws)")
        if selfcal:
            raise ValueError("selfcal with deconvolver='mtmfs' is not "
                             "supported (the CLEAN component model is "
                             "per-Taylor-order, not a flat sky); "
                             "selfcal with clark/hogbom/multiscale, or "
                             "transfer gains via applycal_gains")
    if selfcal not in (None, 'phase', 'amp+phase'):
        raise ValueError(f"unknown selfcal mode {selfcal!r}")
    selfcal_rounds = int(selfcal_rounds)
    if selfcal and selfcal_rounds < 1:
        raise ValueError("selfcal_rounds must be >= 1")
    if selfcal and cube_mode:
        raise ValueError("selfcal is continuum (mfs) only: line cubes "
                         "lack the per-solint SNR for a gain solve; "
                         "transfer continuum solutions instead")

    def uvtaper_weights(us, vs):
        """tclean's outer uv taper: Gaussian rolloff in weight whose
        image-plane FWHM is uvtaper_as arcsec (FWHM_uv =
        4 ln2 / (pi FWHM_sky))."""
        if uvtaper_as is None:
            return np.ones_like(us)
        theta = float(uvtaper_as) * cnsts.ARCSEC
        fwhm_uv = 4.0 * np.log(2.0) / (np.pi * theta)
        return np.exp(-4.0 * np.log(2.0) * (us ** 2 + vs ** 2) /
                      fwhm_uv ** 2)

    _wb_cache: Dict = {}      # imaging weights depend on uv only, not on
    # the visibility values — selfcal re-images per round, so cache them

    def image_channels(chan_idx, vr_all=None, vi_all=None):
        us = (uvw[None, :, 0] / lam[chan_idx, None]).ravel()
        vs = (uvw[None, :, 1] / lam[chan_idx, None]).ravel()
        vr = (re_nn if vr_all is None else vr_all)[chan_idx].ravel()
        vi = (im_nn if vi_all is None else vi_all)[chan_idx].ravel()
        # key on the full index content — (min, max, size) collides for
        # different non-contiguous selections of the same span
        key = np.ascontiguousarray(np.asarray(chan_idx)).tobytes()
        wb = _wb_cache.get(key)
        if wb is None:
            w0 = uvtaper_weights(us, vs)
            # cached as a DEVICE array: the weights are consumed on
            # device below (and again per selfcal round), so they never
            # go to the host and back
            if weighting == 'briggs':
                wb = imaging.briggs_weights(
                    jnp.asarray(us, rdt), jnp.asarray(vs, rdt),
                    jnp.asarray(w0, rdt), imsize, cell_rad,
                    robust=robust)
            elif weighting == 'uniform':
                wb = imaging.briggs_weights(
                    jnp.asarray(us, rdt), jnp.asarray(vs, rdt),
                    jnp.asarray(w0, rdt), imsize, cell_rad, robust=-2.0)
            else:
                wb = w0
            _wb_cache[key] = wb
        dirty, psf = imaging.grid_and_image_parts(
            jnp.asarray(us, rdt), jnp.asarray(vs, rdt),
            jnp.asarray(vr, rdt), jnp.asarray(vi, rdt),
            jnp.asarray(wb, rdt), imsize, cell_rad)
        # one batched pull (single round trip) instead of two
        return jax.device_get((dirty, psf))

    # CLEAN mask: the model's bounding box mapped into the new image
    # (classes.py:2688-2751)
    model_extent_x_as = nx_m * abs(float(hdr['CDELT1'])) * 3600.0
    model_extent_y_as = ny_m * abs(float(hdr['CDELT2'])) * 3600.0
    half_x = int(np.ceil(model_extent_x_as / cell_as / 2.0)) + 2
    half_y = int(np.ceil(model_extent_y_as / cell_as / 2.0)) + 2
    mask = np.zeros((imsize, imsize))
    c0 = imsize // 2
    mask[max(c0 - half_y, 0):c0 + half_y,
         max(c0 - half_x, 0):c0 + half_x] = 1.0

    re_sc = im_sc = None            # selfcal-corrected visibilities
    extra_maps = {}                 # save_products captures (last imaging)
    mtmfs_maps: Dict[str, np.ndarray] = {}   # tt1/alpha (mtmfs only)
    if cube_mode:
        # common restoring beam fitted to the central channel's PSF
        # (tclean 'commonbeam' behaviour), then every channel — weighting,
        # gridding, FFT, CLEAN, restoration — in ONE device-side program
        with KernelTimer(f"synthobs: cube imaging ({n_chan} chan, "
                         f"{imsize}px)", log) as kt:
            _, psf0 = image_channels(np.asarray([n_chan // 2]))
            beam = imaging.fit_psf_beam(psf0, cell_rad)
            # per-visibility taper evaluated at the run centre frequency
            # (narrow-fractional-bandwidth cubes; per-channel deviation
            # ~ (dnu/nu)^2)
            lam_c = cnsts.C / run.freq
            w_vis = uvtaper_weights(uvw[:, 0] / lam_c, uvw[:, 1] / lam_c)
            beam_kernel = imaging.gaussian_beam_kernel(
                imsize, cell_rad, beam[0], beam[1], beam[2])
            n_dev = jax.device_count()
            # the channel-sharded CLEAN is opt-in: on four H100s its
            # dirty cube differed from the one-device path by up to
            # 1.5e-3 of a channel's maximum, for a cause not yet found
            # (PERF.md); on CPU devices the two agree exactly
            if shard_imaging and n_dev > 1 and n_chan >= n_dev:
                # channel-data-parallel cube imaging: each device CLEANs
                # its own channel shard (the reference's tclean cube is
                # strictly sequential, classes.py:2771-2782)
                from ..parallel import sharding as pshard
                from jax.sharding import Mesh
                mesh = Mesh(np.array(jax.devices()).reshape(n_dev, 1),
                            axis_names=('chan', 'los'))
                if log:
                    log.add_entry(
                        "INFO", f"Imaging {n_chan} channels across "
                                f"{n_dev} devices (channel-sharded "
                                "CLEAN)", timestamp=False)
                with mesh:
                    restored_j, dirty_j = pshard.sharded_clean_cube(
                        mesh, jnp.asarray(uvw, rdt),
                        jnp.asarray(freqs, rdt),
                        jnp.asarray(re_nn, rdt), jnp.asarray(im_nn, rdt),
                        jnp.asarray(w_vis, rdt), imsize, cell_rad,
                        jnp.asarray(mask, rdt),
                        jnp.asarray(beam_kernel, rdt),
                        weighting=weighting, robust=robust, gain=0.1,
                        niter=niter, nsigma=nsigma)
            else:
                restored_j, dirty_j = imaging.clean_cube(
                    jnp.asarray(uvw[:, :2], rdt), jnp.asarray(freqs, rdt),
                    jnp.asarray(re_nn, rdt), jnp.asarray(im_nn, rdt),
                    jnp.asarray(w_vis, rdt), imsize, cell_rad,
                    jnp.asarray(mask, rdt), jnp.asarray(beam_kernel, rdt),
                    weighting=weighting, robust=robust, gain=0.1,
                    niter=niter, nsigma=nsigma)
            if save_products and 'dirty' in save_products:
                restored_cube, extra_maps['dirty'] = jax.device_get(
                    (restored_j, dirty_j))
            else:
                restored_cube = np.asarray(restored_j)
            if save_products:
                extra_maps['psf'] = np.asarray(psf0)
    else:
        # multi-frequency synthesis: all channels on one grid
        def mfs_image(vr_all, vi_all, label=''):
            with KernelTimer(f"synthobs: mfs imaging ({imsize}px"
                             f"{label})", log):
                dirty, psf = image_channels(np.arange(n_chan),
                                            vr_all, vi_all)
                outside = dirty[mask == 0]
                rms = float(np.std(outside)) if outside.size else 0.0
                if deconvolver == 'multiscale':
                    mdl, resid, its = imaging.multiscale_clean(
                        jnp.asarray(dirty, rdt), jnp.asarray(psf, rdt),
                        jnp.asarray(mask, rdt),
                        scales=tuple(scales), gain=0.1, niter=niter,
                        threshold=nsigma * rms,
                        smallscalebias=smallscalebias)
                elif deconvolver == 'clark':
                    mdl, resid, its = imaging.clark_clean(
                        jnp.asarray(dirty, rdt), jnp.asarray(psf, rdt),
                        jnp.asarray(mask, rdt), gain=0.1, niter=niter,
                        threshold=nsigma * rms, cycleniter=cycleniter)
                else:
                    mdl, resid, its = imaging.hogbom_clean(
                        jnp.asarray(dirty, rdt), jnp.asarray(psf, rdt),
                        jnp.asarray(mask, rdt), gain=0.1, niter=niter,
                        threshold=nsigma * rms)
                beam = imaging.fit_psf_beam(psf, cell_rad)
                beam_kernel = imaging.gaussian_beam_kernel(
                    imsize, cell_rad, beam[0], beam[1], beam[2])
                # restored + model (+ residual) in one batched pull
                restored_dev = imaging.restore(mdl, resid,
                                               beam_kernel.astype(rdt))
                if save_products:
                    restored, mdl_np, resid_np = jax.device_get(
                        (restored_dev, mdl, resid))
                    extra_maps.update(psf=psf, dirty=dirty,
                                      model=mdl_np, residual=resid_np)
                else:
                    restored, mdl_np = jax.device_get((restored_dev, mdl))
            return restored, mdl_np, beam

        def dynamic_range(img):
            noise = img[mask == 0]
            sd = float(np.std(noise)) if noise.size else 0.0
            return float(np.nanmax(img)) / sd if sd > 0 else np.inf

        def mtmfs_image():
            """Multi-term MFS: per-channel dirty/PSF stacks, Taylor
            moments, joint minor cycle, Taylor-plane restoration."""
            with KernelTimer(f"synthobs: mtmfs imaging ({n_chan} chan, "
                             f"{imsize}px, nterms={nterms})", log):
                d_list, p_list = [], []
                for ci in range(n_chan):
                    d, p = image_channels(np.asarray([ci]))
                    d_list.append(d)
                    p_list.append(p)
                dirty_c = jnp.asarray(np.stack(d_list), rdt)
                psf_c = jnp.asarray(np.stack(p_list), rdt)
                nu_ref = float(reffreq) if reffreq else float(run.freq)
                dirty_t, psf_m = imaging.taylor_stacks(
                    dirty_c, psf_c, jnp.asarray(freqs, rdt), nu_ref,
                    nterms=nterms)
                # batched pulls throughout (one device_get tree, not
                # one sync per array)
                d0, psf0_np = jax.device_get((dirty_t[0], psf_m[0]))
                outside = d0[mask == 0]
                rms = float(np.std(outside)) if outside.size else 0.0
                mdl_t, res_t, its = imaging.mtmfs_clean(
                    dirty_t, psf_m, jnp.asarray(mask, rdt), gain=0.1,
                    niter=niter, threshold=nsigma * rms)
                beam = imaging.fit_psf_beam(psf0_np, cell_rad)
                beam_kernel = imaging.gaussian_beam_kernel(
                    imsize, cell_rad, beam[0], beam[1], beam[2])
                tt_dev = [imaging.restore(
                    mdl_t[t], res_t[t], beam_kernel.astype(rdt))
                    for t in range(nterms)]
                tt, res01, mdl0_np = jax.device_get(
                    (tt_dev, [res_t[0], res_t[1]], mdl_t[0]))
                # in-band spectral index where tt0 is solid (5 sigma)
                lim = 5.0 * rms
                solid = tt[0] > lim
                safe0 = np.where(solid, tt[0], 1.0)
                alpha_map = np.where(solid, tt[1] / safe0, np.nan)
                # alpha error (tclean's .alpha.error): first-order
                # propagation of the per-plane residual rms through
                # alpha = I1/I0 (covariance term dropped — conservative
                # for anticorrelated Taylor residuals)
                sig = [float(np.std(res01[t][mask == 0]))
                       if outside.size else 0.0 for t in range(2)]
                alpha_err = np.where(
                    solid,
                    np.sqrt(sig[1] ** 2 +
                            np.where(solid, alpha_map, 0.0) ** 2 *
                            sig[0] ** 2) / safe0,
                    np.nan)
                mtmfs_maps['tt1'] = tt[1]
                mtmfs_maps['alpha'] = alpha_map
                mtmfs_maps['alpha_error'] = alpha_err
                if save_products:
                    extra_maps.update(psf=psf0_np, dirty=d0,
                                      model=mdl0_np, residual=res01[0])
            return tt[0], mdl0_np, beam

        restored, mdl, beam = (mtmfs_image() if deconvolver == 'mtmfs'
                               else mfs_image(re_nn, im_nn))
        if selfcal:
            if not np.any(mdl):
                raise ValueError("selfcal needs a CLEAN component model "
                                 "to solve against (niter=0 produced an "
                                 "empty one)")
            ant1, ant2, t_index = calibration.vis_metadata(n_samp, _pairs)
            n_sol = 1
            if selfcal_solint_s:
                n_sol = int(np.clip(round(run.t_obs / selfcal_solint_s),
                                    1, n_samp))
            us = uvw[None, :, 0] / lam[:, None]
            vs = uvw[None, :, 1] / lam[:, None]
            # wide-field runs sample the DATA with w-stacking: the model
            # degrid must carry the same w phases (see model_vis)
            ws = (uvw[None, :, 2] / lam[:, None]).ravel() \
                if w_planes >= 1 else None
            dr_before = dynamic_range(restored)
            dr_rounds = []
            re_sc, im_sc = re_nn, im_nn
            # cumulative gain product across rounds (what applycal of a
            # single 'gain table' must divide out)
            g_tot = np.ones((n_sol, n_ant), complex)
            for rnd in range(int(selfcal_rounds)):
                # the CASA reduction ladder: phase-only rounds against
                # progressively better models, the requested mode last
                mode = (selfcal if rnd == selfcal_rounds - 1 else 'phase')
                with KernelTimer(f"synthobs: selfcal round {rnd + 1} "
                                 f"({mode}, {n_sol} solint)", log):
                    mdl_re, mdl_im = jax.device_get(calibration.model_vis(
                        jnp.asarray(mdl, rdt), cell_rad,
                        us.ravel(), vs.ravel(), w_wav=ws,
                        n_wplanes=w_planes))
                    mdl_re = mdl_re.reshape(n_chan, -1)
                    mdl_im = mdl_im.reshape(n_chan, -1)
                    g_sol_re, g_sol_im = calibration.solve_gains(
                        re_sc, im_sc, mdl_re, mdl_im, ant1, ant2,
                        t_index, n_ant=n_ant, n_t=n_samp, n_sol=n_sol,
                        mode=mode)
                    cv = calibration.correct_vis(
                        jnp.asarray(re_sc, rdt), jnp.asarray(im_sc, rdt),
                        g_sol_re, g_sol_im, ant1, ant2, t_index, n_samp)
                    re_sc, im_sc, g_sol_re, g_sol_im = jax.device_get(
                        (*cv, g_sol_re, g_sol_im))
                g_tot = g_tot * (g_sol_re + 1j * g_sol_im)
                restored, mdl, beam = mfs_image(
                    re_sc, im_sc, f', selfcal {rnd + 1}')
                dr_rounds.append(dynamic_range(restored))
            g_amp = np.hypot(np.asarray(g_sol_re), np.asarray(g_sol_im))
            g_phs = np.degrees(np.arctan2(np.asarray(g_sol_im),
                                          np.asarray(g_sol_re)))
            run.results['selfcal'] = {
                'mode': selfcal, 'n_sol': n_sol,
                'rounds': int(selfcal_rounds),
                'gain_amp_rms': float(np.std(g_amp)),
                'gain_phase_rms_deg': float(np.std(g_phs)),
                'dynamic_range_before': dr_before,
                'dynamic_range_rounds': dr_rounds,
                'dynamic_range_after': dr_rounds[-1]}
            if log:
                log.add_entry(
                    "INFO",
                    "selfcal ({}, {} round(s), {} solution interval(s)): "
                    "final-round gain rms amp={:.3f} phase={:.1f}deg; "
                    "image dynamic range {:.1f} -> {}".format(
                        selfcal, selfcal_rounds, n_sol,
                        float(np.std(g_amp)), float(np.std(g_phs)),
                        dr_before,
                        ' -> '.join(f'{d:.1f}' for d in dr_rounds)),
                    timestamp=False)
        restored_cube = restored[None]
    bmaj_rad, bmin_rad, bpa_deg = beam

    # --- products -------------------------------------------------------- #
    # (the clean/noisy visibility sets were written before imaging)
    dcy = run.rt_dcy
    if re_sc is not None:
        with KernelTimer("synthobs: selfcal npz write", log):
            selfcal_vis_file = os.path.join(
                synobs_dcy, f'SynObs.{base}.selfcal.vis.npz')
            with atomic_write(selfcal_vis_file) as f:
                np.savez(f, uvw=uvw, vis_re=re_sc,
                         vis_im=im_sc, freqs=freqs, sigma=sigma)
            gains_file = os.path.join(
                synobs_dcy, f'SynObs.{base}.selfcal.gains.npz')
            with atomic_write(gains_file) as f:
                np.savez(f, g_re=g_tot.real, g_im=g_tot.imag,
                         n_ant=n_ant, mode=str(selfcal),
                         t_obs=float(run.t_obs))

    fitsfile = os.path.join(dcy, f'SynObs.{base}.noisy.imaging.fits')
    out_hdr = fitsio.Header()
    out_hdr['OBJECT'] = model.params['target']['name']
    out_hdr['BUNIT'] = 'Jy/beam'
    out_hdr['CTYPE1'] = 'RA---TAN'
    out_hdr['CTYPE2'] = 'DEC--TAN'
    out_hdr['CRVAL1'] = ra_deg
    out_hdr['CRVAL2'] = dec_deg
    # the imager's zero-phase point is integer pixel imsize//2 (FFT DC
    # after fftshift), so CRPIX is that pixel 1-based — CASA's n/2+1
    # convention; n/2+0.5 claimed a centre half an image pixel away
    # (review r4)
    out_hdr['CRPIX1'] = imsize // 2 + 1
    out_hdr['CRPIX2'] = imsize // 2 + 1
    out_hdr['CDELT1'] = -cell_as / 3600.0
    out_hdr['CDELT2'] = cell_as / 3600.0
    out_hdr['BMAJ'] = np.degrees(bmaj_rad)
    out_hdr['BMIN'] = np.degrees(bmin_rad)
    out_hdr['BPA'] = bpa_deg
    if cube_mode:
        # spectral axis, as CASA exportfits writes for tclean cubes
        out_hdr['CTYPE3'] = 'FREQ'
        out_hdr['CRPIX3'] = 1.0
        out_hdr['CRVAL3'] = float(freqs[0])
        out_hdr['CDELT3'] = float(freqs[1] - freqs[0]) if len(freqs) > 1 \
            else float(run.chanwidth)
        out_hdr['CUNIT3'] = 'Hz'
    with KernelTimer("synthobs: image FITS write", log):
        fitsio.write_fits(
            fitsfile,
            restored_cube if cube_mode else restored_cube[0], out_hdr)

    products = {'ms_clean': clean_vis_file, 'ms_noisy': noisy_vis_file,
                'clean_image': fitsfile}
    products.update(uvfits_files)
    if re_sc is not None:
        products['ms_selfcal'] = selfcal_vis_file
        products['gains'] = gains_file

    if not cube_mode and mtmfs_maps:
        # mtmfs Taylor/spectral-index products (tclean writes .tt0/.tt1/
        # .alpha image sets; the restored image above is tt0)
        tt1_file = _product_path(fitsfile, '.tt1.fits')
        with KernelTimer("synthobs: tt1 FITS write", log):
            fitsio.write_fits(tt1_file, mtmfs_maps['tt1'], out_hdr)
        hdr_a = out_hdr.copy()
        hdr_a['BUNIT'] = ''     # the spectral index is dimensionless
        alpha_file = _product_path(fitsfile, '.alpha.fits')
        with KernelTimer("synthobs: alpha FITS write", log):
            fitsio.write_fits(alpha_file, mtmfs_maps['alpha'], hdr_a)
        alpha_err_file = _product_path(fitsfile, '.alpha.error.fits')
        with KernelTimer("synthobs: alpha.error FITS write", log):
            fitsio.write_fits(alpha_err_file, mtmfs_maps['alpha_error'],
                              hdr_a)
        products['clean_image_tt1'] = tt1_file
        products['alpha'] = alpha_file
        products['alpha_error'] = alpha_err_file

    if pbcor:
        # primary-beam-corrected image (tclean pbcor/pblimit): divide by
        # the same PB model the sampler applied, NaN below pblimit —
        # through the ONE shared implementation so sampling and pbcor
        # can never drift apart
        pb_freqs = freqs if cube_mode else np.asarray([run.freq])
        # channel-at-a-time: stacking all channels' PB planes plus the
        # where/divide temporaries peaks at several GB of host RAM for a
        # 1,000-channel cube, when one plane at a time costs a few MB
        pbc = np.empty_like(np.asarray(restored_cube))
        for k, f in enumerate(pb_freqs):
            pb_k = np.asarray(sampler.primary_beam(
                imsize, imsize, cell_rad, f, mean_dish,
                model=pb_model, blockage_m=pb_blockage_m))
            pbc[k] = np.where(pb_k >= pblimit,
                              restored_cube[k] / pb_k, np.nan)
        pbcor_file = _product_path(fitsfile, '.pbcor.fits')
        with KernelTimer("synthobs: pbcor FITS write", log):
            fitsio.write_fits(pbcor_file,
                              pbc if cube_mode else pbc[0], out_hdr)
        products['clean_image_pbcor'] = pbcor_file

    if save_products:
        # tclean's auxiliary images (the reference keeps CASA's .psf/
        # .residual/.model artefacts, README "Data products")
        bunits = {'psf': '', 'dirty': 'Jy/beam', 'model': 'Jy/pixel',
                  'residual': 'Jy/beam'}
        for name in save_products:
            arr = extra_maps.get(name)
            if arr is None:
                if log:
                    log.add_entry(
                        "WARNING",
                        f"save_products: '{name}' is not available from "
                        f"{'cube' if cube_mode else 'mfs'} imaging",
                        timestamp=False)
                continue
            hdr_p = out_hdr.copy()
            if cube_mode and arr.ndim == 2:
                # the common-beam psf plane is 2-D: strip the cube's
                # spectral-axis cards or the file advertises a FREQ axis
                # it does not have
                hdr_p._cards = [c for c in hdr_p._cards
                                if not c[0].endswith('3')]
            hdr_p['BUNIT'] = bunits.get(name, '')
            pfile = _product_path(fitsfile, f'.{name}.fits')
            with KernelTimer(f"synthobs: {name} FITS write", log):
                fitsio.write_fits(pfile, arr, hdr_p)
            products[name] = pfile

    # --- imfit (continuum only; classes.py:2690-2840) -------------------- #
    if run.obs_type == 'continuum':
        fm_data = sky[0]
        yy, xx = np.mgrid[0:ny_m, 0:nx_m]
        xx_as = (xx + 0.5 - nx_m / 2) * abs(float(hdr['CDELT1'])) * 3600.0
        yy_as = (yy + 0.5 - ny_m / 2) * abs(float(hdr['CDELT2'])) * 3600.0
        rr_as = np.sqrt(xx_as ** 2 + yy_as ** 2)
        peak_flux = float(np.nansum(
            np.where(rr_as < beam_min_as / 2.0, fm_data, 0.0)))

        # expected deconvolved jet dims from the tau = 1 surface
        # (classes.py:2720-2746) — scalar algebra
        mp = model.params
        r_0_au = mp['geometry']['r_0']
        mod_r_0_au = mp['geometry']['mod_r_0']
        w_0_au = mp['geometry']['w_0']
        tau_0 = float(mphys.tau_r_from_params(mp, run.freq, r_0_au))
        q_tau = mp['power_laws']['q_tau']
        eps = mp['geometry']['epsilon']
        dist_pc = mp['target']['dist']
        maj_au = (mod_r_0_au * tau_0 ** (-1.0 / q_tau) + r_0_au -
                  mod_r_0_au) * 2.0
        maj_as = np.arctan(maj_au * cnsts.AU /
                           (dist_pc * cnsts.PARSEC)) / cnsts.ARCSEC
        min_au = float(np.asarray(mgeom.w_r(
            jnp.asarray(maj_au / 2.0), w_0_au, mod_r_0_au, r_0_au, eps)))
        min_as = np.arctan(min_au * cnsts.AU /
                           (dist_pc * cnsts.PARSEC)) / cnsts.ARCSEC
        conv_maj = float(np.sqrt(maj_as ** 2 + beam_min_as ** 2))
        conv_min = float(np.sqrt(min_as ** 2 + beam_min_as ** 2))
        if conv_min > conv_maj:
            conv_maj, conv_min = conv_min, conv_maj

        est_file = _product_path(fitsfile, '.estimates')
        products['estimates'] = est_file
        with open(est_file, 'wt') as f:
            f.write('{:.6f}, {:.1f}, {:.1f}, {:.5f}arcsec, {:.5f}arcsec, '
                    '{:.2f}deg'.format(peak_flux, imsize / 2.0, imsize / 2.0,
                                       conv_maj, conv_min,
                                       mp['geometry']['pa']))

        beam_area_pix = (np.pi / (4 * np.log(2.0)) *
                         (bmaj_rad / cell_rad) * (bmin_rad / cell_rad))
        fit_t0 = time.perf_counter()
        fit = imfit_mod.fit_gaussian(
            restored_cube[0],
            estimates={'peak': max(peak_flux, 1e-12), 'x': imsize / 2.0,
                       'y': imsize / 2.0, 'maj_pix': conv_maj / cell_as,
                       'min_pix': conv_min / cell_as,
                       'pa_deg': mp['geometry']['pa']},
            beam_area_pix=beam_area_pix)
        record_stage("host source fit (imfit)",
                     time.perf_counter() - fit_t0)
        imfit_file = _product_path(fitsfile, '.imfit')
        if fit is not None:
            imfit_mod.write_imfit_summary(imfit_file, fit, cell_as,
                                          beam_area_pix)
            products['imfit'] = imfit_file
            run.results['imfit'] = {
                h: {'val': v['value'], 'unit': v['units']}
                for h, v in casa_imfit_file_to_dict(imfit_file).items()
                if h}
        else:
            run.results['imfit'] = None

    return products
