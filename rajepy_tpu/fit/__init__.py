"""Differentiable parameter inference — gradient fitting of jet models.

A beyond-reference capability unlocked by the functional JAX design: the
whole radiative-transfer forward model (``models.fields`` grid fill →
``ops.radtrans`` opacity/flux chain) is a pure, differentiable function
of the physical parameters, so observed SEDs, flux maps and light curves
can be fitted by exact-gradient optimisation.  The reference's
numpy-property + CASA-subprocess architecture (classes.py:465-1099,
casa/tasks.py) admits no derivatives — parameter estimation there means
hand-tuning or black-box search over minutes-long pipeline runs.

Entry points
------------
``fit_sed(jm, freqs, observed)``           — fit integrated fluxes [Jy]
``fit_map(jm, freq, observed_map)``        — fit a flux map [Jy/pixel]
``fit_light_curve(jm, times, freqs, obs)`` — fit ejection-burst params
                                             to a flux time series
``fit_rrl_spectrum(jm, line, freqs, obs)`` — fit an RRL line profile
                                             (widths → T/n_e, shifts → v)
``fit_joint(jm, components)``              — one theta against several
                                             observables at once

Free parameters are named by dotted params-dict paths (e.g.
``'properties.mlr_bj'``, ``'properties.T_0'``, ``'geometry.inc'``).
Derived quantities follow the same chain as ``JetModel.__init__``
(jetmodel.py:184-244) *inside the trace*: ``mod_r_0`` from
(opang, epsilon, w_0), ``q_n`` from (epsilon, q_v), ``n_0`` from
``mlr_bj`` (which is why density is fitted through the mass-loss rate,
matching the reference's n_0-always-derived rule, classes.py:234-242),
and the red/blue density ratio from ``mlr_rj/mlr_bj``.

Positive-definite parameters are optimised in log space; angles and
power-law indices in linear space.  Optimisation is optax.adam inside a
single jitted ``lax.scan`` — one compile, every step on device.  Every
driver accepts ``n_starts`` (vmapped multi-start chains, best final
loss wins) with an optional ``mesh`` to shard the starts axis across
devices.

Caveat — geometry parameters and the voxel mask: the jet silhouette is a
hard 8-corner threshold (fields.fill_factor_area), so the loss along
parameters that move the mask (``inc``, ``pa``, ``opang``, ``epsilon``)
is a staircase; the exact gradient captures only the smooth in-mask
dependence (jet-frame r/w values, power laws).  Fitting those reliably
needs multi-start or a coarse grid search over the mask-moving subset,
with gradients refining the smooth parameters at each node.  Density
(``mlr_bj``), temperature, ionisation and the ejection-burst parameters
are smooth and recover to optimiser precision (see tests/test_fit.py).
"""
from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
import optax

from ..models import fields as F
from ..models import grid as G
from ..ops import geometry as geom
from ..ops import physics as phys
from ..ops import radtrans as rt

YEAR = 31536000.0

#: transform per fittable path: 'log' (positive-definite) or 'linear'
SUPPORTED_FREE = {
    'properties.mlr_bj': 'log',
    'properties.mlr_rj': 'log',
    'properties.T_0': 'log',
    'properties.x_0': 'log',
    'properties.v_0': 'log',
    'power_laws.q_T': 'linear',
    'power_laws.q_x': 'linear',
    'power_laws.q_v': 'linear',
    'geometry.inc': 'linear',
    'geometry.pa': 'linear',
    'geometry.opang': 'linear',
    'geometry.epsilon': 'linear',
    'target.dist': 'log',
    # systemic LSR velocity [km/s, receding positive]: shifts RRL
    # profiles (fields.py:176); the continuum forwards are velocity-
    # independent, so its gradient is only nonzero through
    # build_rrl_forward
    'target.v_lsr': 'linear',
    # non-LTE departure coefficients (PSEUDO paths — not params-dict
    # entries; only the RRL forwards accept them, and param_dict skips
    # them).  Freeing these fits the G&S stimulated-emission
    # amplification directly: at radio frequencies the line amplitude
    # scales ~b_n1 beta with beta ~ (1 - b_n2/b_n1)/(h nu / k T), so a
    # profile constrains roughly ONE combination — free b_n2 with b_n1
    # pinned (or vice versa) unless another observable breaks the
    # degeneracy.
    'nonlte.b_n1': 'log',
    'nonlte.b_n2': 'log',
}

#: the pseudo-paths only the RRL forwards implement
_NONLTE_FREE = ('nonlte.b_n1', 'nonlte.b_n2')


def _split_nonlte(free):
    """(real_free, real_idx, nl_idx): the params-dict paths, their theta
    positions, and the {pseudo-path: theta position} map — the one
    splitting rule for the nonlte pseudo-parameters."""
    free = tuple(free)
    nl_idx = {p: i for i, p in enumerate(free) if p in _NONLTE_FREE}
    real_free = tuple(p for p in free if p not in _NONLTE_FREE)
    real_idx = [i for i, p in enumerate(free) if p not in _NONLTE_FREE]
    return real_free, real_idx, nl_idx


def _get(d: Dict, path: str):
    sec, key = path.split('.')
    return d[sec][key]


def _set(d: Dict, path: str, value):
    sec, key = path.split('.')
    d[sec] = dict(d[sec])
    d[sec][key] = value


def _check_free(free: Sequence[str], allow_nonlte: bool = False):
    for p in free:
        if p not in SUPPORTED_FREE:
            raise ValueError(
                f"unsupported free parameter {p!r}; supported: "
                f"{sorted(SUPPORTED_FREE)} (n_0/q_n are derived — free "
                f"'properties.mlr_bj' / 'geometry.epsilon' instead)")
        if p in _NONLTE_FREE and not allow_nonlte:
            raise ValueError(
                f"{p!r} is only meaningful in the RRL forwards "
                "(build_rrl_forward / fit_rrl_spectrum / fit_rrl_cube)")


def _encode(free, params):
    """params -> optimisation vector (log for positive params)."""
    out = []
    for p in free:
        v = float(_get(params, p))
        out.append(np.log(v) if SUPPORTED_FREE[p] == 'log' else v)
    return jnp.asarray(out, jnp.float64)


def _pad_to_multiple(arr, k: int):
    """Pad arr's leading axis up to a multiple of k by repeating the
    last row (harmless duplicate work; callers slice the pad off)."""
    pad = -arr.shape[0] % k
    if pad:
        arr = jnp.concatenate([arr, jnp.broadcast_to(
            arr[-1:], (pad,) + arr.shape[1:])])
    return arr


def _substitute(free, params, theta):
    """Return a params dict with traced values at the free paths and the
    JetModel derivation chain (jetmodel.py:184-244) re-run in-trace."""
    q = copy.copy(params)
    for i, p in enumerate(free):
        v = theta[i]
        if SUPPORTED_FREE[p] == 'log':
            v = jnp.exp(v)
        _set(q, p, v)
    g, pl, pr, t = (dict(q['geometry']), dict(q['power_laws']),
                    dict(q['properties']), q['target'])
    g['mod_r_0'] = geom.mod_r_0(g['opang'], g['epsilon'], g['w_0'])
    pl['q_n'] = phys.q_n(g['epsilon'], pl['q_v'])
    pl['q_tau'] = phys.q_tau(g['epsilon'], pl['q_x'], pl['q_n'], pl['q_T'])
    pr['n_0'] = phys.n_0_from_mlr(
        pr['mlr_bj'], pr['v_0'], g['w_0'], pr['mu'],
        pl['q^d_n'], pl['q^d_v'], t['R_1'], t['R_2'])
    q['geometry'], q['power_laws'], q['properties'] = g, pl, pr
    rb_frac = pr['mlr_rj'] / pr['mlr_bj']
    return q, rb_frac


def _gaunt_branch(params, free) -> bool:
    """Gaunt treatment for the fit forwards (classes.py:1388-1393: van
    Hoof iff q_T == 0).  When q_T itself is freed the branch cannot be
    frozen from the starting value (a fit from the q_T=0 default would
    keep the van Hoof form while the optimiser moves q_T, disagreeing
    with JetModel at the optimum) — and the reference's exact-zero switch
    is not differentiable, so a freed q_T always uses the smooth
    Reynolds-approx gaunt, matching JetModel._use_reynolds_gaunt at any
    fitted q_T != 0."""
    return (params['power_laws']['q_T'] != 0.0 or
            'power_laws.q_T' in list(free))


def _chi_scan(red, launch_time, t0, sigma, rel_amp, is_red):
    """Tracer-safe burst factor: the lax.scan of
    models.ejection.chi_field with the burst arrays supplied directly
    (so they may be traced — chi_field stacks them with numpy)."""
    def body(chi, burst):
        t0_i, sig_i, amp_i, red_i = burst
        gauss = amp_i * jnp.exp(-(launch_time - t0_i) ** 2 /
                                (2.0 * sig_i ** 2))
        return chi + jnp.where(red == red_i, gauss, 0.0), None
    chi, _ = lax.scan(body, jnp.ones_like(launch_time),
                      (t0, sigma, rel_amp, is_red))
    return chi


# --------------------------------------------------------------------------- #
# Forward models
# --------------------------------------------------------------------------- #
def build_flux_forward(jm, freqs, free: Sequence[str],
                       time: float = None, dtype=None):
    """``(forward, theta0)`` with ``forward(theta) -> (n_chan, nx, nz)``
    flux maps [Jy/pixel], differentiable in every freed parameter.

    Replays the public ``flux_ff`` chain (jetmodel.py:977-987) from
    first principles each call — grid fill (fields.compute_static_fields)
    through the factorised opacity (radtrans.tau_ff_maps) — instead of
    the epoch-factorised cached path, because the static caches bake the
    parameters in as constants.  ``time`` defaults to the model's current
    epoch; bursts are included whenever the model has any.
    """
    _check_free(free)
    params = copy.deepcopy(jm.params)
    t_model = float(jm.time if time is None else time)
    dt = jnp.float64 if dtype is None else dtype
    nx, ny, nz = jm.nx, jm.ny, jm.nz
    xx, yy, zz = G.grid_corner_coords(nx, ny, nz, params['grid']['c_size'])
    xx, yy, zz = (jnp.asarray(np.asarray(c), dt) for c in (xx, yy, zz))
    freqs = jnp.atleast_1d(jnp.asarray(freqs, dt))
    reyn = _gaunt_branch(params, free)
    has_bursts = jm._has_bursts
    csize = params['grid']['c_size']

    # burst shape parameters stay fixed here (free them via
    # fit_light_curve); only the steady-state rates they are relative to
    # may move, and chi is a ratio — so the static burst arrays are exact
    if has_bursts:
        burst = jm._burst_tuple()
        b_t0 = jnp.asarray([b[0] for b in burst], dt)
        b_sig = jnp.asarray([np.sqrt(1.0 / (2.0 * b[1])) for b in burst],
                            dt)
        b_amp = jnp.asarray([b[2] for b in burst], dt)
        b_red = jnp.asarray([b[3] for b in burst], jnp.bool_)

    def forward(theta):
        q, rb_frac = _substitute(free, params, jnp.asarray(theta, dt))
        f = F.compute_static_fields(q, xx, yy, zz, rb_frac,
                                    with_time=has_bursts)
        nd = f.nd
        if has_bursts:
            chi = _chi_scan(f.red, t_model - f.ts, b_t0, b_sig, b_amp,
                            b_red)
            nd = nd * chi
        n_es = nd * f.xi
        ds = rt.path_length_cm(f.ff, f.area, csize)
        taus = rt.tau_ff_maps(freqs, f.temp, n_es, ds, f.inside,
                              q['properties']['T_0'], reyn)
        tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)
        return rt.flux_ff_maps(freqs, taus, tbar, any_in, csize,
                               q['target']['dist'])

    return forward, _encode(free, params)


def build_sed_forward(jm, freqs, free: Sequence[str], time: float = None,
                      dtype=None):
    """``forward(theta) -> (n_chan,)`` integrated fluxes [Jy].

    ``dtype`` selects the compute precision of the forward (default
    float64 — the oracle-grade CPU path).  float32 runs the whole
    forward/backward at the accelerator's native precision for on-chip
    fitting of production grids; the optimisation vector stays float64 outside.
    """
    fwd, theta0 = build_flux_forward(jm, freqs, free, time, dtype)

    def forward(theta):
        return jnp.sum(fwd(theta), axis=(1, 2))

    return forward, theta0


# --------------------------------------------------------------------------- #
# Optimisation driver
# --------------------------------------------------------------------------- #
class FitResult(NamedTuple):
    """Outcome of a gradient fit."""
    values: Dict[str, float]     # fitted value per freed path
    theta: np.ndarray            # final optimisation vector
    loss: np.ndarray             # loss per step
    model: np.ndarray            # forward model at the fitted parameters
    #                              (a tuple of arrays for fit_joint)
    grad_norm: float             # |grad| at the final step
    notes: tuple = ()            # advisory strings (e.g. freed q_T ~ 0:
    #                              the fit used the smooth Reynolds gaunt
    #                              where JetModel would take van Hoof)

    def param_dict(self, params: Dict) -> Dict:
        """``params`` (deep-copied) with the fitted values substituted —
        ready for ``JetModel(...)`` (n_0 etc. re-derived there)."""
        out = copy.deepcopy(params)
        for p, v in self.values.items():
            sec, key = p.split('.')
            if sec == 'nonlte':   # pseudo path, not a params entry
                continue
            out[sec][key] = float(v)
        return out


def _run_fit(forward, theta0, free, loss_of_model, steps, learning_rate,
             optimizer, n_starts: int = 1, start_spread: float = 0.3,
             seed: int = 0, mesh=None):
    """Optimisation driver.  ``n_starts > 1`` runs that many optimiser
    chains vmapped in ONE compiled program — theta0 plus jittered copies
    (``start_spread`` sigma in the transformed log/linear space, so log
    parameters jitter multiplicatively) — and keeps the converged chain
    with the lowest final loss: the cheap insurance against secondary
    minima (and the staircase plateaus of mask-moving geometry).  With
    ``mesh``, the starts axis is sharded across its devices, so the
    multi-start fit runs device-parallel."""
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)

    def loss_fn(theta):
        return loss_of_model(forward(theta))

    def run(theta):
        state = opt.init(theta)

        def step(carry, _):
            th, st = carry
            val, grad = jax.value_and_grad(loss_fn)(th)
            updates, st = opt.update(grad, st, th)
            return (optax.apply_updates(th, updates), st), val

        (theta, _), hist = lax.scan(step, (theta, state), None,
                                    length=steps)
        return theta, hist, jnp.linalg.norm(jax.grad(loss_fn)(theta))

    if n_starts > 1:
        key = jax.random.PRNGKey(seed)
        jitter = start_spread * jax.random.normal(
            key, (n_starts - 1, theta0.shape[0]), theta0.dtype)
        th0s = jnp.concatenate([theta0[None], theta0[None] + jitter])
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            axis = mesh.axis_names[0]    # starts shard over the 1st axis
            th0s = _pad_to_multiple(th0s, mesh.shape[axis])
            th0s = jax.device_put(th0s, NamedSharding(mesh, P(axis)))
        thetas, hists, gnorms = jax.jit(jax.vmap(run))(th0s)
        finals = np.asarray(hists[:, -1])
        best = int(np.nanargmin(np.where(np.isfinite(finals), finals,
                                         np.inf)))
        theta, hist, gnorm = thetas[best], hists[best], gnorms[best]
    else:
        theta, hist, gnorm = jax.jit(run)(theta0)
    theta_np = np.asarray(theta)
    values = {}
    for i, p in enumerate(free):
        v = float(theta_np[i])
        values[p] = float(np.exp(v)) if SUPPORTED_FREE[p] == 'log' else v
    notes = []
    if abs(values.get('power_laws.q_T', 1.0)) < 1e-3:
        # _gaunt_branch: a freed q_T always fits with the smooth Reynolds
        # gaunt (the reference's exact-zero van Hoof switch is not
        # differentiable) — at q_T ~ 0 JetModel itself would take the
        # van Hoof branch, so the fitted model and a JetModel re-run at
        # these parameters disagree slightly
        notes.append(
            "freed q_T converged to ~0 ({:+.2e}): the fit forward used "
            "the smooth Reynolds gaunt, but JetModel at q_T == 0 takes "
            "the van Hoof table — re-evaluate with JetModel to check the "
            "difference matters".format(values['power_laws.q_T']))
    return FitResult(notes=tuple(notes), values=values, theta=theta_np,
                     loss=np.asarray(hist),
                     # jit the one post-fit model evaluation: eagerly it
                     # replays the whole RT chain op-by-op
                     model=jax.tree.map(np.asarray, jax.jit(forward)(theta)),
                     grad_norm=float(gnorm))


def laplace_uncertainties(forward, theta, observed, free: Sequence[str],
                          errors=None) -> Tuple[Dict[str, float],
                                                np.ndarray]:
    """Gauss-Newton 1-sigma uncertainties at a fit optimum.

    ``(sigmas, cov)`` where ``sigmas[path]`` is the 1-sigma uncertainty
    of the fitted *value* (delta method for log-space parameters) and
    ``cov`` the covariance in optimisation (theta) space.

    With ``errors`` the residuals are the absolute chi-squared ones; with
    ``errors=None`` they are log-flux residuals and the noise scale is
    estimated from the residual variance s^2 = RSS/(n-p) (the
    scipy.optimize.curve_fit ``absolute_sigma=False`` convention).
    Covariance is s^2 (J^T J)^-1 with the exact residual jacobian — the
    Laplace approximation a forward-only pipeline cannot evaluate.
    """
    obs = jnp.asarray(np.asarray(observed, float).ravel(), jnp.float64)
    theta = jnp.asarray(theta, jnp.float64)

    if errors is None:
        log_obs = jnp.log(obs)

        def resid(th):
            return jnp.log(jnp.ravel(forward(th))) - log_obs
    else:
        err = jnp.asarray(np.asarray(errors, float).ravel(), jnp.float64)

        def resid(th):
            return (jnp.ravel(forward(th)) - obs) / err

    return _gauss_newton_sigmas(resid, theta, free,
                                estimate_scale=errors is None)


def _gauss_newton_sigmas(resid, theta, free: Sequence[str],
                         estimate_scale: bool = True
                         ) -> Tuple[Dict[str, float], np.ndarray]:
    """Gauss-Newton ``(sigmas, cov)`` from an arbitrary residual
    function ``resid(theta) -> 1-D residuals``.  With
    ``estimate_scale`` the noise scale is s^2 = RSS/(n - p)
    (curve_fit's ``absolute_sigma=False``); otherwise the residuals are
    assumed already whitened."""
    theta = jnp.asarray(theta, jnp.float64)
    J = np.asarray(jax.jacobian(resid)(theta))          # (n, p)
    r = np.asarray(resid(theta))
    n, p = J.shape
    jtj = J.T @ J
    cov = np.linalg.pinv(jtj)
    if estimate_scale:
        cov = cov * (float(r @ r) / max(n - p, 1))
    sigmas = {}
    for i, path in enumerate(free):
        s_theta = float(np.sqrt(max(cov[i, i], 0.0)))
        if SUPPORTED_FREE[path] == 'log':
            value = float(np.exp(theta[i]))
            sigmas[path] = value * s_theta              # delta method
        else:
            sigmas[path] = s_theta
    return sigmas, cov


def _power_norm_loss(observed, errors):
    """Least squares normalised by the observed power (for observables
    that pass through zero — line profiles, maps — where the SED's
    log-space loss does not apply), or per-point chi-squared with
    ``errors``."""
    obs = jnp.asarray(np.asarray(observed, float), jnp.float64)
    if errors is None:
        norm = jnp.sum(obs ** 2)

        def loss(model):
            return jnp.sum((model - obs) ** 2) / norm
    else:
        err = jnp.asarray(np.asarray(errors, float), jnp.float64)

        def loss(model):
            return jnp.mean(((model - obs) / err) ** 2)
    return loss


def _sed_loss(observed, errors):
    observed = jnp.asarray(observed, jnp.float64)
    if errors is None:
        log_obs = jnp.log(observed)

        def loss(model):
            return jnp.mean((jnp.log(model) - log_obs) ** 2)
    else:
        err = jnp.asarray(errors, jnp.float64)

        def loss(model):
            return jnp.mean(((model - observed) / err) ** 2)
    return loss


def fit_sed(jm, freqs, observed, *, errors=None,
            free: Sequence[str] = ('properties.mlr_bj', 'properties.T_0'),
            steps: int = 400, learning_rate: float = 0.05, time=None,
            optimizer=None, n_starts: int = 1,
            start_spread: float = 0.3, seed: int = 0,
            mesh=None) -> FitResult:
    """Fit freed parameters to an observed SED (fluxes [Jy] at ``freqs``).

    With ``errors=None`` the loss is least-squares in log flux (radio
    SEDs span decades; relative residuals weight every channel equally);
    with per-channel ``errors`` it is the standard chi-squared.
    """
    forward, theta0 = build_sed_forward(jm, freqs, free, time)
    return _run_fit(forward, theta0, free, _sed_loss(observed, errors),
                    steps, learning_rate, optimizer, n_starts,
                    start_spread, seed, mesh)


def fit_map(jm, freq, observed_map, *, errors=None,
            free: Sequence[str] = ('properties.mlr_bj', 'properties.T_0'),
            steps: int = 400, learning_rate: float = 0.05, time=None,
            optimizer=None, n_starts: int = 1,
            start_spread: float = 0.3, seed: int = 0,
            mesh=None) -> FitResult:
    """Fit freed parameters to an observed flux map [Jy/pixel] at one
    frequency (image-plane fitting — morphology constrains geometry
    parameters an SED cannot)."""
    fwd, theta0 = build_flux_forward(jm, jnp.atleast_1d(freq), free, time)
    base = _power_norm_loss(observed_map, errors)

    def loss(model):
        return base(model[0])

    def forward(theta):
        return fwd(theta)

    return _run_fit(forward, theta0, free, loss, steps, learning_rate,
                    optimizer, n_starts, start_spread, seed, mesh)


class PosteriorResult(NamedTuple):
    """MCMC posterior samples over the freed parameters."""
    samples: Dict[str, np.ndarray]   # per-path samples in VALUE space
    theta_samples: np.ndarray        # (n_chains, n_kept, p) in opt space
    acceptance: float                # MH acceptance fraction
    r_hat: Dict[str, float]         # split-R-hat convergence per path


def _split_r_hat(chains_2d: np.ndarray) -> float:
    """Gelman split-R-hat for one parameter: (n_chains, n_samples)."""
    m, n = chains_2d.shape
    half = n // 2
    split = chains_2d[:, :2 * half].reshape(2 * m, half)
    means = split.mean(axis=1)
    b = half * means.var(ddof=1)
    w = split.var(axis=1, ddof=1).mean()
    if w <= 0:
        return 1.0
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def sample_posterior(forward, theta0, observed, free: Sequence[str], *,
                     errors=None, cov=None, steps: int = 3000,
                     burn: int = 500, step_scale: float = 0.6,
                     seed: int = 0, chains: int = 2) -> PosteriorResult:
    """Posterior sampling by preconditioned MALA (Metropolis-adjusted
    Langevin) with exact gradients — full posteriors where
    :func:`laplace_uncertainties` gives only the Gaussian approximation.

    The target is the Gaussian likelihood of the fit residuals with flat
    priors in the transformed (log/linear) parameter space; with
    ``errors=None`` the log-flux noise scale is estimated once at
    ``theta0`` (s^2 = RSS/(n-p), as in :func:`laplace_uncertainties`) and
    held fixed.  ``cov`` (e.g. the Laplace covariance) preconditions the
    proposal; pass the output of a converged fit's
    ``laplace_uncertainties`` for unit-free steps.  ``step_scale`` ~0.5-1
    targets the MALA-optimal ~0.57 acceptance in low dimensions.

    ``chains`` independent chains run vmapped (device-parallel on a
    mesh) from 2-sigma over-dispersed starts; ``r_hat`` reports the
    Gelman split-R-hat per parameter (converged chains sit below ~1.01).
    """
    obs = jnp.asarray(np.asarray(observed, float).ravel(), jnp.float64)
    theta0 = jnp.asarray(theta0, jnp.float64)
    p = theta0.shape[0]

    if errors is None:
        log_obs = jnp.log(obs)

        def resid(th):
            return jnp.log(jnp.ravel(forward(th))) - log_obs
        r0 = resid(theta0)
        s2 = float(r0 @ r0) / max(obs.size - p, 1)
    else:
        err = jnp.asarray(np.asarray(errors, float).ravel(), jnp.float64)

        def resid(th):
            return (jnp.ravel(forward(th)) - obs) / err
        s2 = 1.0

    def nll(th):
        r = resid(th)
        return 0.5 * (r @ r) / s2

    if cov is None:
        cov = np.eye(p)
    # proposal scale: eps^2 C preconditioner, d^(-1/3) MALA dimension rule
    chol = np.linalg.cholesky(cov + 1e-30 * np.eye(p))
    eps = step_scale * p ** (-1.0 / 3.0)
    chol_j = jnp.asarray(chol)
    cov_j = jnp.asarray(np.asarray(cov, float))
    grad_nll = jax.grad(nll)

    def drift(th):
        return th - 0.5 * eps ** 2 * (cov_j @ grad_nll(th))

    def log_q(a, b):
        # log q(a | b): Gaussian with mean drift(b), covariance eps^2 C
        d = a - drift(b)
        sol = jax.scipy.linalg.cho_solve((chol_j, True), d)
        return -0.5 * (d @ sol) / eps ** 2

    def run(key, th0):
        def step(carry, k):
            th, e_th = carry
            k1, k2 = jax.random.split(k)
            prop = drift(th) + eps * (chol_j @
                                      jax.random.normal(k1, (p,)))
            e_prop = nll(prop)
            log_alpha = (e_th - e_prop + log_q(th, prop) -
                         log_q(prop, th))
            accept = jnp.log(jax.random.uniform(k2)) < log_alpha
            th = jnp.where(accept, prop, th)
            e_th = jnp.where(accept, e_prop, e_th)
            return (th, e_th), (th, accept)

        keys = jax.random.split(key, steps)
        (_, _), (chain, acc) = lax.scan(step, (th0, nll(th0)), keys)
        return chain, acc

    # over-dispersed starts: ~2-sigma preconditioned jitter per chain,
    # so split-R-hat actually tests convergence to the common target
    root = jax.random.PRNGKey(seed)
    k_init, k_run = jax.random.split(root)
    jitter = 2.0 * jax.random.normal(k_init, (chains, p)) @ chol_j.T
    th0s = theta0[None, :] + jitter
    chain_keys = jax.random.split(k_run, chains)
    chain, acc = jax.jit(jax.vmap(run))(chain_keys, th0s)
    kept = np.asarray(chain)[:, burn:, :]            # (chains, n, p)
    r_hat = {path: _split_r_hat(kept[:, :, i])
             for i, path in enumerate(free)}
    flat = kept.reshape(-1, p)
    samples = {}
    for i, path in enumerate(free):
        col = flat[:, i]
        samples[path] = np.exp(col) if SUPPORTED_FREE[path] == 'log' \
            else col
    return PosteriorResult(samples=samples, theta_samples=kept,
                           acceptance=float(np.mean(np.asarray(acc))),
                           r_hat=r_hat)


class GridFitResult(NamedTuple):
    """Outcome of a coarse-grid + gradient-refine fit."""
    node: Dict[str, float]       # winning grid-node values per path
    best: 'FitResult'            # gradient fit at the winning node
    table: list                  # [(node_dict, final_loss)] per node


def fit_grid_refine(jm, freqs, observed, *, grid: Dict[str, Sequence],
                    errors=None,
                    free: Sequence[str] = ('properties.mlr_bj',
                                           'properties.T_0'),
                    steps: int = 200, learning_rate: float = 0.05,
                    time=None) -> GridFitResult:
    """Coarse grid over mask-moving geometry parameters + gradient
    refinement of the smooth ones at every node.

    The jet silhouette is a hard voxel threshold, so the loss along
    ``inc``/``pa``/``opang``/``epsilon`` is a staircase that defeats
    pure gradient descent (module docstring).  This is the recommended
    recipe: enumerate candidate values for those (``grid``, cartesian
    product), run a short ``fit_sed`` of the smooth ``free`` parameters
    at each node, and keep the node with the lowest converged loss.
    """
    import itertools
    from ..models.jetmodel import JetModel as _JetModel
    _check_free(list(grid))
    t_model = jm.time if time is None else time
    paths = list(grid)
    table = []
    best = None
    for combo in itertools.product(*(grid[p] for p in paths)):
        node = dict(zip(paths, (float(v) for v in combo)))
        q = copy.deepcopy(jm.params)
        for p, v in node.items():
            sec, key = p.split('.')
            q[sec][key] = v
        jm_node = _JetModel(q, dtype=jnp.float64)
        jm_node.time = t_model
        res = fit_sed(jm_node, freqs, observed, errors=errors, free=free,
                      steps=steps, learning_rate=learning_rate)
        table.append((node, float(res.loss[-1])))
        if best is None or table[-1][1] < best[1]:
            best = (node, table[-1][1], res)
    return GridFitResult(node=best[0], best=best[2], table=table)


# --------------------------------------------------------------------------- #
# Visibility-space fitting
# --------------------------------------------------------------------------- #
def build_vis_forward(jm, freqs, uvw_m, free: Sequence[str],
                      time: float = None, apply_pb: bool = False,
                      dish_diameter_m: float = 25.0,
                      w_planes: int = 0):
    """``(forward, theta0)`` with ``forward(theta) -> (n_chan, n_vis)``
    complex visibilities [Jy] at baseline coordinates ``uvw_m`` [m].

    The interferometric forward model: the differentiable flux maps are
    transposed into the sky frame ((dec, ra) — the save_fits
    orientation, jetmodel.py:1394) and Fourier-sampled by
    ``synthobs.sampler.sample_vis_cube`` (taper-corrected FFT +
    Kaiser-Bessel degrid, per channel at its own wavelength, optional
    primary beam).  Every step — FFT, degrid, beam — is differentiable, so model parameters can be
    fitted *directly to visibilities*, skipping imaging (and its
    non-differentiable CLEAN) entirely: the standard uv-plane
    model-fitting workflow (cf. galario), with exact gradients through
    the full jet physics.  ``w_planes >= 1`` routes through the
    w-stacked sampler (also differentiable) for wide-field/long-baseline
    data — pick the count with ``synthobs.sampler.n_wplanes_for``.
    CPU/f64 path (complex host arrays).
    """
    if 'target.dist' in free:
        raise ValueError(
            "'target.dist' cannot be freed in visibility space: the "
            "pixel scale is baked into the uv sampling grid (fit it "
            "against SEDs/maps instead)")
    from ..synthobs import sampler as _sampler
    from .. import constants as cnsts
    flux_fwd, theta0 = build_flux_forward(jm, freqs, free, time)
    params = jm.params
    cell_rad = float(np.arctan(params['grid']['c_size'] * cnsts.AU /
                               (params['target']['dist'] * cnsts.PARSEC)))
    uvw = jnp.asarray(np.asarray(uvw_m, float), jnp.float64)
    freqs_arr = jnp.atleast_1d(jnp.asarray(freqs, jnp.float64))

    def forward(theta):
        maps = flux_fwd(theta)                      # (n_chan, nx, nz)
        sky = jnp.transpose(maps, (0, 2, 1))        # (n_chan, dec, ra)
        return _sampler.sample_vis_cube(
            sky, cell_rad, uvw, freqs_arr, apply_pb=apply_pb,
            dish_diameter_m=dish_diameter_m, w_planes=w_planes,
            centre='fits')

    return forward, theta0


def fit_visibilities(jm, freqs, uvw_m, vis_obs, *, sigma=None,
                     free: Sequence[str] = ('properties.mlr_bj',
                                            'properties.T_0'),
                     steps: int = 400, learning_rate: float = 0.05,
                     time=None, apply_pb: bool = False,
                     dish_diameter_m: float = 25.0, w_planes: int = 0,
                     optimizer=None, n_starts: int = 1,
                     start_spread: float = 0.3, seed: int = 0,
                     mesh=None) -> FitResult:
    """Fit freed parameters directly to observed complex visibilities
    (n_chan, n_vis) — no imaging in the loop.

    ``sigma`` is the per-visibility thermal noise [Jy] (scalar or
    broadcastable); the loss is the radio-interferometric chi-squared
    sum(|V_model - V_obs|^2 / sigma^2) (unit weights when omitted).
    """
    forward, theta0 = build_vis_forward(jm, freqs, uvw_m, free, time,
                                        apply_pb, dish_diameter_m,
                                        w_planes)
    obs = jnp.asarray(np.asarray(vis_obs, complex), jnp.complex128)
    w = 1.0 if sigma is None else 1.0 / jnp.asarray(sigma,
                                                    jnp.float64) ** 2

    def loss(model):
        r = model - obs
        return jnp.mean((r.real ** 2 + r.imag ** 2) * w)

    return _run_fit(forward, theta0, free, loss, steps, learning_rate,
                    optimizer, n_starts, start_spread, seed, mesh)


def fit_uvfits(jm, uvfits_file: str, **kwargs) -> FitResult:
    """Fit freed parameters to the visibilities in a UVFITS file.

    The uv-plane analogue of fitting to a CASA measurement set: any
    random-groups UVFITS (this framework's ``export_uvfits`` products,
    or real observed data exported by CASA/AIPS) is read by
    :func:`rajepy_tpu.synthobs.uvfits.read_uvfits` and handed to
    :func:`fit_visibilities` with the file's (u, v, w), channel
    frequencies and weights (sigma = 1/sqrt(weight); weights <= 0 are
    the UVFITS flagging convention and those visibilities are excluded
    from the chi-squared).  All :func:`fit_visibilities` keyword
    arguments pass through; an explicit ``sigma`` overrides the file
    weights.

    Data-convention contract: visibilities are assumed to follow the
    AIPS/memo-117 phase sign (V = ∫ I e^{-2πi(ul+vm+w(n-1))}, the
    convention ``write_uvfits`` produces and CASA/AIPS exports use).
    A conjugated (or otherwise mismatched) file does not fail silently:
    with correct per-file weights the converged ``FitResult.loss`` sits
    at the reduced-chi-squared floor (≈1–3); a final loss far above
    that signals a convention mismatch
    (tests/test_uvfits_adversarial.py::TestFitUVFITSFailureModes).
    """
    from ..synthobs.uvfits import read_uvfits
    d = read_uvfits(uvfits_file)
    vis = d['vis_re'] + 1j * d['vis_im']
    if kwargs.get('sigma') is None:
        w = d['weights']
        # zero weight -> zero chi-squared contribution (1/sigma^2 = 0)
        kwargs['sigma'] = np.where(
            w > 0, 1.0 / np.sqrt(np.where(w > 0, w, 1.0)), np.inf)
    return fit_visibilities(jm, d['freqs'], d['uvw'], vis, **kwargs)


def fit_closures(jm, freqs, uvw_m, vis_obs, *, n_ant: int, n_t: int,
                 free: Sequence[str] = ('properties.mlr_bj',),
                 use_phases: bool = True, use_log_amps: bool = True,
                 phase_weight: float = 1.0, amp_weight: float = 1.0,
                 steps: int = 400, learning_rate: float = 0.05,
                 time=None, apply_pb: bool = False,
                 dish_diameter_m: float = 25.0, w_planes: int = 0,
                 optimizer=None, n_starts: int = 1,
                 start_spread: float = 0.3, seed: int = 0,
                 mesh=None) -> FitResult:
    """Gain-robust uv-plane fitting: fit freed parameters to the
    CLOSURE observables of observed visibilities — closure phases
    (bispectrum phases over antenna triangles) and log closure
    amplitudes (quadrangle ratios) — which are exactly immune to
    antenna-based complex gain corruption
    (:mod:`rajepy_tpu.synthobs.calibration`).  This is the VLBI
    workflow for data whose gains cannot be calibrated: where
    :func:`fit_visibilities` on uncalibrated data converges to a biased
    optimum, the closure fit sees the true source structure.

    ``vis_obs``: (n_chan, n_t * n_bl) complex in
    :func:`simulate_observation`'s time-major full-antenna-pair layout
    (``n_bl = n_ant (n_ant - 1) / 2``), with ``uvw_m`` rows in the same
    order.  The closure-phase residual is the wrap-free
    ``1 - cos(phi_model - phi_data)`` via unit bispectrum phasors; the
    amplitude residual is least-squares in log space.  Closure
    quantities carry no absolute flux or position information — with
    structure-only constraints, combine with an SED component through
    :func:`fit_joint` to pin the flux scale when more than shape
    parameters are free.
    """
    forward, theta0 = build_vis_forward(jm, freqs, uvw_m, free, time,
                                        apply_pb, dish_diameter_m,
                                        w_planes)
    loss = _closure_loss(vis_obs, n_ant, n_t, use_phases, use_log_amps,
                         phase_weight, amp_weight)
    return _run_fit(forward, theta0, free, loss, steps, learning_rate,
                    optimizer, n_starts, start_spread, seed, mesh)


def closure_uncertainties(jm, freqs, uvw_m, vis_obs, theta,
                          free: Sequence[str], *, n_ant: int, n_t: int,
                          use_phases: bool = True,
                          use_log_amps: bool = True, time=None,
                          apply_pb: bool = False,
                          dish_diameter_m: float = 25.0,
                          w_planes: int = 0
                          ) -> Tuple[Dict[str, float], np.ndarray]:
    """Gauss-Newton 1-sigma uncertainties at a :func:`fit_closures`
    optimum (``theta`` from ``FitResult.theta``).

    Residuals are the wrap-free closure-phase differences via
    unit-bispectrum cross products (Im(B̂_m conj(B̂_d)) ≈ φ_m − φ_d near
    the optimum) and the log-closure-amplitude differences.  The two
    observable families carry different noise scales, so each block is
    whitened by its own residual RMS before the joint jacobian — the
    block-wise ``absolute_sigma=False`` convention.  Returns
    ``(sigmas, cov)`` like :func:`laplace_uncertainties`.
    """
    if not (use_phases or use_log_amps):
        raise ValueError("enable at least one of use_phases / "
                         "use_log_amps")
    if use_log_amps and n_ant < 4:
        raise ValueError("log closure amplitudes need n_ant >= 4 "
                         f"(got {n_ant}); use use_log_amps=False")
    if use_phases and n_ant < 3:
        raise ValueError(f"closure phases need n_ant >= 3 (got {n_ant})")
    forward, _ = build_vis_forward(jm, freqs, uvw_m, free, time,
                                   apply_pb, dish_diameter_m, w_planes)
    bisp, logclamp = _closure_ops(n_ant)
    v_d = _closure_data(vis_obs, n_ant, n_t)
    eps = 1e-30
    b_d = bisp(v_d)
    bd_u = b_d / (jnp.abs(b_d) + eps)
    la_d = logclamp(v_d)

    def blocks(th):
        v_m = forward(th).reshape(v_d.shape)
        out = []
        if use_phases:
            b_m = bisp(v_m)
            bm_u = b_m / (jnp.abs(b_m) + eps)
            out.append(jnp.ravel((bm_u * jnp.conj(bd_u)).imag))
        if use_log_amps:
            out.append(jnp.ravel(logclamp(v_m) - la_d))
        return out

    theta = jnp.asarray(theta, jnp.float64)
    # floor the whitening scale well above underflow: exactly-zero
    # residual blocks (noiseless data at the optimum) would otherwise
    # blow the jacobian up to inf and NaN the covariance — 1e-12 keeps
    # J^T J finite in f64 and still reports ~zero sigma for such data
    scales = [max(float(jnp.sqrt(jnp.mean(b ** 2))), 1e-12)
              for b in blocks(theta)]

    def resid(th):
        return jnp.concatenate([b / s
                                for b, s in zip(blocks(th), scales)])

    return _gauss_newton_sigmas(resid, theta, free, estimate_scale=False)


def _closure_ops(n_ant: int):
    """``(bisp, logclamp)`` operating on complex (..., n_t, n_bl)
    visibility arrays over the full triangle / quadrangle sets — thin
    bindings of the shared cores in :mod:`..synthobs.calibration` so
    the closure definitions exist exactly once."""
    from ..synthobs import calibration as _cal
    idx = _cal.closure_index_arrays(n_ant)
    return (lambda v: _cal.bisp_core(v, *idx['tri']),
            lambda v: _cal.logclamp_core(v, *idx['quad']))


def _closure_data(vis_obs, n_ant: int, n_t: int):
    """Validate the layout and return the observed visibilities as a
    complex (n_chan, n_t, n_bl) device array."""
    obs = np.asarray(vis_obs, complex)
    if obs.ndim == 1:
        obs = obs[None]
    n_bl = n_ant * (n_ant - 1) // 2
    if obs.shape[-1] != n_t * n_bl:
        raise ValueError(
            f"vis_obs last axis {obs.shape[-1]} != n_t*n_bl "
            f"({n_t}x{n_bl}) — closure indexing needs the full "
            "time-major antenna-pair layout")
    return jnp.asarray(obs.reshape(obs.shape[0], n_t, n_bl),
                       jnp.complex128)


def _closure_loss(vis_obs, n_ant: int, n_t: int, use_phases: bool = True,
                  use_log_amps: bool = True, phase_weight: float = 1.0,
                  amp_weight: float = 1.0):
    """``loss(model_vis)`` against the closure observables of
    ``vis_obs`` (see :func:`fit_closures` for the residual forms)."""
    if not (use_phases or use_log_amps):
        raise ValueError("enable at least one of use_phases / "
                         "use_log_amps")
    if use_log_amps and n_ant < 4:
        raise ValueError("log closure amplitudes need n_ant >= 4 "
                         f"(got {n_ant}); use use_log_amps=False")
    if use_phases and n_ant < 3:
        raise ValueError(f"closure phases need n_ant >= 3 (got {n_ant})")
    bisp, logclamp = _closure_ops(n_ant)
    eps = 1e-30
    v_d = _closure_data(vis_obs, n_ant, n_t)
    b_d = bisp(v_d)
    bd_unit_conj = jnp.conj(b_d) / (jnp.abs(b_d) + eps)
    la_d = logclamp(v_d)

    def loss(model):
        v_m = model.reshape(v_d.shape)
        total = 0.0
        if use_phases:
            b_m = bisp(v_m)
            total += phase_weight * jnp.mean(
                1.0 - (b_m * bd_unit_conj).real / (jnp.abs(b_m) + eps))
        if use_log_amps:
            total += amp_weight * jnp.mean((logclamp(v_m) - la_d) ** 2)
        return total

    return loss


# --------------------------------------------------------------------------- #
# RRL line-profile fitting
# --------------------------------------------------------------------------- #
def build_rrl_forward(jm, line: str, freqs, free: Sequence[str],
                      time: float = None, dtype=None,
                      contsub: bool = True, remat: bool = True,
                      lte: bool = True, departure_coeffs=None):
    """``(forward, theta0)`` with ``forward(theta) -> (n_chan, nx, nz)``
    RRL flux maps [Jy/pixel], differentiable in every freed parameter.

    Replays the public ``flux_rrl`` chain (jetmodel.py:1251-1267) from
    first principles: grid fill → free-free opacity (the continuum
    attenuating the line) → Doppler-shifted rest frequency, thermal +
    Stark widths, Voigt profile, kappa_L (G&S 2.114, rrls.py:362-389) →
    LTE slab intensity → flux.  ``contsub=True`` (the ``flux_rrl``
    default) returns line-only fluxes; ``False`` adds the continuum.

    This is what makes *line-profile observables* fittable: the Doppler
    width constrains ``properties.T_0``, the Stark width and line
    opacity constrain ``properties.mlr_bj``/``x_0``, and the profile
    centroid/asymmetry constrains the velocity field
    (``target.v_lsr`` systemic shift, ``properties.v_0`` and
    ``power_laws.q_v`` through the jet's LOS velocity) — none of which
    an integrated continuum SED can separate.  The reference's
    forward-only pipeline (classes.py:1292-1351 + CASA) admits no such
    inversion.  ``dtype=float32`` runs the forward at the accelerator's
    native precision (the XLA ``lax.map`` channel loop over the full
    cube — the compacted-tile RRL path has no VJP).  ``remat`` (default on) checkpoints the per-channel
    opacity body so the backward pass recomputes it instead of storing
    grid-shaped residuals per channel — required above ~200³ on a 16 GB
    chip (the unremat VJP wants ~20 GB at 256³ x 17 channels); turn off
    for small grids if per-step speed matters more than memory.
    """
    free = tuple(free)
    _check_free(free, allow_nonlte=True)
    real_free, real_idx, nl_idx = _split_nonlte(free)
    nonlte = (not lte) or bool(nl_idx)
    if nonlte:
        # fixed values for whichever coefficients are NOT freed (and the
        # theta0 starting point for those that are): explicit pair, or
        # the case-B table at the jet's conditions
        if departure_coeffs is not None:
            # scalars OR per-sightline maps (JetModel.
            # departure_coefficient_maps) — maps broadcast through the
            # non-LTE composition like any other image-plane factor
            b1_fix, b2_fix = (np.asarray(departure_coeffs[0], float),
                              np.asarray(departure_coeffs[1], float))
            if b1_fix.ndim == 0:
                b1_fix = float(b1_fix)
            if b2_fix.ndim == 0:
                b2_fix = float(b2_fix)
            for pth, bv in (('nonlte.b_n1', b1_fix),
                            ('nonlte.b_n2', b2_fix)):
                if np.ndim(bv) and np.shape(bv) != (jm.nx, jm.nz):
                    # a mis-shaped array could broadcast silently into
                    # wrong physics against the (n_chan, nx, nz) maps
                    raise ValueError(
                        f"{pth} departure coefficient must be a scalar "
                        f"or an (nx, nz) = ({jm.nx}, {jm.nz}) sightline "
                        f"map (got shape {np.shape(bv)})")
                if pth in nl_idx and np.ndim(bv):
                    # the freed slot is a scalar theta entry; the OTHER
                    # coefficient may still be held fixed as a map
                    raise ValueError(
                        f"freeing {pth} fits a SCALAR coefficient; its "
                        "starting value in departure_coeffs must be a "
                        "scalar (a map is only valid for a coefficient "
                        "held fixed)")
        else:
            b1_fix, b2_fix = jm.departure_coefficients(line)
    params = copy.deepcopy(jm.params)
    t_model = float(jm.time if time is None else time)
    dt = jnp.float64 if dtype is None else dtype
    nx, ny, nz = jm.nx, jm.ny, jm.nz
    xx, yy, zz = G.grid_corner_coords(nx, ny, nz, params['grid']['c_size'])
    xx, yy, zz = (jnp.asarray(np.asarray(c), dt) for c in (xx, yy, zz))
    freqs = jnp.atleast_1d(jnp.asarray(freqs, dt))
    reyn = _gaunt_branch(params, free)
    has_bursts = jm._has_bursts
    csize = params['grid']['c_size']
    coeffs = rt.RRLCoeffs(line)

    if has_bursts:
        burst = jm._burst_tuple()
        b_t0 = jnp.asarray([b[0] for b in burst], dt)
        b_sig = jnp.asarray([np.sqrt(1.0 / (2.0 * b[1])) for b in burst],
                            dt)
        b_amp = jnp.asarray([b[2] for b in burst], dt)
        b_red = jnp.asarray([b[3] for b in burst], jnp.bool_)

    def forward(theta):
        theta = jnp.asarray(theta, dt)
        q, rb_frac = _substitute(real_free, params, theta[
            jnp.asarray(real_idx, jnp.int32)] if real_idx else theta[:0])
        f = F.compute_static_fields(q, xx, yy, zz, rb_frac,
                                    with_time=has_bursts)
        nd = f.nd
        if has_bursts:
            chi = _chi_scan(f.red, t_model - f.ts, b_t0, b_sig, b_amp,
                            b_red)
            nd = nd * chi
        n_es = nd * f.xi
        ds = rt.path_length_cm(f.ff, f.area, csize)
        tau_c = rt.tau_ff_maps(freqs, f.temp, n_es, ds, f.inside,
                               q['properties']['T_0'], reyn)
        tau_l = rt.tau_rrl_maps(coeffs, freqs, f.temp, n_es, f.vy, ds,
                                f.inside, remat=remat)
        tbar, any_in = rt.mean_temperature_map(f.temp, f.inside)
        if nonlte:
            b1 = (jnp.exp(theta[nl_idx['nonlte.b_n1']])
                  if 'nonlte.b_n1' in nl_idx
                  else jnp.asarray(b1_fix, dt))
            b2 = (jnp.exp(theta[nl_idx['nonlte.b_n2']])
                  if 'nonlte.b_n2' in nl_idx
                  else jnp.asarray(b2_fix, dt))
            ints = rt.intensity_rrl_maps_nonlte(freqs, tbar, tau_c,
                                                tau_l, any_in, b1, b2)
        else:
            ints = rt.intensity_rrl_maps(freqs, tbar, tau_c, tau_l,
                                         any_in)
        fl = ints * rt.flux_scale_jy(csize, q['target']['dist'])
        if not contsub:
            fl = fl + rt.flux_ff_maps(freqs, tau_c, tbar, any_in, csize,
                                      q['target']['dist'])
        return fl

    th0 = np.zeros(len(free))
    real_th0 = np.asarray(_encode(real_free, params))
    for k, i in enumerate(real_idx):
        th0[i] = real_th0[k]
    for pth, i in nl_idx.items():
        th0[i] = np.log(b1_fix if pth == 'nonlte.b_n1' else b2_fix)
    return forward, jnp.asarray(th0, jnp.float64)


def build_rrl_spectrum_forward(jm, line: str, freqs, free: Sequence[str],
                               time: float = None, dtype=None,
                               contsub: bool = True, lte: bool = True,
                               departure_coeffs=None):
    """``forward(theta) -> (n_chan,)`` spatially-integrated RRL spectrum
    [Jy] — the line profile a single-dish or unresolved-interferometric
    observation measures.  ``lte=False`` (or freeing the
    ``nonlte.b_n1``/``nonlte.b_n2`` pseudo-parameters) swaps in the G&S
    non-LTE composition, so observed stimulated amplification becomes a
    fittable quantity."""
    fwd, theta0 = build_rrl_forward(jm, line, freqs, free, time, dtype,
                                    contsub, lte=lte,
                                    departure_coeffs=departure_coeffs)

    def forward(theta):
        return jnp.sum(fwd(theta), axis=(1, 2))

    return forward, theta0


def fit_rrl_spectrum(jm, line: str, freqs, observed, *, errors=None,
                     free: Sequence[str] = ('properties.T_0',
                                            'target.v_lsr'),
                     steps: int = 400, learning_rate: float = 0.05,
                     time=None, contsub: bool = True,
                     optimizer=None, n_starts: int = 1,
                     start_spread: float = 0.3, seed: int = 0,
                     mesh=None, lte: bool = True,
                     departure_coeffs=None) -> FitResult:
    """Fit freed parameters to an observed RRL spectrum (integrated
    fluxes [Jy] at channel frequencies ``freqs`` spanning the line).

    The default frees recover the two classic line-profile observables:
    temperature from the Doppler width and systemic velocity from the
    centroid.  The loss is plain least squares normalised by the
    observed power (line fluxes pass through zero in the wings, so the
    SED's log-space loss does not apply); with ``errors`` it is the
    standard per-channel chi-squared.

    ``lte=False``, or freeing ``'nonlte.b_n1'``/``'nonlte.b_n2'``, fits
    through the G&S non-LTE composition (amplified/masing profiles);
    note the near-degeneracy documented at :data:`SUPPORTED_FREE` —
    free one coefficient at a time unless another observable pins the
    other.

    Accuracy contract for ``lte=False`` with TABLE-DERIVED coefficients
    (no explicit ``departure_coeffs``): the statistical sigmas from
    :func:`laplace_uncertainties` do NOT include the b_n table's
    collisional-rate systematic — add
    :func:`rrl_departure_systematic` in quadrature (it can dominate in
    the low-n_e regime where b_n is far from 1).
    """
    forward, theta0 = build_rrl_spectrum_forward(
        jm, line, freqs, free, time, contsub=contsub, lte=lte,
        departure_coeffs=departure_coeffs)
    return _run_fit(forward, theta0, free,
                    _power_norm_loss(observed, errors), steps,
                    learning_rate, optimizer, n_starts, start_spread,
                    seed, mesh)


def fit_rrl_cube(jm, line: str, freqs, observed_cube, *, errors=None,
                 free: Sequence[str] = ('properties.T_0',
                                        'properties.v_0'),
                 steps: int = 400, learning_rate: float = 0.05,
                 time=None, contsub: bool = True,
                 optimizer=None, n_starts: int = 1,
                 start_spread: float = 0.3, seed: int = 0,
                 mesh=None, lte: bool = True,
                 departure_coeffs=None) -> FitResult:
    """Fit freed parameters to a spatially-resolved RRL channel cube
    ``observed_cube`` of shape (n_chan, nx, nz) [Jy/pixel].

    Position-velocity structure is the observable here: the jet's LOS
    velocity field shifts the line differentially along the axis, so a
    resolved cube constrains the velocity law (``properties.v_0``,
    ``power_laws.q_v``) that a spatially-integrated spectrum — where
    red- and blue-shifted emission blend into one profile — cannot
    separate.  The kinematic inverse problem of the reference's
    forward-only channel maps (classes.py:1292-1351).  ``lte``/
    ``departure_coeffs``/``nonlte.*`` frees as in
    :func:`fit_rrl_spectrum`.
    """
    fwd, theta0 = build_rrl_forward(jm, line, freqs, free, time,
                                    contsub=contsub, lte=lte,
                                    departure_coeffs=departure_coeffs)
    return _run_fit(fwd, theta0, free,
                    _power_norm_loss(observed_cube, errors), steps,
                    learning_rate, optimizer, n_starts, start_spread,
                    seed, mesh)


def rrl_departure_systematic(jm, line: str, freqs, theta,
                             free: Sequence[str], *, cube: bool = False,
                             time=None, contsub: bool = True
                             ) -> Dict[str, float]:
    """Systematic uncertainties on a non-LTE RRL fit's freed parameters
    from the departure-coefficient table's collisional-rate error band.

    A ``fit_rrl_spectrum``/``fit_rrl_cube`` run with ``lte=False`` and
    TABLE-DERIVED coefficients inherits the table's rate-prescription
    systematic (ops.departure.b_n_systematic: the spread of the case-B
    solution under x0.5/x2 van-Regemorter/Thomson rate scaling — there
    is no digitised published b_n tabulation in this environment, so
    this bounds the dominant rate-tier error by construction).  This
    helper propagates it to first order: the forward is re-evaluated at
    the fit optimum ``theta`` with the COHERENT 'lo'/'hi' coefficient
    pairs (both levels at the same rate scale — their errors are
    correlated through the common rates), and the model shift is mapped
    to the parameter shift that would absorb it through the pseudo-
    inverse of the forward jacobian:

        dtheta = J^+ (forward_shifted - forward_central).

    Returns ``{path: systematic sigma}`` in VALUE space (delta method
    for log parameters, matching :func:`laplace_uncertainties`); add in
    quadrature to the statistical sigmas.  Irrelevant (zero) when the
    fit FREED the coefficients (data constrains them) or was given
    explicit measured ``departure_coeffs``.

    Do NOT assume it vanishes for dense (thermalised) jets: detailed
    balance pins each b to 1 at every rate scale (per-LEVEL systematic
    < 1e-3), but the G&S beta amplification feels the level DIFFERENCE
    divided by h nu / k T_e ~ 1e-4 — so the rate-scale spread of
    (b_n2 - b_n1) propagates to a few-percent T_0 systematic even at
    n_e ~ 1e7 cm^-3 (measured in
    tests/test_fit.py::test_departure_systematic_dense_jet).
    """
    free = tuple(free)
    for p in free:
        if p in _NONLTE_FREE:
            raise ValueError(
                f"{p} was a FREE parameter: the data constrained it and "
                "the table systematic does not apply — drop it from "
                "`free` here and propagate only the fixed-coefficient "
                "error")
    theta = jnp.asarray(np.asarray(theta, float), jnp.float64)
    builder = build_rrl_forward if cube else build_rrl_spectrum_forward
    b_c = jm.departure_coefficients(line)
    fwd_c, _ = builder(jm, line, freqs, free, time, contsub=contsub,
                       lte=False, departure_coeffs=b_c)

    def flat(th):
        return jnp.ravel(fwd_c(th))

    y0 = np.asarray(flat(theta))
    J = np.asarray(jax.jacobian(flat)(theta))
    dtheta_max = np.zeros(len(free))
    for which in ('lo', 'hi'):
        b_s = jm.departure_coefficients_at_scale(line, which)
        fwd_s, _ = builder(jm, line, freqs, free, time, contsub=contsub,
                           lte=False, departure_coeffs=b_s)
        dy = np.asarray(jnp.ravel(fwd_s(theta))) - y0
        dth, *_ = np.linalg.lstsq(J, dy, rcond=None)
        dtheta_max = np.maximum(dtheta_max, np.abs(dth))
    out = {}
    for i, path in enumerate(free):
        if SUPPORTED_FREE[path] == 'log':
            out[path] = float(np.exp(theta[i])) * float(dtheta_max[i])
        else:
            out[path] = float(dtheta_max[i])
    return out


# --------------------------------------------------------------------------- #
# Joint multi-observable fitting
# --------------------------------------------------------------------------- #
def _component_forward_loss(jm, comp: Dict, free, time, dtype):
    """(forward, weighted_loss, theta0) for one fit_joint component.

    ``nonlte.*`` pseudo-parameters only exist in the RRL forwards; for
    every other kind the component builds on the real-parameter subset
    and its forward ignores (zero-gradient) the nonlte theta entries —
    exactly right physically (departure coefficients do not touch the
    continuum), and exactly what lets a joint SED + non-LTE-profile fit
    break the b_n1/b_n2 single-profile degeneracy.  Such a component's
    theta0 carries NaN at the nonlte slots; fit_joint merges slot-wise.
    """
    kind = comp['kind']
    w = float(comp.get('weight', 1.0))
    errors = comp.get('errors')
    rrl_kinds = ('rrl_spectrum', 'rrl_cube')
    real_free, real_idx_l, nl_idx = _split_nonlte(free)
    if nl_idx and kind not in rrl_kinds:
        real_idx = jnp.asarray(real_idx_l, jnp.int32)
        fwd_r, loss_r, th0_r = _component_forward_loss(
            jm, comp, real_free, time, dtype)

        def fwd_full(theta, _f=fwd_r, _i=real_idx):
            return _f(jnp.asarray(theta)[_i])

        th0 = np.full(len(free), np.nan)
        th0[np.asarray(real_idx)] = np.asarray(th0_r)
        return fwd_full, loss_r, jnp.asarray(th0)
    if kind == 'sed':
        fwd, th0 = build_sed_forward(jm, comp['freqs'], free, time, dtype)
        base = _sed_loss(comp['observed'], errors)
    elif kind == 'map':
        fwd0, th0 = build_flux_forward(jm, jnp.atleast_1d(comp['freq']),
                                       free, time, dtype)

        def fwd(theta, _f=fwd0):
            return _f(theta)[0]

        base = _power_norm_loss(comp['observed'], errors)
    elif kind == 'rrl_spectrum':
        fwd, th0 = build_rrl_spectrum_forward(
            jm, comp['line'], comp['freqs'], free, time, dtype,
            comp.get('contsub', True), lte=comp.get('lte', True),
            departure_coeffs=comp.get('departure_coeffs'))
        base = _power_norm_loss(comp['observed'], errors)
    elif kind == 'rrl_cube':
        fwd, th0 = build_rrl_forward(
            jm, comp['line'], comp['freqs'], free, time, dtype,
            comp.get('contsub', True), lte=comp.get('lte', True),
            departure_coeffs=comp.get('departure_coeffs'))
        base = _power_norm_loss(comp['observed'], errors)
    elif kind == 'visibilities':
        fwd, th0 = build_vis_forward(
            jm, comp['freqs'], comp['uvw_m'], free, time,
            comp.get('apply_pb', False),
            comp.get('dish_diameter_m', 25.0),
            comp.get('w_planes', 0))
        obs = jnp.asarray(np.asarray(comp['observed'], complex),
                          jnp.complex128)
        sigma = comp.get('sigma')
        wt = 1.0 if sigma is None else 1.0 / jnp.asarray(
            sigma, jnp.float64) ** 2

        def base(model, _o=obs, _w=wt):
            r = model - _o
            return jnp.mean((r.real ** 2 + r.imag ** 2) * _w)
    elif kind == 'closures':
        # gain-robust structure constraint: closure observables of
        # uncalibrated visibilities (combine with an 'sed' component to
        # pin the absolute flux scale closures cannot see)
        fwd, th0 = build_vis_forward(
            jm, comp['freqs'], comp['uvw_m'], free, time,
            comp.get('apply_pb', False),
            comp.get('dish_diameter_m', 25.0),
            comp.get('w_planes', 0))
        base = _closure_loss(
            comp['observed'], comp['n_ant'], comp['n_t'],
            comp.get('use_phases', True), comp.get('use_log_amps', True),
            comp.get('phase_weight', 1.0), comp.get('amp_weight', 1.0))
    else:
        raise ValueError(
            f"unknown joint-fit component kind {kind!r}; supported: "
            "sed / map / rrl_spectrum / rrl_cube / visibilities / "
            "closures")

    def loss(model, _b=base, _w=w):
        return _w * _b(model)

    return fwd, loss, th0


def fit_joint(jm, components: Sequence[Dict], *,
              free: Sequence[str] = ('properties.mlr_bj',
                                     'properties.T_0'),
              steps: int = 400, learning_rate: float = 0.05, time=None,
              dtype=None, optimizer=None, n_starts: int = 1,
              start_spread: float = 0.3, seed: int = 0,
              mesh=None) -> FitResult:
    """Fit one parameter vector against SEVERAL observables at once —
    the total loss is the (weighted) sum of each component's native
    loss, and the exact gradient flows through all of them in one
    program.

    ``components`` is a sequence of dicts; each has a ``kind`` plus that
    kind's data (all accept ``errors``, ``weight`` and a per-component
    ``time`` [s] overriding the fit-level epoch — so observations of
    DIFFERENT epochs fit one parameter vector jointly, e.g. two maps
    bracketing an ejection recover the burst parameters that a single
    epoch cannot see):

    * ``{'kind': 'sed', 'freqs', 'observed'}`` — integrated fluxes [Jy]
    * ``{'kind': 'map', 'freq', 'observed'}`` — a flux map [Jy/pixel]
    * ``{'kind': 'rrl_spectrum', 'line', 'freqs', 'observed'
        [, 'contsub']}`` — an RRL line profile
    * ``{'kind': 'rrl_cube', 'line', 'freqs', 'observed'
        [, 'contsub']}`` — a resolved RRL channel cube
    * ``{'kind': 'visibilities', 'freqs', 'uvw_m', 'observed'
        [, 'sigma', 'apply_pb', 'dish_diameter_m', 'w_planes']}`` —
      complex visibilities (f64 path; see build_vis_forward;
      ``w_planes >= 1`` selects the w-stacked wide-field sampler)
    * ``{'kind': 'closures', 'freqs', 'uvw_m', 'observed', 'n_ant',
        'n_t' [, 'use_phases', 'use_log_amps', 'phase_weight',
        'amp_weight', 'apply_pb', 'dish_diameter_m', 'w_planes']}`` —
      gain-immune closure phases / log closure amplitudes of
      uncalibrated visibilities (combine with an 'sed' component to pin
      the flux scale closures cannot see; see fit_closures)

    This is how degeneracies break: a continuum SED constrains
    density×temperature along its own ridge, an RRL profile pins the
    temperature independently (Doppler width) and the velocity
    (centroid) — jointly they separate what neither can alone.  The
    multi-epoch × multi-frequency × line run matrix the reference only
    *simulates* (classes.py:2140-2172) becomes a single coherent
    inference here.  ``FitResult.model`` is the tuple of fitted model
    outputs, one per component.
    """
    if not components:
        raise ValueError("fit_joint needs at least one component")
    fwds, losses = [], []
    theta0 = None
    for comp in components:
        f, l, th0 = _component_forward_loss(jm, comp, free,
                                            comp.get('time', time),
                                            dtype)
        fwds.append(f)
        losses.append(l)
        # slot-wise merge: a non-RRL component leaves NaN at any
        # nonlte.* slots (it has no opinion on departure-coefficient
        # starting values); an RRL component fills them
        th0 = np.asarray(th0, float)
        theta0 = th0 if theta0 is None else np.where(
            np.isnan(theta0), th0, theta0)
    if theta0 is not None and np.isnan(theta0).any():
        raise ValueError(
            "freed nonlte.* parameters need at least one rrl_spectrum/"
            "rrl_cube component to define their starting values")
    theta0 = jnp.asarray(theta0)

    def forward(theta):
        return tuple(f(theta) for f in fwds)

    def loss(models):
        total = losses[0](models[0])
        for l, m in zip(losses[1:], models[1:]):
            total = total + l(m)
        return total

    return _run_fit(forward, theta0, free, loss, steps, learning_rate,
                    optimizer, n_starts, start_spread, seed, mesh)


# --------------------------------------------------------------------------- #
# Light-curve (ejection burst) fitting
# --------------------------------------------------------------------------- #
class BurstFitResult(NamedTuple):
    """Fitted ejection-event parameters (years / chi factors, the
    params['ejection'] schema)."""
    t_0: np.ndarray            # burst peak times [yr]
    hl: np.ndarray             # half-lives [yr]
    chi: np.ndarray            # peak jml / steady-state jml
    loss: np.ndarray
    model: np.ndarray          # fitted light curve (n_times, n_chan)


def build_light_curve_forward(jm, times, freqs,
                              free: Sequence[str] = ('t_0', 'hl', 'chi')):
    """``(forward, theta0, unpack)``: light curve (n_times, n_chan) [Jy]
    as a function of the ejection-event parameters.

    Static fields, the base opacity cube and the channel scale are all
    burst-independent, so they are computed once (concrete) and closed
    over; only the burst factor is re-evaluated per epoch — the same
    factorisation as the production epoch path (jetmodel.py:733-760),
    here in differentiable XLA form.  theta packs, per burst:
    [t_0/yr (linear), log hl/yr, log chi] for each freed name.
    """
    for p in free:
        if p not in ('t_0', 'hl', 'chi'):
            raise ValueError(f"free must be among t_0/hl/chi, got {p!r}")
    params = jm.params
    ej = params['ejection']
    t0_yr = np.atleast_1d(np.asarray(ej['t_0'], float))
    hl_yr = np.atleast_1d(np.asarray(ej['hl'], float))
    chi_f = np.atleast_1d(np.asarray(ej['chi'], float))
    which = [str(w).upper() for w in np.atleast_1d(np.asarray(ej['which']))]
    n_b = len(t0_yr)
    if n_b == 0:
        raise ValueError("model has no ejection events to fit")

    f = jm._ensure_fields()
    reyn = jm._use_reynolds_gaunt()
    csize, dist = params['grid']['c_size'], params['target']['dist']
    dt = jnp.float64
    nd, xi, temp, inside = (jnp.asarray(np.asarray(a), dt) for a in
                            (f.nd, f.xi, f.temp, f.inside))
    inside = inside.astype(bool)
    ts = jnp.asarray(np.asarray(f.ts), dt)
    red = jnp.asarray(np.asarray(f.red), bool)
    ds = rt.path_length_cm(jnp.asarray(np.asarray(f.ff), dt),
                           jnp.asarray(np.asarray(f.area), dt), csize)
    base = rt.tau_ff_base(temp, nd * xi, ds, inside, reyn)
    freqs = jnp.atleast_1d(jnp.asarray(freqs, dt))
    scale = rt.tau_ff_channel_scale(freqs, params['properties']['T_0'],
                                    reyn)
    tbar, any_in = rt.mean_temperature_map(temp, inside)
    times = jnp.asarray(np.atleast_1d(np.asarray(times, float)), dt)

    theta0, layout = [], []
    for i in range(n_b):
        for name in free:
            layout.append((i, name))
            theta0.append({'t_0': t0_yr[i], 'hl': np.log(hl_yr[i]),
                           'chi': np.log(chi_f[i])}[name])
    theta0 = jnp.asarray(theta0, dt)

    def unpack(theta):
        """theta -> (t0 [s], sigma [s], chi) per burst (traced lists)."""
        t0 = [jnp.asarray(t, dt) for t in t0_yr]
        hl = [jnp.asarray(h, dt) for h in hl_yr]
        ch = [jnp.asarray(c, dt) for c in chi_f]
        for j, (i, name) in enumerate(layout):
            if name == 't_0':
                t0[i] = theta[j]
            elif name == 'hl':
                hl[i] = jnp.exp(theta[j])
            else:
                ch[i] = jnp.exp(theta[j])
        # sigma = hl * 2 / (2 sqrt(2 ln 2)) (ejection.py:34-36)
        sig = [h * YEAR / jnp.sqrt(2.0 * jnp.log(2.0)) for h in hl]
        return ([t * YEAR for t in t0], sig, ch)

    # burst -> jet-side assignment ('R' in which / 'B' in which)
    sides = [(('R' in w), ('B' in w)) for w in which]

    # big arrays live in an explicit consts pytree: the fit loop passes
    # them as runtime arguments to its jit, never closure constants (a
    # closed-over cube becomes an HLO constant, and a multi-GB program
    # compiles slowly or not at all at production grids)
    consts = dict(base=base, ts=ts, red=red, scale=scale, tbar=tbar,
                  any_in=any_in, times=times, freqs=freqs)

    def forward_with(theta, c):
        t0_s, sig_s, chi_s = unpack(theta)
        b_t0, b_sig, b_amp, b_red = [], [], [], []
        for i in range(n_b):
            for red_side in (True, False):
                if sides[i][0 if red_side else 1]:
                    b_t0.append(t0_s[i])
                    b_sig.append(sig_s[i])
                    b_amp.append(chi_s[i] - 1.0)
                    b_red.append(red_side)
        bt0 = jnp.stack(b_t0)
        bsig = jnp.stack(b_sig)
        bamp = jnp.stack(b_amp)
        bred = jnp.asarray(b_red, bool)

        def one_epoch(t):
            chi = _chi_scan(c['red'], t - c['ts'], bt0, bsig, bamp, bred)
            tau_map = c['scale'][:, None, None] * \
                jnp.sum(c['base'] * chi * chi, axis=rt.LOS_AXIS)[None]
            fl = rt.flux_ff_maps(c['freqs'], tau_map, c['tbar'],
                                 c['any_in'], csize, dist)
            return jnp.sum(fl, axis=(1, 2))

        return jax.vmap(one_epoch)(c['times'])

    def forward(theta):
        return forward_with(theta, consts)

    forward.with_consts = forward_with
    forward.consts = consts
    return forward, theta0, unpack


def fit_light_curve(jm, times, freqs, observed, *, errors=None,
                    free: Sequence[str] = ('t_0', 'hl', 'chi'),
                    steps: int = 500, learning_rate: float = 0.05,
                    optimizer=None) -> BurstFitResult:
    """Recover ejection-event parameters from an observed flux time
    series: ``observed`` is (n_times,) or (n_times, n_chan) fluxes [Jy]
    at model times ``times`` [s].

    The inverse problem the reference's forward-only pipeline
    (classes.py:2296-2420 — simulate, inspect, re-guess) cannot pose.
    """
    forward, theta0, unpack = build_light_curve_forward(jm, times, freqs,
                                                        free)
    obs = jnp.asarray(np.atleast_1d(np.asarray(observed, float)),
                      jnp.float64)
    was_1d = obs.ndim == 1
    if was_1d:
        obs = obs[:, None]
        if errors is not None:
            # match the observed reshape: 1-D per-time errors against the
            # (n_times, 1) observations would broadcast the residual to an
            # (n_times, n_times) outer-difference matrix.  (2-D observed
            # keeps errors as given — a (n_chan,) vector broadcasts
            # per-channel correctly there.)
            errors = np.atleast_1d(np.asarray(errors, float))
            if errors.ndim == 1:
                errors = errors[:, None]
    loss = _sed_loss(obs, errors)
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)

    @jax.jit
    def run(theta, consts):
        state = opt.init(theta)

        def step(carry, _):
            th, st = carry
            val, grad = jax.value_and_grad(
                lambda t: loss(forward.with_consts(t, consts)))(th)
            updates, st = opt.update(grad, st, th)
            return (optax.apply_updates(th, updates), st), val

        (theta, _), hist = lax.scan(step, (theta, state), None,
                                    length=steps)
        return theta, hist

    theta, hist = run(theta0, forward.consts)
    t0_s, sig_s, chi_s = unpack(theta)
    t0 = np.asarray([float(t) for t in t0_s]) / YEAR
    hl = np.asarray([float(s) for s in sig_s]) / YEAR * \
        np.sqrt(2.0 * np.log(2.0))
    chis = np.asarray([float(c) for c in chi_s])
    # post-fit model: jit with the cubes as runtime args — jitting the
    # consts-closing wrapper would bake them in as HLO constants, and
    # eagerly it replays the chain op-by-op
    return BurstFitResult(t_0=t0, hl=hl, chi=chis,
                          loss=np.asarray(hist),
                          model=np.asarray(jax.jit(forward.with_consts)(
                              theta, forward.consts)))


# --------------------------------------------------------------------------- #
# Batched parameter surveys (beyond-reference; the on-device "run the
# model at many parameter sets" pattern — one compiled program instead
# of the reference's one-process-per-model sweep)
# --------------------------------------------------------------------------- #
class SweepResult(NamedTuple):
    """Outcome of :func:`sweep`."""
    paths: Tuple[str, ...]       # swept parameter paths, in grid order
    points: Dict[str, np.ndarray]  # value of each path per combo (n,)
    values: np.ndarray           # (n, ...) forward outputs per combo
    shape: Tuple[int, ...]       # Cartesian grid shape (product mode)

    def reshaped(self):
        """``values`` with the combo axis unflattened to ``shape``
        (product mode only)."""
        return self.values.reshape(self.shape + self.values.shape[1:])


def sweep(jm, freqs, grid: Dict[str, Sequence], *, kind: str = 'sed',
          line: str = None, time=None, dtype=None,
          batch_size: int = None, mesh=None, product: bool = True
          ) -> SweepResult:
    """Evaluate the forward model over a grid of parameter sets in ONE
    vmapped compiled program.

    The reference runs one full Python process per model evaluation; a
    parameter survey there is a job array.  Here the combos axis is a
    batch axis of a single XLA program: ``grid`` maps parameter paths
    (any of :data:`SUPPORTED_FREE`; the ``nonlte.b_n*`` pseudo-paths
    need ``kind='rrl_spectrum'``) to 1-D value arrays, swept over
    their Cartesian product (``product=True``, default) or zipped
    elementwise (equal lengths required).

    ``kind``: ``'sed'`` — integrated fluxes, values ``(n, n_chan)``;
    ``'map'`` — flux maps ``(n, n_chan, nx, nz)``; ``'rrl_spectrum'`` —
    spatially-integrated line spectrum (needs ``line=``).

    ``batch_size`` chunks the combo axis with ``lax.map`` to bound
    device memory (each chunk is an inner vmap).  ``mesh`` shards the
    combo axis over the mesh's first axis — the multi-chip survey
    pattern (parameter sets fan out across devices, each evaluating the
    full model).
    """
    paths = tuple(grid)
    # the nonlte.b_n* pseudo-paths exist only in the RRL forwards
    _check_free(paths, allow_nonlte=(kind == 'rrl_spectrum'))
    vals = [np.atleast_1d(np.asarray(grid[p], float)) for p in paths]
    if product:
        meshed = np.meshgrid(*vals, indexing='ij')
        shape = meshed[0].shape
        cols = [m.reshape(-1) for m in meshed]
    else:
        n = {v.size for v in vals}
        if len(n) != 1:
            raise ValueError("product=False needs equal-length value "
                             f"arrays, got sizes {sorted(n)}")
        shape = (vals[0].size,)
        cols = vals
    thetas = np.stack([np.log(c) if SUPPORTED_FREE[p] == 'log' else c
                       for p, c in zip(paths, cols)], axis=1)

    if kind == 'sed':
        forward, _ = build_sed_forward(jm, freqs, paths, time, dtype)
    elif kind == 'map':
        forward, _ = build_flux_forward(jm, freqs, paths, time, dtype)
    elif kind == 'rrl_spectrum':
        if line is None:
            raise ValueError("kind='rrl_spectrum' needs line=")
        forward, _ = build_rrl_spectrum_forward(jm, line, freqs, paths,
                                                time, dtype)
    else:
        raise ValueError(f"unknown sweep kind {kind!r}")

    n = thetas.shape[0]
    th = jnp.asarray(thetas)
    sharding_spec = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        axis = mesh.axis_names[0]
        n_dev = mesh.shape[axis]
        if batch_size:
            # chunked AND sharded: each lax.map step vmaps one chunk
            # whose combo axis shards over the mesh — batch_size bounds
            # per-device memory on pods too
            batch_size = -(-batch_size // n_dev) * n_dev
            sharding_spec = NamedSharding(mesh, P(None, axis))
        else:
            th = jax.device_put(_pad_to_multiple(th, n_dev),
                                NamedSharding(mesh, P(axis)))
    if batch_size and (batch_size < n or sharding_spec is not None):
        th = _pad_to_multiple(th, batch_size)
        chunks = th.reshape(-1, batch_size, th.shape[1])
        if sharding_spec is not None:
            chunks = jax.device_put(chunks, sharding_spec)

        @jax.jit
        def run(chunks):
            return lax.map(jax.vmap(forward), chunks)
        res = run(chunks)
        out = res.reshape((res.shape[0] * res.shape[1],) +
                          res.shape[2:])[:n]
    else:
        out = jax.jit(jax.vmap(forward))(th)[:n]
    return SweepResult(paths=paths,
                       points={p: c for p, c in zip(paths, cols)},
                       values=np.asarray(out), shape=shape)
