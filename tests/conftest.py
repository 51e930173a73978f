"""Test configuration: force the CPU backend with a virtual 8-device mesh
BEFORE jax initialises (driver contract: sharding tests run on
xla_force_host_platform_device_count=8)."""
import os

os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags +
                               " --xla_force_host_platform_device_count=8")

import jax                  # noqa: E402

# Belt and braces: a pytest plugin may have imported jax before this
# conftest ran, in which case the env vars above are too late.  Forcing
# via the config API works as long as the backend has not been
# initialised yet.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np          # noqa: E402
import pytest               # noqa: E402


@pytest.fixture
def model_params():
    """Fresh copy of the bundled example model params (same values as the
    reference's files/example-model-params.py) on a small grid."""
    return {
        "target": {"name": "test", "ra": "04:31:34.07736",
                   "dec": "+18:08:04.9020", "epoch": "J2000", "dist": 120.,
                   "v_lsr": 6.2, "M_star": 0.55, "R_1": .25, "R_2": 2.5},
        "grid": {"n_x": 32, "n_y": 80, "n_z": 32, "l_z": None,
                 "c_size": 0.5},
        "geometry": {"epsilon": 7. / 9., "opang": 25., "w_0": 1., "r_0": 1.,
                     "inc": 90., "pa": 0., "rotation": "CCW"},
        "power_laws": {"q_v": 0., "q_T": 0., "q_x": 0., "q^d_n": 0.,
                       "q^d_T": 0., "q^d_v": 0., "q^d_x": 0.},
        "properties": {"v_0": 150., "x_0": 0.1, "T_0": 1E4, "mu": 1.3,
                       "mlr_bj": 1e-7, "mlr_rj": 5e-8},
        "ejection": {"t_0": np.array([0.5, 0.75]),
                     "hl": np.array([0.15, 0.15]),
                     "chi": np.array([5., 2.5]),
                     "which": np.array(["R", "B"])},
    }


@pytest.fixture
def disc_wind_params(model_params):
    """Params exercising the disc-wind cross-section power laws and
    non-trivial geometry."""
    p = {k: dict(v) if isinstance(v, dict) else v
         for k, v in model_params.items()}
    p['geometry'] = dict(p['geometry'])
    p['geometry'].update(inc=60., pa=30.)
    p['power_laws'] = dict(p['power_laws'])
    p['power_laws'].update({'q_v': -0.2, 'q_T': -0.5, 'q_x': 0.1,
                            'q^d_n': -0.3, 'q^d_T': 0.2, 'q^d_v': 0.4,
                            'q^d_x': -0.1})
    return p
