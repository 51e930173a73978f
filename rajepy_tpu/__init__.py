"""rajepy_tpu — a JAX radiative-transfer and synthetic-observation
framework for ionised jets from young stellar objects.

A ground-up JAX/XLA/Pallas rebuild with the capabilities of the reference
RaJePy package (SimonP2207/RaJePy): Reynolds (1986) + disc-wind jet models
on a voxel grid, free-free continuum and LTE radio-recombination-line
radiative transfer, FITS sky models, and CASA-free on-device synthetic
interferometric observations (uv sampling, thermal noise, imaging, CLEAN,
source fitting).

Package layout
--------------
- ``ops``       pure-JAX kernels: geometry, Reynolds physics, Gauss 2F1,
                Faddeeva/Voigt, van Hoof gaunt factors, RRL line physics,
                radiative-transfer reductions/scans
- ``models``    grid construction, field evaluation, ejection bursts,
                the ``JetModel`` API
- ``parallel``  device-mesh sharding of the RT step (pjit/shard_map)
- ``synthobs``  interferometer simulation replacing the CASA subprocess
- ``fit``       differentiable parameter inference: gradient fitting of
                SEDs, flux maps and ejection-burst light curves
- ``io``        FITS writer/reader, checkpoints
- ``plotting``  diagnostic figures
- ``utils``     logging, validation, misc helpers

Float64 is enabled globally (required for the 1e-6 oracle-parity targets);
``JetModel``'s default ``dtype='auto'`` computes in float32 on an
accelerator (see :mod:`rajepy_tpu.ops.paths`).
"""
import os as _os

from jax import config as _jax_config

_jax_config.update("jax_enable_x64", True)


def compile_cache_dir():
    """Where this package keeps JAX's persistent compilation cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads the variable
    itself), else the fixed ``<checkout>/.jax_cache``.  The path is part
    of the cache key, so it must not move between runs."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


# Persistent compilation cache: compiles dominate cold starts, and a
# process that finds its programs cached skips them.
_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    try:
        _os.makedirs(_cache_dir, exist_ok=True)
        _jax_config.update("jax_compilation_cache_dir", _cache_dir)
        _jax_config.update("jax_persistent_cache_min_compile_time_secs",
                           1.0)
    except OSError:  # read-only checkout — run without the cache
        pass

from . import constants as cnsts            # noqa: E402
from . import _config as cfg                # noqa: E402
from .utils.logger import Log               # noqa: E402
from .utils import logger                   # noqa: E402  (Log export fix,
#                                                  SURVEY §1 L8)
from .models.jetmodel import JetModel       # noqa: E402
from .models.runs import ContinuumRun, Pointing, RRLRun  # noqa: E402
from .pipeline import Pipeline              # noqa: E402

__version__ = "0.2.0"

__all__ = ["JetModel", "Pipeline", "ContinuumRun", "RRLRun", "Pointing",
           "Log", "logger", "cnsts", "cfg", "__version__"]
