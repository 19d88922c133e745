"""icm_slam_tpu — ICM-SLAM engine in JAX / XLA.

Brand-new implementation of the capabilities of the reference ICM-SLAM
package (Seba-san/icm-slam), redesigned for accelerators: masked fixed
shapes, batched Gauss-Newton pose solves, segment-sum map updates,
red-black parallel sweeps, and device-mesh sharding over the time axis.
"""
import os as _os

from icm_slam_tpu.config import ICMConfig

__version__ = "0.1.0"
__all__ = ["ICMConfig"]

# persistent XLA compile cache at a fixed path inside the checkout
# (git-ignored): the path is part of the cache key, so it must not move
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compilation_cache_dir(environ=_os.environ) -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``CACHE_DIR``."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def _enable_compilation_cache():
    import jax
    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())


_enable_compilation_cache()
