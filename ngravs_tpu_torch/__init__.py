"""ngravs_tpu_torch — the PyTorch/CUDA port of `ngravs_tpu`.

A port of the JAX package (a rebuild of GADGET-2.0.7-ngravs, Springel's
TreePM/SPH code with Kevin Croker's N-gravities extension) to PyTorch, with
the JAX package's one Pallas kernel rewritten by hand in CUDA C++ for the
H100 (`csrc/`).  The layout mirrors `ngravs_tpu/` module for module.  This
package imports torch and numpy only; the JAX package is its reference.
"""

__version__ = "0.1.0"

from .config import SimulationConfig, read_parameter_file
from .particles import Particles, SphState
from .units import set_units
