"""K3's operations per pair and its device time in a profiled sub-window:
the yardstick of `lattice.ms_per_solve` and `lattice.roofline_pct`.

OPS_LATTICE is a frozen count taken from ngravs_tpu_torch/csrc/lattice.cu
with `roofline.py`'s rules (each add, multiply, compare or absolute value
one; the integer index arithmetic and the conversions not counted), for a
pair without the potential, the fewest any valid pair takes: the
displacement 3, the minimum image 12 (a multiply, a rounding, a multiply
and a subtraction an axis), the octant fold 6 (an absolute value and a
compare an axis), the cell fractions 6, the three 1 - u 3, the eight
corner weights 12, the interpolation of three components 45 (eight
multiplies and seven adds each), then the signs, the source mass and the
accumulation 9.  The benchmark owns this number: a later change to the
kernel does not move it.
"""

from __future__ import annotations

OPS_LATTICE = 96
# K3's symbol: every device operation whose name holds it is K3's
K3_NAME = "lattice_kernel"


def k3_seconds(profile: dict) -> float:
    """K3's device seconds among the profiled sub-window's largest device
    operations (`devtrace.reduce`'s breakdown, the ten largest by name);
    0 where K3 is not among them."""
    return sum(t for name, t in profile["breakdown"]["device_ops"]
               if K3_NAME in name)
