"""The card's peaks and K1's operations per pair: the yardstick of
`k1.roofline_pct`.

A frozen copy of the counts taken from ngravs_tpu_torch/csrc/pairwise.cu
(each add, multiply, divide, sqrt, exp, compare one, an FMA two): BASE is
the displacement, r^2, sqrt, the softening, the branch and the three
accumulations; PERIODIC the three minimum images; TPM_U the TreePM
u = r / (2 asmth) and its cut; LAW[kind] the force of each law kind.
The benchmark owns these numbers: a later change to the kernel does not
move them.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense FP32 outside the tensor cores and HBM3, at 700 W
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

OPS_BASE, OPS_PERIODIC, OPS_TPM_U = 17, 12, 2
# force operations of a law, by the kernel's kind (1 Newton, 3 Yukawa)
OPS_LAW = {1: 6, 3: 13}
WIRING_KINDS = {"newton": (1,), "newton_yukawa": (1, 3)}
# what a pair evaluation reads and writes at the least per target: its
# position, mass, softening, gravity and id, and its acceleration and count
BYTES_TARGET = 7 * 4 + 16


def ops_per_pair(wiring: str, periodic: bool, treepm: bool) -> int:
    """The fewest operations any valid pair takes.  Under TreePM a pair
    past the cut skips its law, so only BASE, PERIODIC and TPM_U count;
    otherwise the cheapest law of the wiring is added.  A floor: the
    roofline share built on it is a floor too."""
    ops = OPS_BASE + (OPS_PERIODIC if periodic else 0)
    if treepm:
        return ops + OPS_TPM_U
    return ops + min(OPS_LAW[k] for k in WIRING_KINDS[wiring])


def config_ops_per_pair(config: dict) -> int:
    """`ops_per_pair` of a configuration file's wiring and box."""
    periodic = bool(int(config["param"].get("PeriodicBoundariesOn", 0)))
    return ops_per_pair(config["wiring"], periodic,
                        bool(config["port"].get("pmgrid", 0)))


def bound_s(pairs: float, targets: float, ops: int) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    return max(pairs * ops / PEAK_FP32, targets * BYTES_TARGET / PEAK_BYTES)
