"""The plain reference against itself and against the port on the CPU at
small sizes, the control in bfloat16 failing the cells' limits, and the
interaction count the roofline share rests on."""

import math

import pytest
import torch

import smallcells
from reference import gravity
from reference.cosmology import Cosmology


def slow_ewald(pos, mass, h, box):
    """The Ewald sum with alpha = 2 / L over 343 images and every k with
    |n|^2 <= 100, softened within h: independent of the fast split."""
    n = pos.shape[0]
    alpha = 2.0 / box
    r = torch.arange(-3, 4)
    img = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                      -1).reshape(-1, 3).double() * box
    out = torch.zeros(n, 3, dtype=torch.float64)
    for i in range(n):
        d = pos[None] - pos[i] + img[:, None]
        rr = d.norm(dim=-1)
        rs = torch.where(rr > 0, rr, torch.ones_like(rr))
        ar = alpha * rs
        f = (torch.special.erfc(ar)
             + 2 / math.sqrt(math.pi) * ar * torch.exp(-ar * ar)) / rs ** 3
        out[i] = ((torch.where(rr > 0, f, 0.0) * mass)[..., None] * d).sum(
            (0, 1))
    kr = torch.arange(-10, 11)
    kv = torch.stack(torch.meshgrid(kr, kr, kr, indexing="ij"),
                     -1).reshape(-1, 3)
    n2 = (kv * kv).sum(-1)
    kv = kv[(n2 > 0) & (n2 <= 100)].double() * 2 * math.pi / box
    k2 = (kv * kv).sum(-1)
    w = 4 * math.pi / box ** 3 * torch.exp(-k2 / (4 * alpha ** 2)) / k2
    for i in range(n):
        ph = (pos - pos[i]) @ kv.T
        out[i] += ((w * (mass[:, None] * torch.sin(ph))).sum(0)[:, None]
                   * kv).sum(0)
        d = pos - pos[i]
        d = d - box * torch.round(d / box)
        rr = d.norm(dim=-1)
        near = (rr > 0) & (rr < h[i])
        out[i] += ((gravity.spline_factor(h[i], rr[near]) - rr[near] ** -3)
                   [:, None] * mass[near, None] * d[near]).sum(0)
    return out


def test_ewald_split_agrees_with_a_slow_sum():
    g = torch.Generator().manual_seed(3)
    box, n = 100.0, 48
    pos = torch.rand(n, 3, generator=g, dtype=torch.float64) * box
    mass = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    h = torch.full((n,), 6.0, dtype=torch.float64)
    fast = gravity.periodic_accel(pos, mass, torch.zeros(n, dtype=torch.int32),
                                  h, torch.arange(n), box, "newton", 1.0)
    slow = slow_ewald(pos, mass, h, box)
    rel = (fast - slow).norm(dim=1) / slow.norm(dim=1)
    assert float(rel.max()) < 1e-6


def test_long_range_and_the_short_sum_make_the_ewald_sum():
    """Under "newton" the long-range part is the Ewald sum's k-space half
    with alpha = 1 / (2 rs): with the real-space half over the nearest
    image (erfc(L / (4 rs)) ~ 6e-6 at PMGRID 16) it gives the whole
    periodic force."""
    g = torch.Generator().manual_seed(5)
    box, n, pmgrid = 100.0, 40, 16
    pos = torch.rand(n, 3, generator=g, dtype=torch.float64) * box
    mass = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    grav = torch.zeros(n, dtype=torch.int32)
    h = torch.full((n,), 1e-3, dtype=torch.float64)
    tgt = torch.arange(n)
    whole = gravity.periodic_accel(pos, mass, grav, h, tgt, box, "newton",
                                   1.0)
    long = gravity.long_range_accel(pos, mass, grav, tgt, box, "newton",
                                    1.0, pmgrid)
    alpha = 1.0 / (2 * gravity.PM_ASMTH * box / pmgrid)
    d = pos[None] - pos[:, None]
    d = d - box * torch.round(d / box)
    r = d.norm(dim=-1)
    rs_ = torch.where(r > 0, r, torch.ones_like(r))
    ar = alpha * rs_
    f = (torch.special.erfc(ar)
         + 2 / math.sqrt(math.pi) * ar * torch.exp(-ar * ar)) / rs_ ** 3
    short = ((torch.where(r > 0, f, 0.0) * mass[None])[..., None] * d).sum(1)
    rel = (long + short - whole).norm() / whole.norm()
    assert float(rel) < 1e-5
    assert float(long.norm()) > 0.05 * float(whole.norm())


def test_long_range_yukawa_against_a_plain_k_sum():
    """The separable sum against every mode summed one by one, with two
    gravities under "newton_yukawa" (Newton within, screened Yukawa
    between)."""
    g = torch.Generator().manual_seed(6)
    box, n, pmgrid = 100.0, 30, 16
    pos = torch.rand(n, 3, generator=g, dtype=torch.float64) * box
    mass = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    grav = (torch.arange(n) % 2).to(torch.int32)
    tgt = torch.tensor([0, 1, 7, 12])
    got = gravity.long_range_accel(pos, mass, grav, tgt, box,
                                   "newton_yukawa", 1.0, pmgrid)
    rs = gravity.PM_ASMTH * box / pmgrid
    mu = gravity.YUKAWA_IMASS / box
    kf = 2 * math.pi / box
    m_ = int(math.ceil(math.sqrt(-math.log(gravity.PM_KEEP)) / (kf * rs)))
    r = torch.arange(-m_, m_ + 1)
    kv = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                     -1).reshape(-1, 3)
    kv = kv[(kv * kv).sum(-1) > 0].double() * kf
    k2 = (kv * kv).sum(-1)
    for row, t in enumerate(tgt.tolist()):
        want = torch.zeros(3, dtype=torch.float64)
        for j in range(n):
            q2 = k2 + (0.0 if grav[j] == grav[t] else mu * mu)
            ker = 4 * math.pi * torch.exp(-q2 * rs * rs) / q2
            ph = (pos[t] - pos[j]) @ kv.T
            want += mass[j] * ((ker * torch.sin(ph))[:, None] * kv).sum(0)
        want = -want / box ** 3
        assert float((got[row] - want).norm()) < 1e-9 * float(want.norm())


def test_yukawa_pairs_are_the_nearest_image():
    box = 100.0
    pos = torch.tensor([[1.0, 1, 1], [99.5, 1, 1], [50, 50, 50]],
                       dtype=torch.float64)
    mass = torch.tensor([1.0, 2.0, 1e-30], dtype=torch.float64)
    grav = torch.tensor([0, 1, 0], dtype=torch.int32)
    h = torch.full((3,), 0.1, dtype=torch.float64)
    a = gravity.periodic_accel(pos, mass, grav, h, torch.tensor([0]), box,
                               "newton_yukawa", 1.0)
    ym, r = 60.0 / box, 1.5
    want = 2.0 * math.exp(-ym * r) * (ym * r + 1) / r ** 2
    assert float(a[0, 0]) == pytest.approx(-want, rel=1e-12)


def test_open_sum_softening_matches_newton_outside_h():
    pos = torch.tensor([[0.0, 0, 0], [3.0, 0, 0], [0.4, 0, 0]],
                       dtype=torch.float64)
    mass = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    h = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float64)
    a = gravity.open_accel(pos, mass, h, torch.tensor([0]), 1.0)
    u = 0.4
    soft = 4.0 * (10.666666666667 + u * u * (32 * u - 38.4)) * 0.4
    assert float(a[0, 0]) == pytest.approx(2.0 / 9 + soft, rel=1e-12)


def test_drift_and_kick_integrals():
    c = Cosmology({"ComovingIntegrationOn": 1, "Omega0": 1.0,
                   "OmegaLambda": 0.0, "TimeBegin": 0.1, "TimeMax": 1.0})
    # Einstein-de Sitter: int da / (H0 a^3 a^-1.5) = 2 (a0^-1/2 - a1^-1/2) / H0
    a0, a1 = c.time(1 << 20), c.time(1 << 22)
    want = 2 * (a0 ** -0.5 - a1 ** -0.5) / c.H0
    assert c.drift(1 << 20, 1 << 22) == pytest.approx(want, rel=1e-12)
    want_k = 2 * (a1 ** 0.5 - a0 ** 0.5) / c.H0
    assert c.gravkick(1 << 20, 1 << 22) == pytest.approx(want_k, rel=1e-12)
    flat = Cosmology({"TimeBegin": 0.0, "TimeMax": 2.0})
    assert flat.drift(0, 1 << 27) == pytest.approx(1.0)
    assert flat.G == pytest.approx(43007.1, rel=1e-5)


@pytest.fixture(scope="module")
def runs():
    """One CPU run of each small cell with the control's readings."""
    return {name: smallcells.run_small(name, 2 ** 31 + 99, control=True)
            for name in ("galaxy.tree", "lcdm_gas.full")}


# the reference against the port at these sizes, each bound with its
# reason: the tree's force error (ErrTolForceAcc 0.005 open; TreePM at
# PMGRID 16 on an 8^3 lattice, whose mesh force errs by some 7%), float32
# sums against float64 ones for the SPH and the kick, a float32 drift
# within a few spacings of float32
PORT_BOUNDS = {"galaxy.tree": dict(gravity_l2_rel=3e-3, drift_max_ulp=4.0,
                                   kick_max_rel=1e-4),
               "lcdm_gas.full": dict(gravity_l2_rel=6e-2, pm_l2_rel=0.1,
                                     density_max_rel=1e-5,
                                     hydro_rms_rel=1e-4, drift_max_ulp=4.0,
                                     kick_max_rel=1e-4)}


@pytest.mark.parametrize("name", ["galaxy.tree", "lcdm_gas.full"])
def test_reference_against_the_port(runs, name):
    res = runs[name]
    got = {k: v["value"] for k, v in res["check"].items()}
    for k, bound in PORT_BOUNDS[name].items():
        assert got[k] < bound, (k, got[k])
    assert got["stalled_steps"] == 0
    if "ngb_window_dev" in got:
        assert got["ngb_window_dev"] <= res["check"]["ngb_window_dev"][
            "limit"]


@pytest.mark.parametrize("name", ["galaxy.tree", "lcdm_gas.full"])
def test_the_control_fails_the_cells_limits(runs, name):
    """The reference in bfloat16 in the program's place fails at least one
    of the cell's limits (its numbers as the control would report them)."""
    res = runs[name]
    ctrl = res["control"]
    over = [k for k, v in ctrl.items() if v > res["check"][k]["limit"]]
    assert over, ctrl


def test_n_ia_counts_the_valid_pairs_handed_to_k1():
    """GravitySolver.compute's n_ia equals the valid pairs (live source
    rows, not the target itself, of a real target) of the pair evaluations
    of the walk attempt it kept."""
    import tempfile
    from ngravs_tpu_torch.ops import pairwise
    cell = smallcells.small_cell("galaxy.tree")
    with tempfile.TemporaryDirectory() as tmp:
        sim = smallcells.harness.make_simulation(cell, 5, "cpu", tmp)
        sim.step()
        launches = []
        inner = sim.solver.pair_eval

        def counting(targets, sp, n_src, *a, **kw):
            nb, _, s = sp.shape
            g = targets["x"].shape[0] // nb
            sgid = sp[:, pairwise.IGID, :].view(torch.int32)[:, None, :]
            tgid = targets["gid"].reshape(nb, g, 1)
            live = torch.arange(s)[None, None, :] < n_src.reshape(nb, 1, 1)
            valid = live & (sgid != -1) & (sgid != tgid) & (tgid >= 0)
            launches.append(int(valid.sum()))
            return inner(targets, sp, n_src, *a, **kw)
        sim.solver.pair_eval = counting
        walk = type(sim.solver)._walk
        attempts = []

        def tagged(want_pot):
            fn = walk(sim.solver, want_pot)

            def run(*a, **kw):
                first = len(launches)
                res = fn(*a, **kw)
                attempts.append((first, len(launches)))
                return res
            return run
        sim.solver._walk = tagged
        p = sim.p.replace(ti_endstep=torch.full_like(sim.p.ti_endstep,
                                                     sim.ti_current))
        _, n_ia, _ = sim.solver.compute(p, sim.ti_current, p.n)
    first, end = attempts[-1]
    assert n_ia > 0 and n_ia == sum(launches[first:end])
