"""The port's force laws and preset wirings against the JAX package's.

Every law method (accel, spline, potential, spline_pot, the force and
potential factors with and without the TreePM long-range term, greens,
normed_greens, and the closed-form short-range pair sf/sp) is evaluated by
both packages on an r x h grid that covers r = 0, r < h/2, h/2 <= r < h
and r >= h, in f32.  They agree within rtol 1e-6 (the same f32 operations
in the same order; the last bit may differ where a library exp, atan or
sqrt rounds differently) with an absolute floor of 1e-6 of the largest
value on the grid (the TreePM forms subtract and can cancel), 1e-5 where
the A&S erfc and the exponentials of the Yukawa truncation enter.  Every
preset wiring builds, passes the L3 check and groups its slots into the
same unique laws as the JAX wiring.
"""

import numpy as np
import pytest
import torch

from ngravs_tpu import config as jconfig
from ngravs_tpu.models import laws as jlaws
from ngravs_tpu.models import wiring as jwiring

from ngravs_tpu_torch import config as tconfig
from ngravs_tpu_torch.models import laws as tlaws
from ngravs_tpu_torch.models import wiring as twiring

BOX, PMGRID, ASMTH = 50.0, 32, 1.25


def _grid():
    r = np.concatenate([[0.0], np.geomspace(1e-3, 30.0, 41)])
    h = np.array([0.05, 0.4, 2.8, 7.0])
    rr, hh = (a.astype(np.float32) for a in np.meshgrid(r, h))
    return np.float32(0.9), np.float32(1.7), rr * rr, rr, hh


def _laws(mod):
    y = (60.0, BOX, PMGRID, ASMTH)
    return {
        "None": mod.NoneLaw(), "NegNewton": mod.NegNewtonian(),
        "Yukawa": mod.Yukawa(*y), "Yukawa_nomesh": mod.Yukawa(60.0, BOX),
        "ColoYuk": mod.ColoYuk(*y), "BamBam": mod.BamBam(0.3),
        "SourceBam": mod.SourceBamBaryon(0.3),
        "TargetBam": mod.SourceBaryonBam(0.3),
    }


@pytest.mark.parametrize("name", list(_laws(jlaws)))
def test_law_methods_match(name):
    j, t = _laws(jlaws)[name], _laws(tlaws)[name]
    tm, sm, r2, r, h = _grid()
    n = np.float32(3.0)          # an accumulator count != 1
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tt = T(tm), T(sm), T(r2), T(r), T(h)
    lr = np.float32(0.3)
    calls = {
        "accel": ((tm, sm, r2, r, n), (tt[0], tt[1], tt[2], tt[3], T(n))),
        "spline": ((tm, sm, h, r, n), (tt[0], tt[1], tt[4], tt[3], T(n))),
        "potential": ((tm, sm, r2, r, n), (tt[0], tt[1], tt[2], tt[3], T(n))),
        "spline_pot": ((tm, sm, h, r, n), (tt[0], tt[1], tt[4], tt[3], T(n))),
        "force_factor": ((tm, sm, r2, r, h, n), tt + (T(n),)),
        "potential_factor": ((tm, sm, r2, r, h, n), tt + (T(n),)),
        "force_factor_tpm": ((tm, sm, r2, r, h, n, lr), tt + (T(n), T(lr))),
        "potential_factor_tpm": ((tm, sm, r2, r, h, n, lr),
                                 tt + (T(n), T(lr))),
    }
    for meth, (ja, ta) in calls.items():
        want = np.asarray(getattr(j, meth)(*ja))
        got = getattr(t, meth)(*ta).numpy()
        # the _tpm forms subtract the long-range term and can cancel to
        # near zero: an absolute floor of 1e-6 of the grid's largest value
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"{name}.{meth}")
    # Green's functions on a mesh-cell k grid, as the PM solver calls them
    k = np.fft.fftfreq(PMGRID) * PMGRID
    k2 = (k[:, None] ** 2 + k[None, :] ** 2).astype(np.float32)
    for meth in ("greens", "normed_greens"):
        want = np.asarray(getattr(j, meth)(k2, np.sqrt(k2)))
        got = getattr(t, meth)(T(k2), T(np.sqrt(k2))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=meth)
    jk, tk = j.kernel_shortrange(), t.kernel_shortrange()
    assert (jk is None) == (tk is None)
    if jk is not None:
        u = np.linspace(0.0, 3.5, 141).astype(np.float32)
        for jf, tf in zip(jk, tk):
            np.testing.assert_allclose(tf(T(u)).numpy(), np.asarray(jf(u)),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} shortrange")
    try:
        want = j.lattice_kind()
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            t.lattice_kind()
    else:
        assert t.lattice_kind() == want


@pytest.mark.parametrize("wiring,n_gravs,acc", [
    ("newton", 2, False), ("bam", 2, True), ("yukawa", 2, False),
    ("newton_yukawa", 2, False), ("coloyuk", 2, False),
    ("three_species", 3, False), ("three_species", 4, False)])
def test_preset_wirings_match(wiring, n_gravs, acc):
    kw = dict(n_gravs=n_gravs, type_to_grav=(0, 0, 1, 0, 0, 0),
              wiring=wiring, box_size=BOX, periodic=True, pmgrid=PMGRID,
              ngravs_accumulator=acc)
    jw = jwiring.build_wiring(jconfig.SimulationConfig(**kw))
    tw = twiring.build_wiring(tconfig.SimulationConfig(**kw))
    assert tw.names == jw.names and tw.accumulator == jw.accumulator
    np.testing.assert_array_equal(tw.pair_index_matrix(),
                                  jw.pair_index_matrix())
    assert [s for _, s in tw.unique_laws()] == \
        [s for _, s in jw.unique_laws()]
    assert [type(l).__name__ for l, _ in tw.unique_laws()] == \
        [type(l).__name__ for l, _ in jw.unique_laws()]


def test_wiring_errors_match():
    for wiring, ng in (("bam", 3), ("three_species", 2), ("nope", 2)):
        kw = dict(n_gravs=ng, wiring=wiring)
        with pytest.raises(ValueError):
            jwiring.build_wiring(jconfig.SimulationConfig(**kw))
        with pytest.raises(ValueError):
            twiring.build_wiring(tconfig.SimulationConfig(**kw))
