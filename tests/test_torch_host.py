"""Host layer of the PyTorch port against the JAX package: configuration,
units, snapshot I/O, force laws, wiring, timeline tables, diagnostics — and
the rule that the port imports neither JAX nor the JAX package."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from ngravs_tpu import config as jconfig
from ngravs_tpu import units as junits
from ngravs_tpu.cosmology import make_tables as j_make_tables
from ngravs_tpu.diagnostics.energy import \
    compute_global_quantities as j_globals
from ngravs_tpu.io import gadget_format as jio
from ngravs_tpu.models import laws as jlaws
from ngravs_tpu.models import wiring as jwiring
from ngravs_tpu.particles import Particles as JParticles

from ngravs_tpu_torch import config as tconfig
from ngravs_tpu_torch import units as tunits
from ngravs_tpu_torch.cosmology import make_tables as t_make_tables
from ngravs_tpu_torch.diagnostics.energy import \
    compute_global_quantities as t_globals
from ngravs_tpu_torch.interop import (config_from_dict, particles_from_numpy,
                                      particles_to_numpy)
from ngravs_tpu_torch.io import gadget_format as tio
from ngravs_tpu_torch.models import laws as tlaws
from ngravs_tpu_torch.models import wiring as twiring

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ngravs_tpu_torch")

PARAMS = """% synthetic parameterfile: every kind of tag
InitCondFile      ./ic.dat       ; comment
OutputDir         ./out
SnapshotFileBase  snap
ICFormat          2
SnapFormat        1
TimeBegin         0.5
TimeMax           3.25
Omega0            0.3
OmegaLambda       0.7
HubbleParam       0.7
BoxSize           0
TimeBetSnapshot   0.05
TimeOfFirstSnapshot 0.1
TimeBetStatistics 0.02
ErrTolIntAccuracy 0.02
MaxSizeTimestep   0.015
ErrTolTheta       0.6
TypeOfOpeningCriterion 1
ErrTolForceAcc    0.004
TreeDomainUpdateFrequency 0.2
UnitLength_in_cm  3.085678e21
UnitMass_in_g     1.989e43
UnitVelocity_in_cm_per_s 1e5
GravityConstantInternal 0
MinGasTemp        20
ComputePotentialEnergy 1
SofteningGas 0.1
SofteningHalo 1.5
SofteningDisk 0.4
SofteningBulge 0.8
SofteningStars 0.3
SofteningBndry 2.0
SofteningHaloMaxPhys 1.2
GravityGas   0
GravityHalo  0
GravityDisk  1
GravityBulge 0
GravityStars 1
GravityBndry 0
"""


def _cfg_pair(tmp_path, **overrides):
    path = tmp_path / "run.param"
    path.write_text(PARAMS)
    return (jconfig.read_parameter_file(str(path), **overrides),
            tconfig.read_parameter_file(str(path), **overrides))


def test_config_and_units_parity(tmp_path):
    jc, tc = _cfg_pair(tmp_path, tree_depth=12, direct_crossover=1000)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.type_to_grav == (0, 0, 1, 0, 1, 0) and tc.n_gravs == 2
    assert tc.tree_depth == 12 and tc.compute_potential_energy
    assert dataclasses.asdict(junits.set_units(jc)) \
        == dataclasses.asdict(tunits.set_units(tc))
    # the interop route builds the same config from the JAX fields
    assert config_from_dict(dataclasses.asdict(jc)) == tc


def test_config_rejects_like_the_reference(tmp_path):
    path = tmp_path / "bad.param"
    path.write_text(PARAMS + "NotATag 1\n")
    with pytest.raises(ValueError, match="NotATag"):
        tconfig.read_parameter_file(str(path))
    with pytest.raises(ValueError):
        tconfig.SimulationConfig(type_to_grav=(0, 2, 0, 0, 0, 0), n_gravs=2)


def test_write_usedvalues_parity(tmp_path):
    jc, tc = _cfg_pair(tmp_path)
    jconfig.write_usedvalues(jc, str(tmp_path / "j-usedvalues"))
    tconfig.write_usedvalues(tc, str(tmp_path / "t-usedvalues"))
    assert (tmp_path / "j-usedvalues").read_text() \
        == (tmp_path / "t-usedvalues").read_text()


def _snapshot(mod, seed=5):
    rng = np.random.default_rng(seed)
    npart = np.array([3, 7, 5, 0, 4, 2], np.int32)
    n = int(npart.sum())
    h = mod.SnapshotHeader()
    h.npart = npart
    h.npart_total = npart.astype(np.uint32)
    h.mass = np.array([0.0, 0.5, 0.0, 0.0, 0.25, 0.0])
    h.time = 0.75
    mass = rng.uniform(0.1, 1, n).astype(np.float32)
    ptype = np.repeat(np.arange(6, dtype=np.int32), npart)
    for t in (1, 4):
        mass[ptype == t] = h.mass[t]
    return mod.SnapshotData(
        header=h, pos=rng.normal(size=(n, 3)).astype(np.float32),
        vel=rng.normal(size=(n, 3)).astype(np.float32),
        pid=np.arange(10, 10 + n, dtype=np.uint32), mass=mass, ptype=ptype,
        u=rng.uniform(size=3).astype(np.float32),
        rho=rng.uniform(size=3).astype(np.float32),
        hsml=rng.uniform(size=3).astype(np.float32),
        pot=rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("fmt", [1, 2])
@pytest.mark.parametrize("writer,reader", [(jio, tio), (tio, jio)])
def test_snapshot_round_trip(tmp_path, fmt, writer, reader):
    data = _snapshot(writer)
    path = str(tmp_path / f"snap_{fmt}")
    writer.write_snapshot(path, data, snap_format=fmt)
    back = reader.read_snapshot(path, expect_format=fmt)
    for name in ("pos", "vel", "pid", "mass", "ptype", "u", "rho", "hsml",
                 "pot"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(data, name), err_msg=name)
    np.testing.assert_array_equal(back.header.npart, data.header.npart)
    np.testing.assert_array_equal(back.header.mass, data.header.mass)
    assert back.header.time == data.header.time


def _grid():
    """r x h grid covering r < h/2, h/2 <= r < h, r >= h and r = 0."""
    r = np.concatenate([[0.0], np.geomspace(1e-3, 30.0, 41)])
    h = np.array([0.05, 0.4, 2.8, 7.0])
    rr, hh = (a.astype(np.float32) for a in np.meshgrid(r, h))
    sm = np.float32(1.7)
    tm = np.float32(0.9)
    return tm, sm, rr * rr, rr, hh


def test_newton_law_methods_match():
    tm, sm, r2, r, h = _grid()
    j, t = jlaws.Newtonian(), tlaws.Newtonian()
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tt = T(tm), T(sm), T(r2), T(r), T(h)
    calls = {
        "accel": ((tm, sm, r2, r, 1), (tt[0], tt[1], tt[2], tt[3], 1)),
        "spline": ((tm, sm, h, r, 1), (tt[0], tt[1], tt[4], tt[3], 1)),
        "potential": ((tm, sm, r2, r, 1), (tt[0], tt[1], tt[2], tt[3], 1)),
        "spline_pot": ((tm, sm, h, r, 1), (tt[0], tt[1], tt[4], tt[3], 1)),
        "force_factor": ((tm, sm, r2, r, h, 1), tt + (1,)),
        "potential_factor": ((tm, sm, r2, r, h, 1), tt + (1,)),
        "force_factor_tpm": ((tm, sm, r2, r, h, 1, np.float32(0.3)),
                             tt + (1, T(0.3))),
        "potential_factor_tpm": ((tm, sm, r2, r, h, 1, np.float32(0.3)),
                                 tt + (1, T(0.3))),
        "greens": ((r2, r), (tt[2], tt[3])),
        "normed_greens": ((r2, r), (tt[2], tt[3])),
    }
    for name, (ja, ta) in calls.items():
        want = np.asarray(getattr(j, name)(*ja))
        got = getattr(t, name)(*ta).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=name)
    u = r / 7.0
    for jf, tf in zip(j.kernel_shortrange(), t.kernel_shortrange()):
        np.testing.assert_allclose(tf(T(u)).numpy(), np.asarray(jf(u)),
                                   rtol=1e-6)
    assert j.lattice_kind() == t.lattice_kind()


def test_stock_wiring_parity():
    jc = jconfig.SimulationConfig(n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0))
    tc = tconfig.SimulationConfig(n_gravs=2, type_to_grav=(0, 0, 1, 0, 0, 0))
    jw, tw = jwiring.build_wiring(jc), twiring.build_wiring(tc)
    assert len(tw.unique_laws()) == 1 and tw.names == jw.names
    np.testing.assert_array_equal(tw.pair_index_matrix(),
                                  jw.pair_index_matrix())
    # the multi-law presets build now (tests/test_torch_laws.py holds them
    # against the JAX wirings)
    assert len(twiring.build_wiring(
        tc.replace(wiring="newton_yukawa")).unique_laws()) == 2
    asym = twiring.GravityWiring([[tlaws.Newtonian(), tlaws.Newtonian()],
                                  [tlaws.ForceLaw(), _Doubled()]])
    asym.laws[0][1] = _Doubled()
    with pytest.raises(ValueError, match="3rd law"):
        asym.check_l3_symmetry()


class _Doubled(tlaws.Newtonian):
    def accel(self, tm, sm, r2, r, n):
        return 2 * super().accel(tm, sm, r2, r, n)


def test_linear_tables_parity():
    jc = jconfig.SimulationConfig(time_begin=0.1, time_max=2.3)
    tc = tconfig.SimulationConfig(time_begin=0.1, time_max=2.3)
    ti = np.array([0, 1, 3, 1 << 20, (1 << 28) - 1, 1 << 28], np.int32)
    jt = j_make_tables(jc, junits.set_units(jc))
    tt = t_make_tables(tc, tunits.set_units(tc))
    want = np.asarray(jt.gravkick_factor(ti[:-1], ti[1:]))
    got = tt.gravkick_factor(torch.as_tensor(ti[:-1]),
                             torch.as_tensor(ti[1:])).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(tt.drift_factor(5, 1 << 27)) \
        == float(jt.drift_factor(5, 1 << 27))


def test_global_quantities_parity():
    rng = np.random.default_rng(2)
    n = 50
    cfg = jconfig.SimulationConfig()
    jp = JParticles.create(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)),
                           rng.uniform(0.1, 1, n), np.arange(n),
                           rng.integers(1, 6, n), cfg.type_to_grav)
    jp = jp.replace(
        accel=jp.accel + np.float32(rng.normal(size=(n, 3))),
        potential=jp.potential + np.float32(rng.normal(size=n)),
        ti_begstep=jp.ti_begstep + 64, ti_endstep=jp.ti_endstep + 192)
    arrays = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    tp = particles_from_numpy(arrays, "cpu")
    back = particles_to_numpy(tp)
    assert back.keys() == arrays.keys()
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype, name
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    tabs = j_make_tables(cfg, junits.set_units(cfg))
    js = j_globals(cfg, jp, None, tabs, 200)
    ts = t_globals(tp, t_make_tables(cfg, None), 200)
    for name in js._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=2e-6, atol=1e-6, err_msg=name)


def test_port_modules_import_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports with `jax` and
    `ngravs_tpu` made unimportable (a fresh interpreter)."""
    import subprocess
    import sys
    root = os.path.dirname(PKG)
    mods = sorted(
        "ngravs_tpu_torch." + os.path.relpath(os.path.join(d, f), PKG)
        [:-3].replace(os.sep, ".").replace(".__init__", "")
        for d, _, files in os.walk(PKG) for f in files if f.endswith(".py"))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'ngravs_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.replace('.__init__', ''))\n"
            "importlib.import_module('chip_smoke')\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'ngravs_tpu.'))"
            " for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(" + repr(mods) + "))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    assert "ngravs_tpu_torch.ops.pm" in mods and len(mods) > 20


def test_port_imports_no_jax():
    bad = re.compile(r"import\s+jax|from\s+jax|ngravs_tpu\.|"
                     r"(import|from)\s+ngravs_tpu\b(?!_)")
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if bad.search(line) or "import jax" in line:
                            offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders
