"""The port's LET gas step (`ngravs_tpu_torch/parallel/full_let_sharded.py`)
against its replicated gas step and against itself, on gloo ranks on the
CPU.

 * The LET full step against the replicated full step at 2 and 4 ranks
   (the scheme of tests/test_parallel.py:916, JAX's tolerances: density
   and Hsml rtol 2e-3, hydro within 3e-3 of its largest |a|, gravity rms
   2e-2, accel_pm 1e-5 of max), the gas + halo box of :188 in x slabs.
 * The ghost sums culled per chunk of targets equal the dense sums over
   every ghost row (up to f32 summation order: 1e-5 of each target's sum
   of |terms|), for the density and the hydro pass, on a clumped periodic
   system with smoothing lengths spread over a factor of 5.
 * A step whose ghost cap (8 rows) and ghost margin (0.5) overflow
   recovers: the cap grows, the density iteration reruns with a wider
   margin, and the result equals, bit for bit, that of a step whose cap
   and margin were large enough from the start.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402
from test_torch_parallel_gas_steps import (SPH_FIELDS, compare_gas_step,  # noqa: E402
                                           config_kw, gas_box, joined,
                                           write_state)

torch.set_num_threads(1)


def _outputs(outs, name):
    got = {k: joined(outs, f"{name}_{k}") for k in SPH_FIELDS + ("accel",)}
    got["accel_pm"] = joined(outs, f"{name}_pm")
    return got


@pytest.mark.parametrize("k", [2, 4])
def test_let_full_step_matches_replicated(k, tmp_path):
    cfg, p, sph = gas_box()
    outs = R.run_ranks(R.full_steps, k, tmp_path, config_kw(cfg),
                       write_state(tmp_path, p, sph), ("rep", "let"))
    gas = np.asarray(p.ptype) == 0
    compare_gas_step(f"LET vs replicated, {k} ranks", _outputs(outs, "let"),
                     _outputs(outs, "rep"), gas)
    np.testing.assert_array_equal(outs[0]["let_meta"], outs[0]["rep_meta"])
    assert all(o["let_stats"][2] > 0 for o in outs)


def _clumped(seed=3, n_t=700, n_g=1500, box=1.0):
    rng = np.random.default_rng(seed)
    t = np.concatenate([rng.normal(0.3, 0.08, (n_t // 2, 3)),
                        rng.uniform(0, box, (n_t - n_t // 2, 3))]) % box
    # targets in cell order, as a tree's sorted targets come: a chunk of
    # them is compact
    cell = (t * 8 / box).astype(int)
    t = t[np.lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))]
    g = np.concatenate([rng.normal(0.3, 0.1, (n_g // 2, 3)),
                        rng.uniform(0, box, (n_g - n_g // 2, 3))]) % box
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
    h_t = torch.as_tensor(0.01 * 10 ** rng.uniform(0, 0.7, n_t),
                          dtype=torch.float32)
    ghosts = torch.cat([torch.as_tensor(g, dtype=torch.float32), f(n_g, 3),
                        torch.full((n_g, 1), 1e-3),
                        torch.as_tensor(0.01 * 10 ** rng.uniform(0, 0.7, n_g),
                                        dtype=torch.float32)[:, None],
                        torch.as_tensor(rng.uniform(0.5, 2, (n_g, 5)),
                                        dtype=torch.float32)], dim=1)
    valid = torch.as_tensor(rng.random(n_t) < 0.9)
    return (torch.as_tensor(t, dtype=torch.float32), f(n_t, 3), h_t, valid,
            ghosts, rng)


def _close(a, b, scale):
    assert float((a - b).abs().max() / scale) < 1e-5, \
        float((a - b).abs().max() / scale)


def test_culled_ghost_sums_equal_dense():
    from ngravs_tpu_torch.ops.sph import K3D
    from ngravs_tpu_torch.parallel.full_let_sharded import (GA_F,
                                                            ghost_density,
                                                            ghost_hydro)
    tpos, tvel, h, valid, ghosts, rng = _clumped()
    box3 = (1.0, 1.0, 1.0)
    # small chunks: most of them see a few of the rows
    kw = dict(kernel=K3D, box3=box3, tchunk=64)
    dense = ghost_density(tpos, tvel, h, valid, ghosts[:, :GA_F],
                          culled=False, **kw)
    culled = ghost_density(tpos, tvel, h, valid, ghosts[:, :GA_F], **kw)
    assert float(dense[1].max()) > 0          # pairs inside the kernel
    for d, c in zip(dense, culled):
        _close(c, d, d.abs().max() + 1e-30)
    tgt = dict(pos=tpos, vel=tvel, h=h, valid=valid,
               rho=torch.as_tensor(rng.uniform(0.5, 2, len(h)),
                                   dtype=torch.float32),
               pterm=torch.full_like(h, 0.7), cs=torch.full_like(h, 1.1),
               f1=torch.full_like(h, 0.3), dt=torch.full_like(h, 0.01),
               mass=torch.full_like(h, 1e-3))
    hkw = dict(facs=(1.0, 1.0, 0.0), visc_const=0.8, use_limiter=True,
               kernel=K3D, box3=box3, tchunk=64)
    dense = ghost_hydro(tgt, ghosts, culled=False, **hkw)
    culled = ghost_hydro(tgt, ghosts, **hkw)
    assert float(dense[2].max()) > 0
    for d, c in zip(dense, culled):
        _close(c, d, d.abs().max() + 1e-30)
    # the culling kept a small part of the rows a chunk
    from ngravs_tpu_torch.parallel.full_let_sharded import cull
    lists = cull(tpos, h, valid, ghosts[:, 0:3], None, box3, 64)
    assert sum(len(x) for x in lists) < len(lists) * len(ghosts) / 2


def test_ghost_overflows_recover(tmp_path):
    cfg, p, sph = gas_box()
    big = dict(caps=dict(ghost=1 << 20, margin=4.0))
    outs = R.run_ranks(R.full_steps, 2, tmp_path, config_kw(cfg),
                       write_state(tmp_path, p, sph), (
                           ("small", "let", dict(caps=dict(ghost=8,
                                                           margin=0.5))),
                           ("big", "let", big)))
    for o in outs:
        retries, reruns = o["small_stats"][:2]
        assert retries >= 1 and reruns >= 1, o["small_stats"]
        assert o["small_caps"][0] > 8 and o["small_caps"][1] > 0.5
        np.testing.assert_array_equal(o["big_stats"][:2], [0, 0])
        for k in SPH_FIELDS + ("accel", "vel", "entropy", "vel_pred",
                               "num_ngb", "dt_entropy", "max_signal_vel"):
            np.testing.assert_array_equal(o[f"small_{k}"], o[f"big_{k}"],
                                          err_msg=k)
        np.testing.assert_array_equal(o["small_meta"], o["big_meta"])

