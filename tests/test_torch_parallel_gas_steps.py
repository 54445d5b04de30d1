"""The port's multi-device gas steps (`ngravs_tpu_torch/parallel/
full_sharded.py`, `full_let_sharded.py`) against JAX's, on gloo ranks on
the CPU and JAX's `make_mesh(2)`.

 * The replicated full step against JAX's `make_sharded_full_step`, and
   the LET full step against JAX's `make_let_full_step`, from one state on
   the same decomposition: the gas + halo box of tests/test_parallel.py:188
   at 512 gas + 512 halo, PMGRID 16, its rows in x order so that each rank
   holds a slab with gas (the LET step then ships ghosts).  JAX's own
   tolerances (tests/test_parallel.py:959-983): density and Hsml rtol
   2e-3, hydro acceleration within 3e-3 of its largest |a|, gravity rms
   2e-2 (JAX's replicated step takes the relative criterion with OldAcc
   zero, which opens every node; the port starts with a geometric pass),
   accel_pm within 1e-5 of its largest |a|.  The measured errors are
   printed.
 * `update_node_hmax` against JAX's `_update_node_hmax` on the same tree:
   every node's hmax equal.
 * The SPH passes' block and cap handling that the LET step relies on:
   `HydroSolver.split_level` keeps every target once, in order, with no
   block across a cell of the level it picks (cells of 2 blocks or more),
   and changes no density sum beyond f32 summation order; a frontier overflow grows the frontier cap, not
   the candidate cap, and ends as caps large enough from the start.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402
from test_parallel import _gas_halo_system  # noqa: E402

torch.set_num_threads(1)

SPH_FIELDS = ("density", "hsml", "hydro_accel")


def gas_box(n_gas=512, n_halo=512):
    """JAX's (cfg, particles, sph) of the gas + halo box, rows in x order
    (a slab a rank), the walk batched for the CPU."""
    cfg, p, sph = _gas_halo_system(n_gas=n_gas, n_halo=n_halo)
    cfg = dataclasses.replace(cfg, walk_batch_blocks=32)
    order = np.argsort(np.asarray(p.pos)[:, 0], kind="stable")
    take = lambda t: jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[order]),
                                  t)
    return cfg, take(p), take(sph)


def config_kw(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def write_state(tmp_path, p, sph, name="gas.npz") -> str:
    path = os.path.join(str(tmp_path), name)
    arr = {f: np.asarray(getattr(p, f)) for f in p.__dataclass_fields__}
    arr.update({f"s_{f}": np.asarray(getattr(sph, f))
                for f in sph.__dataclass_fields__})
    np.savez(path, **arr)
    return path


def rel_rms(a, ref):
    rel = np.linalg.norm(a - ref, axis=1) \
        / np.maximum(np.linalg.norm(ref, axis=1), 1e-12)
    return float(np.sqrt(np.mean(rel ** 2)))


def joined(outs, key):
    return np.concatenate([o[key] for o in outs])


def compare_gas_step(label, got: dict, want: dict, gas):
    """Hold one step's outputs (`accel`, `accel_pm` and the SPH fields,
    rows aligned) to JAX's tolerances; print the measured errors."""
    errs = {}
    for k in ("density", "hsml"):
        rel = np.abs(got[k][gas] - want[k][gas]) / np.abs(want[k][gas])
        errs[k] = float(rel.max())
        assert errs[k] < 2e-3, (label, k, errs[k])
    ha = want["hydro_accel"][gas]
    errs["hydro"] = float(np.abs(got["hydro_accel"][gas] - ha).max()
                          / np.abs(ha).max())
    assert errs["hydro"] < 3e-3, (label, errs)
    errs["gravity_rms"] = rel_rms(got["accel"], want["accel"])
    assert errs["gravity_rms"] < 2e-2, (label, errs)
    pm = want["accel_pm"]
    errs["accel_pm"] = float(np.abs(got["accel_pm"] - pm).max()
                             / np.abs(pm).max())
    assert errs["accel_pm"] < 1e-5, (label, errs)
    print(f"{label}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def _jax_full_steps(cfg, p, sph, n_dev):
    from ngravs_tpu.cosmology import make_tables
    from ngravs_tpu.models.wiring import build_wiring
    from ngravs_tpu.parallel.full_let_sharded import make_let_full_step
    from ngravs_tpu.parallel.full_sharded import make_sharded_full_step
    from ngravs_tpu.parallel.mesh import make_mesh, shard_particles
    from ngravs_tpu.units import set_units
    units = set_units(cfg)
    kit = (cfg, units, build_wiring(cfg), make_tables(cfg, units))
    mesh = make_mesh(n_dev)
    ps = shard_particles(p, mesh)
    sphs = jax.tree.map(lambda a: jax.device_put(a, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("shard"))), sph)
    nloc = ps.pos.shape[0] // n_dev
    out = {}
    for mode, step in (
            ("rep", make_sharded_full_step(
                *kit, mesh, n_local=nloc, node_list_cap=16384,
                leaf_list_cap=16384, leaf_factor=8.0, pm_step=True)),
            ("let", make_let_full_step(*kit, mesh, n_local=nloc,
                                       pm_step=True))):
        p2, s2, min_end, ovf, _, pm_end = step(ps, sphs, 0, 0,
                                               cfg.time_begin, 0, 0)
        assert not bool(ovf), mode
        p2, s2 = jax.device_get(p2), jax.device_get(s2)
        out[mode] = dict(accel=np.asarray(p2.accel),
                         accel_pm=np.asarray(p2.accel_pm),
                         meta=(int(min_end), int(pm_end)),
                         **{k: np.asarray(getattr(s2, k))
                            for k in SPH_FIELDS})
    return out


def test_full_steps_match_jax(tmp_path):
    cfg, p, sph = gas_box()
    want = _jax_full_steps(cfg, p, sph, 2)
    outs = R.run_ranks(R.full_steps, 2, tmp_path, config_kw(cfg),
                       write_state(tmp_path, p, sph), ("rep", "let"))
    gas = np.asarray(p.ptype) == 0
    for mode in ("rep", "let"):
        got = {k: joined(outs, f"{mode}_{k}")
               for k in SPH_FIELDS + ("accel", "pm")}
        got["accel_pm"] = got.pop("pm")
        compare_gas_step(f"{mode} vs JAX", got, want[mode], gas)
        meta = outs[0][f"{mode}_meta"]
        assert (int(meta[0]), int(meta[3])) == want[mode]["meta"], mode
        assert int(meta[1]) == len(gas)
    # the LET step shipped ghosts both ways, within its first caps
    for o in outs:
        retries, margin_reruns, rows_a, rows_b = o["let_stats"]
        assert rows_a > 0 and rows_b > 0 and retries == 0


def test_update_node_hmax_matches_jax():
    from ngravs_tpu.ops.tree import build_tree as jax_build
    from ngravs_tpu.parallel.full_sharded import _update_node_hmax
    from ngravs_tpu_torch.ops.tree import build_tree
    from ngravs_tpu_torch.parallel.full_sharded import update_node_hmax
    rng = np.random.default_rng(4)
    n, depth, bucket = 3000, 5, 8
    pos = np.concatenate([rng.uniform(0, 1, (n // 2, 3)),
                          rng.normal(0.5, 0.03, (n - n // 2, 3)) % 1.0])
    pos = pos.astype(np.float32)
    gas = rng.random(n) < 0.6
    hsml = np.where(gas, rng.uniform(0.01, 0.05, n), 0).astype(np.float32)
    args = (pos, np.full(n, 1.0 / n, np.float32), np.zeros(n, np.int32),
            np.full(n, 0.01, np.float32), np.zeros(n, np.float32))
    kw = dict(depth=depth, n_gravs=1, bucket=bucket, box_size=1.0)
    jt = jax_build(*map(jnp.asarray, args), hsml=jnp.asarray(hsml), **kw)
    pt = build_tree(*map(torch.as_tensor, args), hsml=torch.as_tensor(hsml),
                    **kw)
    np.testing.assert_array_equal(pt.order.numpy(), np.asarray(jt.order))
    new = np.where(gas, rng.uniform(0.005, 0.2, n), 0).astype(np.float32)
    new_s = new[np.asarray(jt.order)]
    want = np.asarray(_update_node_hmax(
        jt._replace(hsml_s=jnp.asarray(new_s)), depth, bucket).node_hmax)
    got = update_node_hmax(pt._replace(hsml_s=torch.as_tensor(new_s)),
                           depth, bucket).node_hmax.numpy()
    live = np.asarray(jt.node_pcount) > 0
    np.testing.assert_array_equal(got[live], want[live])
    np.testing.assert_array_equal(got[~live], 0.0)
    # and the refresh is not the build's hmax: the new lengths are seen
    assert (got[live] != pt.node_hmax.numpy()[live]).any()


def _sph_tree(n=1500, seed=8):
    """A periodic gas + halo box (a clump in one corner: its Morton run
    crosses cells unevenly), its octree with the smoothing lengths, and a
    particles view with every row active."""
    from types import SimpleNamespace
    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.ops.tree import build_tree
    from ngravs_tpu_torch.particles import SphState
    from ngravs_tpu_torch.units import set_units
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(0, 1, (n // 2, 3)),
                          rng.normal(0.1, 0.05, (n - n // 2, 3)) % 1.0])
    gas = rng.random(n) < 0.7
    cfg = SimulationConfig(periodic=True, box_size=1.0, des_num_ngb=32,
                           max_num_ngb_deviation=2, tree_depth=6,
                           tree_bucket_size=8, softening=(0.01,) * 6)
    # the mean spacing's guess (setup_smoothinglengths): a few iterations
    h0 = (3 * 32 / (4 * np.pi * gas.sum())) ** (1 / 3)
    h = np.where(gas, h0, 0.0).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tree = build_tree(t(pos), t(np.full(n, 1.0 / n)),
                      torch.zeros(n, dtype=torch.int32), t(np.full(n, 0.01)),
                      t(np.zeros(n)), hsml=t(h), depth=6, n_gravs=1,
                      bucket=8, box_size=1.0)
    sph = SphState.zeros(n, "cpu").replace(hsml=t(h),
                                           entropy=t(np.full(n, 0.05)))
    p = SimpleNamespace(ti_endstep=torch.zeros(n, dtype=torch.int32),
                        ti_begstep=torch.zeros(n, dtype=torch.int32),
                        pid=torch.arange(n, dtype=torch.int32), n=n)
    return cfg, set_units(cfg), tree, p, sph, int(gas.sum())


def test_split_blocks_stay_in_cells_and_change_no_sum():
    """`HydroSolver.split_level` (the LET step's target blocks): every
    active gas target once, in sorted order, no block across a cell of
    that level; the density pass gives the plain blocking's sums up to f32
    summation order (1e-6 relative)."""
    from ngravs_tpu_torch.ops.sph import HydroSolver
    cfg, units, tree, p, sph, n_gas = _sph_tree()
    plain, split = HydroSolver(cfg, units), HydroSolver(cfg, units)
    plain.cand_cap = split.cand_cap = 512      # grown where it overflows
    plain.split_level, split.split_level = None, 3
    level = split.split_level_for(n_gas)
    assert level == 1                         # 2 blocks a cell or more
    blocks = split._blocks(tree, p, 0, n_gas)
    flat = blocks.reshape(-1)
    got = flat[flat >= 0]
    want = torch.nonzero(tree.hsml_s > 0).squeeze(1).to(torch.int32)
    assert torch.equal(got, want)
    assert blocks.shape[0] <= n_gas // 64 + 8    # a partial block a cell
    cell = torch.clamp((tree.pos_s * 2 ** level).long(), 0, 2 ** level - 1)
    for b in blocks:
        c = cell[b[b >= 0].long()]
        assert len(c) == 0 or bool((c == c[0]).all())
    a = plain.density(tree, p, sph, 0, n_gas, 6, 1.0)
    b = split.density(tree, p, sph, 0, n_gas, 6, 1.0)
    gas = tree.order.new_tensor(np.arange(len(p.pid)))[sph.hsml > 0]
    for k in ("density", "hsml", "num_ngb"):
        x, y = getattr(a, k)[gas], getattr(b, k)[gas]
        assert float(((x - y).abs() / x.abs()).max()) < 1e-6, k


def test_frontier_overflow_grows_the_frontier_cap():
    """A neighbour walk whose frontier overflows grows the frontier cap,
    not the candidate cap, and the density pass ends as with caps large
    enough from the start."""
    from ngravs_tpu_torch.ops.sph import HydroSolver
    cfg, units, tree, p, sph, n_gas = _sph_tree()
    big, small = HydroSolver(cfg, units), HydroSolver(cfg, units)
    big.cand_cap = small.cand_cap = 512
    small.frontier_cap = 4
    a = big.density(tree, p, sph, 0, n_gas, 6, 1.0)
    b = small.density(tree, p, sph, 0, n_gas, 6, 1.0)
    assert small.trace.counts["sph.cap_growths"] >= 1 \
        and small.frontier_cap > 4
    assert small.cand_cap == big.cand_cap
    for k in ("density", "hsml", "num_ngb"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
