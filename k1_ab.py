"""Time the pair kernel K1 against the one-thread-per-target K1 on one GPU.

    python3 k1_ab.py --parent PATH/pairwise.cu

`--parent` names the `ngravs_tpu_torch/csrc/pairwise.cu` of commit a644a2f,
the first design of K1 (one thread per target, no launch plan).  Unpack it
with `git archive a644a2f ngravs_tpu_torch/csrc/pairwise.cu | tar -x -C
DIR`.  Only that C interface is loaded.  A source that declares
`NgravsPlan` has this tree's interface and is refused.  The parent is
built with the same nvcc flags as this tree's kernel.

Inputs: chip_smoke.py's synthetic walk-shaped cases (K1a and its K1_CASES,
potential off and on, B=128 blocks of G=64 targets, S=4096), then the
largest launch of each of chip_smoke.py's two paths.  To get those, the
script runs both paths as chip_smoke.py does, with their gates.  On each
input both kernels are held against the twin at chip_smoke's RTOL_TERMS
with the pair counts equal, and this tree's kernel must give the same bits
twice.  The two are timed in turns (parent, this,
this, parent; CUDA events, median of 20 launches each).  Each line gives
both times, their ratio, the pair rate, the bound (chip_smoke.kernel_bound)
and the launch plan.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

import chip_smoke as cs
from ngravs_tpu_torch.ops import pairwise as pw


def parent_library(src: str):
    """The parent's kernel, built from `src`, with its C interface: the law
    table followed by three floats, no launch plan."""
    with open(src) as f:
        if "NgravsPlan" in f.read():
            raise SystemExit(f"k1_ab: {src} takes a launch plan; --parent "
                             "must be the one-thread-per-target source of "
                             "commit a644a2f")
    lib = ctypes.CDLL(pw.build_library(src=src))
    fn = lib.ngravs_pairwise
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(pw._LawTable)]
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4)
    return lib


def parent_eval(lib, targets, sp, n_src, want_pot, kw):
    flags = pw.instance_flags(want_pot=want_pot, **kw)
    table = pw.law_table(kw["wiring"]) if flags & pw.F_MULTI else None
    nb, _, s = sp.shape
    bg = targets["x"].shape[0]
    box, asmth = kw.get("box_size", 0.0), kw.get("treepm_asmth", 0.0)
    acc = torch.empty(bg, 3, dtype=torch.float32, device=sp.device)
    pot = torch.zeros(bg, dtype=torch.float32, device=sp.device)
    nia = torch.empty(bg, dtype=torch.int32, device=sp.device)
    err = lib.ngravs_pairwise(
        *(targets[k].data_ptr() for k in ("x", "y", "z", "mass", "grav",
                                          "fsoft", "gid")),
        sp.data_ptr(), n_src.data_ptr(), nb, bg // nb, s, flags,
        ctypes.byref(table) if table is not None else None,
        box, 1.0 / box if box > 0 else 0.0,
        0.5 / asmth if asmth > 0 else 0.0, acc.data_ptr(),
        pot.data_ptr() if want_pot else None, nia.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"parent kernel launch failed: cudaError {err}")
    return acc, pot, nia


def check(label, who, out, ref, scale, want_pot):
    acc, pot, nia = out
    acc_t, pot_t, nia_t = ref
    bad = bool(((acc - acc_t).abs() > cs.RTOL_TERMS * scale[:, :3]).any())
    if want_pot:
        bad |= bool(((pot - pot_t).abs() > cs.RTOL_TERMS * scale[:, 3]).any())
    if bad or not torch.equal(nia, nia_t):
        raise AssertionError(f"{label}: the {who} kernel disagrees with the "
                             "twin")
    return float((acc - acc_t).abs().max())


def inputs(dev, card: str):
    """(label, targets, sp, n_src, want_pot modes, kw) of every input."""
    yield "K1a synthetic", *cs.kernel_inputs(dev), (False, True), {}
    for i, case in enumerate(cs.K1_CASES):
        w, kw = cs.case_wiring(case)
        yield (f"{case} synthetic",
               *cs.kernel_inputs(dev, seed=10 + i, n_gravs=w.n_gravs,
                                 box=kw["box_size"],
                                 count=kw["accumulator"]),
               (False, True), kw)
    for label, path in (("slice 1 path's largest launch", cs.galaxy_path),
                        ("box path's largest launch", cs.box_path)):
        targets, sp, n_src, want_pot, kw = cs.largest_launch(
            path(dev, card)[1])
        yield label, targets, sp, n_src, (want_pot,), kw


def compare(parent, label, targets, sp, n_src, modes, kw) -> None:
    scale, ops = cs.term_scales(targets, sp, n_src, **kw)
    group = targets["x"].shape[0] // sp.shape[0]
    for want_pot in modes:
        flags = pw.instance_flags(want_pot=want_pot, **kw)
        name = pw.instance_name(flags)
        plan = pw.launch_plan(group, sp.shape[2], flags)
        run_new = lambda: pw.pairwise_eval(targets, sp, n_src, want_pot,
                                           **kw)
        run_old = lambda: parent_eval(parent, targets, sp, n_src, want_pot,
                                      kw)
        ref = pw.pairwise_eval_torch(targets, sp, n_src, want_pot, **kw)
        new = run_new()
        if not cs.same_bits(new, run_new()):
            raise AssertionError(f"{label}: {name} gave other bits on a "
                                 "second launch")
        err_new = check(label, "new", new, ref, scale, want_pot)
        err_old = check(label, "parent", run_old(), ref, scale, want_pot)
        t = [cs.cuda_ms(f, 20) for f in (run_old, run_new, run_new,
                                         run_old)]
        old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        bound_ms, bound_by = cs.kernel_bound(targets, sp, n_src, flags,
                                             ops[1 if want_pot else 0])
        pairs = int(ref[2].sum())
        print(f"A/B {label}: {name} {tuple(sp.shape)}: parent {old_ms:.4f} "
              f"ms ({t[0]:.4f}, {t[3]:.4f}), this {new_ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), {old_ms / new_ms:.2f}x; "
              f"{pairs} pairs, {pairs / new_ms / 1e6:.1f} Gpair/s; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / new_ms:.1%} of "
              f"it); max|dacc| vs twin {err_new:.3g} (parent "
              f"{err_old:.3g}); plan {tuple(plan)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="commit a644a2f's csrc/pairwise.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    pw.build_library()
    parent = parent_library(args.parent)
    for label, *rest in inputs(dev, card):
        compare(parent, label, *rest)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
