"""Phase 9a of chip_smoke.py (slice 1's 60k open box, segments against
single stepping) over several IC seeds and segment caps, on one GPU.

    python3 segment_study.py [--seeds 7 8 9] [--caps 4 16]

Each pair of runs goes through chip_smoke.segment_pair with its gates off:
every comparison is printed (the particles in another timestep bin, the
least bin-edge distance of their kicks since the runs last agreed on
them, positions, velocities, and the forces of the particles both runs
kicked there against the direct sweep), and the drifted-tables pass
follows.  The closing lines give, for each seed and cap, the readings
that chip_smoke's SEG_FLIPS, SEG_EDGE, SEG_FORCE_MAX and MAX_TREE gate.
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--caps", type=int, nargs="+", default=[4, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    out = []
    for seed in args.seeds:
        for cap in args.caps:
            rows, ((rms, mx), (rms_b, mx_b)) = cs.open_box_segments(
                "cuda", card, seed=seed, cap=cap, gates=False)
            kicked = [r for r in rows if r["n_kicked"]]
            out.append(dict(
                seed=seed, cap=cap, comparisons=len(rows),
                timeline_equal=all(r["same"] for r in rows),
                max_parted=max(r["n_diff"] for r in rows),
                max_edge=max(r["edge"] for r in rows),
                max_dpos=max(r["dpos"] for r in rows),
                max_dvel=max(r["dvel"] for r in rows),
                seg_rms=max(r["err_seg"][0] for r in kicked),
                seg_max_over_single_max=max(
                    r["err_seg"][1] for r in kicked) / max(
                    r["err_single"][1] for r in kicked),
                worst_comparison_ratio=max(
                    r["err_seg"][1] / r["err_single"][1] for r in kicked),
                max_dacc_kicked=max(r["dacc"] for r in kicked),
                max_dacc_all=max(r["dacc_all"][0] for r in rows),
                drifted=(rms, mx), rebuilt=(rms_b, mx_b)))
            print(f"summary [{card}]: {json.dumps(out[-1])}", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
