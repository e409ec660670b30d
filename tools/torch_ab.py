"""Two checkouts of the port on one card, in turns: the benchmark's cells
and chip_smoke.py's phase 17 (gradients and the train steps).

    python3 tools/torch_ab.py --parent DIR [--cells NAME[:PAIRS],...]
        [--phase17] [--seed 0] [--out build/ab]

``DIR`` is another checkout of the repo (for example the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists); this
file's own checkout is the change. Each cell runs ``PAIRS`` pairs (1 when
not given) of ``python3 -m benchmark.run --cell NAME --seed N``, one
process a run, from the root of each checkout: parent then change in even
pairs, change then parent in odd ones, so ``:2`` runs parent, change,
change, parent. One JSON line a run (its metrics, checks and launches),
then one a cell: each side's values of the cell's end-to-end metric, their
median and quartiles, the pairs the change won, each side's median of
every layer metric, whether ``kernel_launches`` repeated exactly within
each side, and whether every check passed. ``--phase17`` then runs
chip_smoke.py's ``gradient_phase`` of the parent and then of the change,
each in its own process on its own checkout's code (kernels built, rock100k
and rock1800k loaded as chip_smoke.py loads them), and prints each train
step's step over forward and ``indexing_backward*`` device ms. Every
process's output is kept in ``--out``; the last line is the card's name
and power limit. Exits 1 when a run failed. Needs one CUDA card and nvcc,
as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
END_TO_END = ("frame_ms", "step_ms")
ROCK1800K = os.path.join("tests", "scenes", "rock1800k.ply")


def last_json(text: str):
    """The last line of ``text`` as JSON, or None."""
    try:
        return json.loads(text.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        return None


def run_logged(cmd, cwd, stem):
    """Run ``cmd`` in ``cwd``, keep its output at ``stem``.out/.err;
    returns (return code, stdout)."""
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    with open(stem + ".out", "w") as f:
        f.write(proc.stdout)
    with open(stem + ".err", "w") as f:
        f.write(proc.stderr)
    return proc.returncode, proc.stdout


def quartiles(values):
    if len(values) < 2:
        return [values[0]] * 3
    return statistics.quantiles(values, n=4, method="inclusive")


def cell_pairs(roots, name, pairs, seed, out) -> bool:
    """``pairs`` pairs of runs of one cell; prints a line a run and the
    cell's summary line. Returns whether every run passed."""
    recs = {"parent": [], "change": []}
    ok = True
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            rc, stdout = run_logged(
                [sys.executable, "-m", "benchmark.run", "--cell", name,
                 "--seed", str(seed)], roots[side],
                os.path.join(out, f"{name}.{side}.pair{i + 1}"))
            rec = last_json(stdout)
            ok = ok and rc == 0 and rec is not None
            recs[side].append(rec)
            print(json.dumps({
                "cell": name, "side": side, "pair": i + 1, "rc": rc,
                "metrics": rec and rec["metrics"],
                "checks": rec and {k: c["passed"]
                                   for k, c in rec["checks"].items()},
                "launches": rec and rec["launches"]}), flush=True)
    if not all(recs["parent"] + recs["change"]):
        return False
    metric = next(m for m in END_TO_END
                  if m in recs["parent"][0]["metrics"])
    vals = {s: [r["metrics"][metric] for r in rs] for s, rs in recs.items()}
    wins = sum(c < p for p, c in zip(vals["parent"], vals["change"]))
    layer = {s: {k: statistics.median(r["metrics"][k] for r in rs)
                 for k, v in rs[0]["metrics"].items()
                 if isinstance(v, (int, float)) and k != metric}
             for s, rs in recs.items()}
    launches = {s: sorted({r["metrics"]["kernel_launches"] for r in rs})
                for s, rs in recs.items()}
    passed = all(c["passed"] for rs in recs.values() for r in rs
                 for c in r["checks"].values())
    print(json.dumps({
        "cell": name, "metric": metric, "pairs": pairs,
        "parent": vals["parent"], "change": vals["change"],
        "parent_median": statistics.median(vals["parent"]),
        "change_median": statistics.median(vals["change"]),
        "parent_quartiles": quartiles(vals["parent"]),
        "change_quartiles": quartiles(vals["change"]),
        "change_wins": wins, "layer_medians": layer,
        "kernel_launches": launches, "every_check_passed": passed}),
        flush=True)
    return ok and passed


def phase17_here(root: str) -> int:
    """chip_smoke.py's phase 17 on ``root``'s code, in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.ops import bvh_traverse as bt
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.scene import assets
    from raytracer795_tpu_torch.scene.loader import load_scene

    dev = torch.device("cuda", 0)
    bt.build_kernels()
    rock = load_scene(os.path.join(cs.SCENES, "rock100k.xml"), dev)
    nu, nv = assets.ROCK1800K_GRID
    assets.ensure_rock(os.path.join(root, ROCK1800K), nu, nv)
    big = load_scene(os.path.join(cs.SCENES, "rock1800k.xml"), dev)
    cs.gradient_phase(render, bt, intersect, load_scene, dev, cs.card_line(),
                      rock, big)
    return 0


def step_lines(stdout: str):
    """Each train step's scene, step over forward and indexing_backward*
    device ms (summed from the profile's costliest kernels where the
    checkout does not print it)."""
    out = []
    for ln in stdout.splitlines():
        if not ln.startswith("{"):
            continue
        rec = json.loads(ln)
        if rec.get("phase") != "train_step":
            continue
        prof = rec["step_profile"]
        ib = rec.get("indexing_backward_ms", sum(
            ms for k, ms in prof["top_kernels_ms"].items()
            if "indexing_backward" in k))
        out.append({"scene": rec["scene"],
                    "step_median_s": rec["step_median_s"],
                    "forward_median_s": rec["forward_median_s"],
                    "step_over_forward": rec["step_over_forward"],
                    "indexing_backward_ms": ib,
                    "kernel_ms": prof["kernel_ms"],
                    "kernels_run": prof["kernels_run"],
                    "max_memory_allocated_mb":
                        rec["max_memory_allocated_mb"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the parent's checkout")
    ap.add_argument("--cells", default="",
                    help="comma-separated NAME[:PAIRS] (PAIRS 1 if not given)")
    ap.add_argument("--phase17", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "ab"))
    ap.add_argument("--phase17-here", metavar="ROOT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase17_here:
        return phase17_here(args.phase17_here)
    if not args.parent:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    roots = {"parent": os.path.abspath(args.parent), "change": REPO}
    os.makedirs(args.out, exist_ok=True)
    ok = True
    for item in filter(None, args.cells.split(",")):
        name, _, pairs = item.partition(":")
        ok = cell_pairs(roots, name, int(pairs or 1), args.seed,
                        args.out) and ok
    if args.phase17:
        for side in ("parent", "change"):
            # the generated rock1800k PLY, made once for both checkouts
            have = [r for r in roots.values()
                    if os.path.exists(os.path.join(r, ROCK1800K))]
            dst = os.path.join(roots[side], ROCK1800K)
            if have and not os.path.exists(dst):
                shutil.copyfile(os.path.join(have[0], ROCK1800K), dst)
            rc, stdout = run_logged(
                [sys.executable, os.path.abspath(__file__),
                 "--phase17-here", roots[side]], roots[side],
                os.path.join(args.out, f"phase17.{side}"))
            ok = ok and rc == 0
            print(json.dumps({"phase17": side, "rc": rc,
                              "steps": step_lines(stdout)}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
