"""Summarize a run's phase timers (port of ``tools/report_phases.py``).
Reads every metrics.jsonl under the log folder and prints one JSON line
with the JAX tool's keys: the wall between the first and last scalar,
the bootstrap's share, each view's expansion wall, the host-side
(device-idle) seconds and the whole phase table.

  python -m text2nerf_tpu_torch.tools.report_phases <run>/log [--report FILE]

It reads logs only and touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _wall(logdir: str) -> float:
    t_min = t_max = None
    for root, _, files in os.walk(logdir):
        for fn in files:
            if fn != "metrics.jsonl":
                continue
            with open(os.path.join(root, fn)) as f:
                for line in f:
                    try:
                        t = json.loads(line).get("t")
                    except ValueError:
                        continue
                    if t is not None:
                        t_min = t if t_min is None else min(t_min, t)
                        t_max = t if t_max is None else max(t_max, t)
    return (t_max - t_min) if t_min is not None else 0.0


def main(argv=None) -> int:
    from ..parallel.scene_farm import collect_phase_times, device_idle_seconds

    p = argparse.ArgumentParser()
    p.add_argument("logdir")
    p.add_argument("--report", default="")
    args = p.parse_args(argv)

    phases = collect_phase_times(args.logdir)
    wall = _wall(args.logdir)
    expand = {k: v for k, v in phases.items() if k.startswith("expand_view")}
    boot = sum(v for k, v in phases.items() if k == "bootstrap")
    out = {
        "logdir": args.logdir,
        "wall_s": round(wall, 1),
        "bootstrap_s": round(boot, 1),
        "bootstrap_share": round(boot / wall, 4) if wall else None,
        "expand_views_s": {k: round(v, 1) for k, v in sorted(expand.items())},
        "host_idle_proxy_s": round(device_idle_seconds(phases), 1),
        "phases_s": {k: round(v, 1) for k, v in sorted(phases.items())},
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.report:
        with open(args.report, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
