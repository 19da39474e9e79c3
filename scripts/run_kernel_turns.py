#!/usr/bin/env python3
"""Time the sorted-run kernels of several checkouts in turns on one card.

    python3 scripts/run_kernel_turns.py build/parent . . build/parent

Each argument is the root of a checkout: this one (``.``), or another
unpacked under a directory that .gitignore lists, e.g.
``mkdir -p build/parent && git archive <commit> | tar -x -C build/parent``.
Each turn runs, in its own process and from its own root, that checkout's
chip_smoke.py phases up to the run kernels (device, build, the served
kernels, the data, the run kernels at the trained shape, every check of
those phases included) and prints one line

    turn <i> <root>: {"edge_mpnn_runs": {...}, "segment_pool_runs": {...}}

(after a line with the card's name and power limit) with each kernel's
device µs (whole, and by device kernel) and device kernels and memsets
per call (torch.profiler), its CUDA-event ms, and the bf16 edge call's
device µs.
Run it from the repository root on a machine with one CUDA card; it
exits non-zero when a turn fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

KEYS = ("device_us", "device_us_by_name", "device_kernels", "memsets", "ms",
        "bf16_device_us", "host_us")

TURN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch
import chip_smoke as c
c.device_phase(torch)
report = c.build_phase()
records = c.kernels_phase(torch, report)
first = c.load_data()[-1]
c.runs_kernels_phase(torch, first, records, report)
keys = json.loads(sys.argv[1])
print("RESULT " + json.dumps({name: {k: records[name].get(k) for k in keys}
                              for name in ("edge_mpnn_runs",
                                           "segment_pool_runs")}))
"""


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__)
        return 2
    for i, root in enumerate(roots):
        done = subprocess.run(
            [sys.executable, "-c", TURN, json.dumps(KEYS)],
            cwd=os.path.abspath(root), capture_output=True, text=True,
            timeout=900)
        lines = done.stdout.splitlines()
        result = [ln for ln in lines if ln.startswith("RESULT ")]
        if done.returncode or not result:
            print(f"turn {i} {root}: FAIL (exit {done.returncode})\n"
                  + "\n".join(lines[-20:]) + done.stderr[-4000:], flush=True)
            return 1
        # the card's name and power limit (nvidia-smi, chip_smoke.py's
        # first line), then the run kernels' text lines
        print(f"turn {i} {root}: card {lines[0]}", flush=True)
        for ln in lines:
            if ln.startswith("[kernels] edge_mpnn_runs") \
                    or ln.startswith("[kernels] segment_pool_runs sorted"):
                print(f"turn {i} {root}: {ln}", flush=True)
        print(f"turn {i} {root}: {result[0].removeprefix('RESULT ')}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
