#!/usr/bin/env python3
"""How completely torch.profiler records K15's launches on a CUDA card.

    python3 tools/micro_trace.py [WINDOWS]

Phase 11 of ``chip_smoke.py`` reads K15's stage times from the complete
calls that a profiler window of 20 ``micro_grand`` calls holds
(``chip_smoke._micro_call_stages``).  This script reads ``WINDOWS``
(default 20) such windows at m2 and at m3 on the same inputs
(``kernels_micro.micro_inputs``), in two ways:

- ``cold``: the profiler started on an idle card, then the 20 calls, as
  phase 11 reads them;
- ``warm``: ``torch.profiler.schedule(wait=0, warmup=1, active=1)``: one
  step of 20 calls with the profiler prepared but not recording, then the
  20 calls that are read.

For each window with a call incomplete it prints the calls complete, the index of the first
complete call (the incomplete ones before it are a prefix), each K15
kernel's launches in the trace against the 20 calls' own, and the names of
the CUDA events that are no K15 kernel.  Launches missing from the trace
show as a kind below its due; calls split wrongly show as every kind at
its due with calls incomplete.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import collections
import json
import os
import sys


def _window(fn, level, nl, reps, warm):
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    kw = {"schedule": schedule(wait=0, warmup=1, active=1)} if warm else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        for step in range(2 if warm else 1):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            if warm and step == 0:
                prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    trace = sorted((e for e in prof.events() if e.device_type == cuda), key=lambda e: e.time_range.start)
    pairs = [(e.name, e.time_range.elapsed_us()) for e in trace]
    kinds = [next((k for k, t in cs.MICRO_KERNELS.items() if t(name)), None) for name, _ in pairs]
    _, calls = cs._micro_call_stages(pairs, level, nl)
    want = ["gates", "transpose", "transpose"] + (["row", "row", "product"] + (["outer"] if level == 3 else [])) * nl
    firsts = [i for i in range(len(kinds)) if kinds[i] == "gates" and kinds[i:i + len(want)] == want]
    due = collections.Counter(want)
    seen = collections.Counter(k for k in kinds if k)
    return {
        "complete": calls,
        "first_complete_call": (kinds[:firsts[0]].count("gates") if firsts else None),
        "launches": {k: [seen.get(k, 0), reps * due[k]] for k in due},
        "other": sorted({name for (name, _), k in zip(pairs, kinds) if k is None}),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("micro_trace: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    windows = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    reps = 20
    card = cs._card()
    args = km.micro_inputs(torch.device("cuda"))
    nl = args[0].shape[0]
    out = {}
    with torch.no_grad():
        for level in (2, 3):
            fn = lambda level=level: km.micro_grand(level, *args)  # noqa: E731
            for warm in (False, True):
                label = f"m{level} {'warm' if warm else 'cold'}"
                rows = [_window(fn, level, nl, reps, warm) for _ in range(windows)]
                for i, w in enumerate(rows):
                    if w["complete"] == reps:
                        continue
                    short = {k: v for k, v in w["launches"].items() if v[0] != v[1]}
                    print(f"{label} window {i}, {card}: {w['complete']} of {reps} calls complete, first complete "
                          f"call {w['first_complete_call']}; launches short of their due {short or 'none'}; "
                          f"other CUDA events {w['other'] or 'none'}")
                done = [w["complete"] for w in rows]
                print(f"{label}, {card}: complete calls a window min {min(done)}, max {max(done)}, "
                      f"{sum(done)} of {reps * windows}")
                out[label] = rows
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "micro_trace.json"), "w") as f:
        json.dump({"card": card, "windows": out}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
