#!/usr/bin/env python3
"""How many of a ``device_ms`` window's kernel events ``torch.profiler``
records, on one card.

    python3 scripts/torch_profiler_windows.py [--windows N]

For the mutant kernel at its audit shape (256, 1024, 8), the fp32 Gram at
the entry shape (4, 128, 256), the fused matvec + Gram at the slice shape
(12288, 200, 58), and ``torch.matmul`` / ``torch.bmm`` beside the first two,
it runs ``--windows`` windows of two kinds, in turn:

- ``lead``: the window ``chip_smoke.device_ms`` took until the leading
  kernels and the trailing pause were added: 5 warm calls, a pause, 20
  timed calls, closed as soon as the card is done; the timed calls are the
  kernels after the longest gap;
- ``device_ms``: ``chip_smoke.profiled_window`` and ``timed_events``, as
  ``device_ms`` now measures.

For each case and kind it prints one JSON line: how many windows a
``device_ms`` would accept, and a tally of what each window recorded of the
calls of ``fn`` (``"warm+timed"`` where the pause between them shows, else
the one run's length). The card's name and power limit come first. It
imports nothing of JAX or of the JAX package, needs a card, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

REPS, WARM = 20, 5


def lead_window(fn):
    """The earlier window: warm calls, a pause, the timed calls, closed at
    once; events in order of their start on the card's clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM):
            fn()
        torch.cuda.synchronize()
        time.sleep(cs.PAUSE_S)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def lead_accepts(events, launches) -> bool:
    """The earlier rule: the kernels after the longest gap, complete."""
    gaps = [events[i].time_range.start - events[i - 1].time_range.end
            for i in range(1, len(events))]
    measured = events[1 + gaps.index(max(gaps)):] if gaps else events
    per_name = collections.Counter(e.name for e in measured)
    return bool(measured) and all(n % REPS == 0 for n in per_name.values()) and (
        launches is None or len(measured) == REPS * launches)


def calls_recorded(events, names) -> str:
    """What the window holds of the calls: their kernels split at the
    pause between warm and timed calls, in calls (kernel events over the
    kernels of one call)."""
    import chip_smoke as cs

    own = [e for e in events if e.name in names]
    runs, start = [], 0
    for i in range(1, len(own) + 1):
        if i == len(own) or (own[i].time_range.start - own[i - 1].time_range.end
                             >= 0.9e6 * cs.PAUSE_S):
            runs.append((i - start) / len(names))
            start = i
    return "+".join(f"{r:g}" for r in runs) or "0"


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=30, help="windows of each kind per case")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profiler_windows: torch.cuda.is_available() is False; needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod
    from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
    from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb

    print(cs.card_line(), flush=True)
    x_m, v_m = cs.serve_operands(cs.MUTANT_AUDIT, "cuda", seed=22)
    x_g = torch.randn(cs.ENTRY, generator=torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    c, v = cs.mg_operands(cs.MG_SLICE, "cuda", seed=11)
    cases = {
        "mutant_full_block": (lambda: mfb.mutant_full_block_cuda(x_m, v_m), 1),
        "gram_f32_entry": (lambda: gram_mod.gram_cuda(x_g), 1),
        "matvec_gram_slice": (lambda: mg.matvec_gram_cuda(c, v), 1),
        "torch.matmul_mutant": (lambda: torch.matmul(x_m, v_m), None),
        "torch.bmm_entry": (lambda: torch.bmm(x_g.mT, x_g), None),
    }
    for case, (fn, launches) in cases.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the kernels of one call
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        tally = {"lead": collections.Counter(), "device_ms": collections.Counter()}
        accepted = collections.Counter()
        for _ in range(args.windows):
            events = lead_window(fn)
            tally["lead"][calls_recorded(events, names)] += 1
            accepted["lead"] += lead_accepts(events, launches)
            events = cs.profiled_window(fn, REPS, WARM)
            tally["device_ms"][calls_recorded(events, names)] += 1
            accepted["device_ms"] += cs.timed_events(events, REPS, launches)[0] is not None
        for kind in ("lead", "device_ms"):
            print(json.dumps({"case": case, "window": kind, "windows": args.windows,
                              "accepted": accepted[kind], "calls": f"{WARM}+{REPS}",
                              "recorded": dict(tally[kind].most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
