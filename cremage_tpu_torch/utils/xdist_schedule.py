"""Replay pytest-xdist's `--dist load` schedule of the tier-1 run from one
run's per-test seconds, and count the tests that end before the run is cut.

The tier-1 command runs `pytest -n 6 --dist load` under a time limit. Under
`load` the order of the collection and the number N of collected items
decide which worker queues which tests: a few JAX tests of several minutes
each hold back every test queued behind them on their worker, so the count
at the cut moves with N even where no test got slower. This replays the
scheduler of pytest-xdist 3.x (`xdist/scheduler/load.py`) over measured
seconds: each worker first takes (N // workers) // 4 consecutive items; a
worker that ends a test with fewer queued than (left // workers) // 4 is
filled up to (left // workers) // 2, unless that test took 0.1 s or more
and two or more are still queued.

Run from the repository root, after a whole tier-1 run with `--junitxml`
(uncut, so that every test has its seconds) and a listing of the same
collection:

    pytest tests/ -q -m 'not slow' --collect-only -p no:randomly \\
        | grep '::' > collect.txt
    python3 -m cremage_tpu_torch.utils.xdist_schedule run.xml collect.txt \\
        [--cut 1470] [--start 30] [--speed 1.1] \\
        [--add-after tests/test_torch_sd3.py --add 0:40]

It prints one JSON object: the replayed wall time and the passes that end
before the cut (with every test `--speed` times as long as measured), and
with `--add a:b` the same for N grown by a..b-1 cheap items after the last
test of the named file (what a PR that adds tests there would see).
"""
from __future__ import annotations

import argparse
import heapq
import json
import sys
import xml.etree.ElementTree as ET
from typing import Dict, List, Set, Tuple


def read_junit(path: str) -> Tuple[Dict[str, float], Set[str]]:
    """-> ({node id: seconds}, {node ids skipped}) of a pytest junit XML."""
    seconds, skipped = {}, set()
    for case in ET.parse(path).getroot().iter("testcase"):
        node = (case.get("classname").replace(".", "/") + ".py::"
                + case.get("name"))
        seconds[node] = float(case.get("time"))
        if case.find("skipped") is not None:
            skipped.add(node)
    return seconds, skipped


def replay(seconds: List[float], workers: int = 6,
           start: float = 30.0) -> List[float]:
    """The time each item of the collection ends, under xdist's `load`."""
    n, sent = len(seconds), 0
    queues: List[List[int]] = [[] for _ in range(workers)]
    ends = [0.0] * n
    running: List[Tuple[float, int, int]] = []

    def send(w: int, count: int) -> None:
        nonlocal sent
        count = min(count, n - sent)
        queues[w].extend(range(sent, sent + count))
        sent += count

    def run_next(w: int, now: float) -> None:
        if queues[w]:
            i = queues[w].pop(0)
            heapq.heappush(running, (now + seconds[i], w, i))

    for w in range(workers):
        send(w, max((n // workers) // 4, 2))
        run_next(w, start)
    while running:
        now, w, i = heapq.heappop(running)
        ends[i] = now
        left = n - sent
        queued = len(queues[w])
        if left and queued < max(2, left // workers // 4) and not (
                seconds[i] >= 0.1 and queued >= 2):
            send(w, max(2, left // workers // 2) - queued)
        run_next(w, now)
    return ends


def at_cut(seconds: List[float], skipped: List[bool], cut: float,
           start: float) -> Tuple[float, int]:
    ends = replay(seconds, start=start)
    return max(ends), sum(1 for e, s in zip(ends, skipped)
                          if e <= cut and not s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("junit")
    ap.add_argument("collect")
    ap.add_argument("--cut", type=float, default=1470.0)
    ap.add_argument("--start", type=float, default=30.0,
                    help="seconds before the first test starts")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="scale every test's seconds")
    ap.add_argument("--add-after", default=None)
    ap.add_argument("--add", default=None, help="a:b, items to add")
    ap.add_argument("--add-seconds", type=float, default=0.2)
    args = ap.parse_args(argv)

    seconds, skipped = read_junit(args.junit)
    order = [line.strip() for line in open(args.collect) if "::" in line]
    missing = [node for node in order if node not in seconds]
    if missing:
        print(f"{len(missing)} collected items have no seconds, e.g. "
              f"{missing[:3]}", file=sys.stderr)
        return 1
    secs = [seconds[node] * args.speed for node in order]
    skip = [node in skipped for node in order]
    wall, passes = at_cut(secs, skip, args.cut, args.start)
    out = {"n": len(order), "wall_s": wall, "passes_at_cut": passes,
           "cut_s": args.cut, "speed": args.speed}
    if args.add:
        lo, hi = (int(x) for x in args.add.split(":"))
        after = max(i for i, node in enumerate(order)
                    if node.startswith(args.add_after + "::")) + 1
        out["added"] = {}
        for k in range(lo, hi):
            extra = [args.add_seconds * args.speed] * k
            s2 = secs[:after] + extra + secs[after:]
            k2 = skip[:after] + [False] * k + skip[after:]
            wall_k, passes_k = at_cut(s2, k2, args.cut, args.start)
            out["added"][len(order) + k] = {"wall_s": wall_k,
                                            "passes_at_cut": passes_k}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
