"""Suite driver: run every test file in its OWN fresh pytest process,
sequentially, and print one aggregate summary line.

Why not plain ``pytest tests/`` (reference analog: the eval harness gates on
one pytest invocation, tools/run_and_evaluate_gc.sh:491):

  * One process accumulates ~100 sizeable compiled XLA executables and
    eventually segfaults XLA's CPU compiler (backend_compile_and_load) near
    the end of the suite — observed in rounds 1-2.
  * xdist workers (``-n 4 --dist loadfile``) cap per-process accumulation but
    compile CONCURRENTLY; on this box (1 CPU) that is 4 processes x XLA's
    parallel LLVM codegen threads oversubscribing one core, and a worker
    segfaulted mid-compile in round 3 — the third round in a row the suite
    could not print a summary.

Per-file fresh processes remove both failure modes structurally: each file's
compiles run alone (no concurrency) and die with the process (no
accumulation). On a single CPU, sequential execution costs no wall-clock
versus oversubscribed workers.

Usage: python tests/run_suite.py [-k EXPR] [--files a,b] [extra pytest args]
Exit code 0 iff every file's pytest run exits 0.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

SUMMARY_RE = re.compile(
    r"(?:(\d+) passed)?(?:, )?(?:(\d+) skipped)?(?:, )?(?:(\d+) deselected)?"
)


def parse_counts(tail: str) -> dict:
    """Pull pass/fail/skip counts out of pytest's final summary line."""
    counts = {"passed": 0, "failed": 0, "errors": 0, "skipped": 0,
              "deselected": 0, "xfailed": 0, "xpassed": 0}
    for line in reversed(tail.splitlines()):
        hits = re.findall(
            r"(\d+) (passed|failed|error(?:s)?|skipped|deselected|xfailed|xpassed)",
            line)
        if hits:
            for n, kind in hits:
                kind = "errors" if kind.startswith("error") else kind
                counts[kind] += int(n)
            break
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-k", default=None, help="pytest -k expression")
    p.add_argument("--files", default=None,
                   help="comma list of test files (default: all tests/test_*.py)")
    p.add_argument("--timeout", type=int, default=1800,
                   help="per-file timeout seconds")
    args, extra = p.parse_known_args(argv)

    if args.files:
        files = [f if os.sep in f else os.path.join(TESTS_DIR, f)
                 for f in args.files.split(",")]
    else:
        files = sorted(
            os.path.join(TESTS_DIR, f) for f in os.listdir(TESTS_DIR)
            if f.startswith("test_") and f.endswith(".py"))

    env = dict(os.environ)

    totals = {"passed": 0, "failed": 0, "errors": 0, "skipped": 0,
              "deselected": 0, "xfailed": 0, "xpassed": 0}
    bad: list[str] = []
    t_suite = time.time()
    for path in files:
        name = os.path.basename(path)
        # NOTE: no explicit -q here — pyproject addopts already carries -q,
        # and doubling it to -qq suppresses the "N passed" summary line the
        # count parser reads (observed: every file reported 0 passed).
        cmd = [sys.executable, "-m", "pytest", path, "-p", "no:cacheprovider",
               # override any xdist addopts from pyproject: one file, one process
               "-p", "no:xdist"]
        if args.k:
            cmd += ["-k", args.k]
        cmd += extra
        t0 = time.time()
        try:
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=args.timeout)
            out = r.stdout + r.stderr
            rc = r.returncode
        except subprocess.TimeoutExpired as e:
            out = ((e.stdout or b"").decode(errors="replace") if isinstance(e.stdout, bytes)
                   else (e.stdout or "")) + "\nTIMEOUT"
            rc = 124
        dt = time.time() - t0
        counts = parse_counts(out)
        for k in totals:
            totals[k] += counts[k]
        # rc==5 (no tests collected, e.g. everything deselected by -k) is OK
        ok = rc == 0 or (rc == 5 and counts["failed"] == 0 and counts["errors"] == 0)
        status = "ok" if ok else f"FAIL rc={rc}"
        print(f"{name:40s} {status:10s} "
              f"{counts['passed']:3d} passed {counts['failed']:2d} failed "
              f"{counts['skipped']:2d} skipped  {dt:6.1f}s", flush=True)
        if not ok:
            bad.append(name)
            # show the file's failure detail immediately
            print("-" * 72)
            print(out[-8000:])
            print("-" * 72, flush=True)

    dt_suite = time.time() - t_suite
    parts = [f"{totals['passed']} passed"]
    for k in ("failed", "errors", "skipped", "deselected", "xfailed", "xpassed"):
        if totals[k]:
            parts.append(f"{totals[k]} {k}")
    print(f"== suite: {', '.join(parts)} in {dt_suite:.0f}s "
          f"({len(files)} files, fresh process each) ==")
    if bad:
        print("failing files: " + ", ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
