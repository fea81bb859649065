"""CLI: ``python -m repro_torch.analysis.checks`` — exit 0 iff no findings.

CI runs the bare command as a fail-fast gate.  ``--pass`` restricts to a
subset; ``--fixture`` runs the owning pass against a seeded regression
(historical bug reproduction) and therefore must exit non-zero.
``--device`` (cuda by default) is where the kernel-aliasing pass probes
the kernels: the CUDA kernels on the card, or their plain versions with
``--device cpu``; without a card, cuda is refused.
"""
from __future__ import annotations

import argparse
import sys

import torch

from . import (FIXTURE_NAMES, PASS_NAMES, render_report, run_all,
               run_fixture)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.checks",
        description="static invariant checks: kernel aliasing lint, "
                    "allocator small-scope model checker, engine/sim "
                    "mirror-drift analysis")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASS_NAMES, metavar="NAME",
                    help=f"run only this pass (repeatable; "
                         f"choices: {', '.join(PASS_NAMES)})")
    ap.add_argument("--fixture", choices=FIXTURE_NAMES, metavar="NAME",
                    help="run the owning pass against a seeded "
                         "regression fixture (expected to FAIL; "
                         f"choices: {', '.join(FIXTURE_NAMES)})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernel probes run: cuda (default, "
                         "the CUDA kernels) or cpu (their plain versions)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress progress lines (report still printed)")
    args = ap.parse_args(argv)
    if args.fixture and args.passes:
        ap.error("--fixture and --pass are mutually exclusive")
    probes = not args.fixture and "kernel-aliasing" in (args.passes
                                                        or PASS_NAMES)
    if probes and args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device for the kernel probes; pass --device cpu "
                 "to probe the plain versions")
    log = (lambda msg: None) if args.quiet else \
        (lambda msg: print(msg, file=sys.stderr))
    if args.fixture:
        findings = run_fixture(args.fixture, log=log)
    else:
        findings = run_all(args.device, args.passes, log=log)
    print(render_report(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
