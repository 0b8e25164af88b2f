"""Command line: ``python -m repro_torch.analysis [--lint] [--contracts]
[--kernels] [--contract NAME] [--all] [--device cpu|cuda] [paths]``.

Exit status 0 when every selected pass is clean, 1 otherwise. The
contracts run on the card unless ``--device cpu`` asks for the CPU, as the
port's entry points default; without a card the run stops with an error
that says so, and never carries on on the CPU by itself. The lint and the
kernel contracts (meta tensors) need no device.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis for the FLuID port: AST lint, "
                    "run-time contracts, kernel shape contracts.")
    ap.add_argument("--lint", action="store_true",
                    help="AST lint (host syncs in step functions, policy "
                         "registration)")
    ap.add_argument("--contracts", action="store_true",
                    help="run-time contracts (no-f64, mask-as-data, "
                         "no-host-sync, dropped-dW-zero)")
    ap.add_argument("--kernels", action="store_true",
                    help="kernel shape/grammar contracts (meta-device sweep)")
    ap.add_argument("--contract", action="append", metavar="NAME",
                    help="run only the named contract(s) (repeatable; see "
                         "analysis.contracts.CHECKS)")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when none is selected)")
    ap.add_argument("--device", default="cuda",
                    help="where the contracts run: cuda (default, the card's "
                         "kernels) or cpu (the kernels' plain versions)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs for --lint (default: src/repro_torch)")
    args = ap.parse_args(argv)

    if not (args.lint or args.contracts or args.kernels or args.contract):
        args.all = True
    problems = 0
    if args.contract or args.contracts or args.all:
        from repro_torch.analysis.contracts import resolve_device
        resolve_device(args.device)            # no card: stop before any pass runs

    if args.contract and not args.all:
        from repro_torch.analysis.contracts import run_contracts
        t0 = time.time()
        vs = run_contracts(
            progress=lambda n: print(f"[contracts] {n} ...", flush=True),
            only=args.contract, device=args.device)
        for v in vs:
            print(v)
        print(f"[contracts] {len(vs)} violation(s) "
              f"in {time.time() - t0:.1f}s")
        return 1 if vs else 0

    if args.lint or args.all:
        from repro_torch.analysis.lint import lint_paths
        t0 = time.time()
        findings = lint_paths(args.paths or ["src/repro_torch"])
        for f in findings:
            print(f)
        print(f"[lint] {len(findings)} finding(s) in {time.time() - t0:.1f}s")
        problems += len(findings)

    if args.contracts or args.all:
        from repro_torch.analysis.contracts import run_contracts
        t0 = time.time()
        vs = run_contracts(
            progress=lambda n: print(f"[contracts] {n} ...", flush=True),
            device=args.device)
        for v in vs:
            print(v)
        print(f"[contracts] {len(vs)} violation(s) "
              f"in {time.time() - t0:.1f}s")
        problems += len(vs)

    if args.kernels or args.all:
        from repro_torch.analysis.kernel_contracts import run_kernel_contracts
        t0 = time.time()
        vs = run_kernel_contracts(
            progress=lambda n: print(f"[kernels] {n} ...", flush=True))
        for v in vs:
            print(v)
        print(f"[kernels] {len(vs)} violation(s) in {time.time() - t0:.1f}s")
        problems += len(vs)

    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
