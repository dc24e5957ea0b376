"""``python -m repro_torch.analysis`` — the ZP-Cert gate of the port.

Runs both passes:

* boardcheck over every registered job factory (built with its default
  kwargs) and, with ``--archs``, the ``zp.train_board`` factory across
  every shipped smoke arch — no shipped board may carry an
  error-severity finding;
* racecheck over the farm control-plane sources (the port's ``farm/`` +
  ``core/schedule.py``) — any finding is a broken threading contract.

``--strict`` exits non-zero on any board error or race finding. Warnings
are printed but never gate. ``--device`` is where the factories build
their boards (the card by default, which must exist; ``cpu`` for the
host); the engines themselves only ever run on fake tensors.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys


def _default_specs(registry, device: str):
    """One JobSpec per registered factory whose params all have
    defaults (factories with required params are certified through the
    arch sweep or their own tests, not guessed at here)."""
    from repro_torch.farm.registry import JobSpec
    specs = []
    skipped = []
    for name in registry.names():
        fn = registry.get(name)
        try:
            params = inspect.signature(fn).parameters.values()
        except (TypeError, ValueError):
            skipped.append(name)
            continue
        if any(p.default is inspect.Parameter.empty
               and p.kind not in (inspect.Parameter.VAR_POSITIONAL,
                                  inspect.Parameter.VAR_KEYWORD)
               for p in params):
            skipped.append(name)
            continue
        kwargs = ({"device": device} if "device" in
                  inspect.signature(fn).parameters else {})
        specs.append(JobSpec(name=f"cert:{name}", factory=name,
                             kwargs=kwargs))
    return specs, skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="ZP-Cert: board certification + control-plane "
                    "race lint")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any error finding (CI gate)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--archs", action="store_true",
                    help="also certify zp.train_board across every "
                         "shipped smoke arch (builds each tiny model)")
    ap.add_argument("--no-boards", action="store_true",
                    help="skip boardcheck (racecheck only)")
    ap.add_argument("--no-races", action="store_true",
                    help="skip racecheck (boardcheck only)")
    ap.add_argument("--device", default=None,
                    help="where the factories build their boards (default: "
                         "the card, which must exist; 'cpu': the host)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.boardcheck import certify_spec
    from repro_torch.analysis.racecheck import check_paths, farm_sources
    from repro_torch.utils import resolve_device

    reports = []
    skipped = []
    if not args.no_boards:
        # importing the launch module registers the shipped factories
        import repro_torch.launch.farm  # noqa: F401
        from repro_torch.farm.registry import REGISTRY, JobSpec
        device = str(resolve_device(args.device))
        specs, skipped = _default_specs(REGISTRY, device)
        if args.archs:
            from repro_torch.configs import ARCH_IDS
            specs.extend(
                JobSpec(name=f"cert:zp.train_board[{arch}]",
                        factory="zp.train_board",
                        kwargs={"arch": arch, "steps": 2, "interval": 2,
                                "device": device})
                for arch in ARCH_IDS)
        for spec in specs:
            reports.append(certify_spec(spec))

    races = [] if args.no_races else check_paths(farm_sources())

    board_errors = [f for r in reports for f in r.errors]
    board_warnings = [f for r in reports for f in r.warnings]

    if args.json:
        print(json.dumps({
            "boards": {r.name: [f.as_dict() for f in r.findings]
                       for r in reports},
            "skipped_factories": skipped,
            "races": [f.as_dict() for f in races],
            "errors": len(board_errors) + len(races),
            "warnings": len(board_warnings),
        }, indent=2, sort_keys=True))
    else:
        for r in reports:
            print(r.summary())
        for name in skipped:
            print(f"{name}: skipped (factory has required params)")
        for f in races:
            print(str(f))
        print(f"zp-cert: {len(reports)} boards certified, "
              f"{len(board_errors)} board errors, "
              f"{len(board_warnings)} warnings, "
              f"{len(races)} race findings")

    if args.strict and (board_errors or races):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
