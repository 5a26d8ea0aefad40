"""CLI: ``python -m repro_torch.analysis`` — the static verification report.

Exit status 0 iff every cell it ran verifies and the repo lints are
clean, so CI can gate on it directly.  It runs the cells one process can
run: the sim, and the 1-D mesh on a process group of this process alone
(started on a ``file://`` store in a temporary directory and torn down
at the end).  It runs on the card unless ``--device cpu`` asks for the
host: NCCL for ``cuda``, gloo for ``cpu`` (``init_cluster``).  The
4-rank layouts (a 4x1 mesh, a 2x2 ``mesh2d``) need a world of four
processes; ``tests/test_torch_mesh.py`` and ``tests/test_torch_mesh2d.py``
run them.  The report says which cells ran.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="verify ledger == c10d collectives for every "
                    "registered solver")
    ap.add_argument("--methods", nargs="*", default=None,
                    help="solver subset (default: the whole registry)")
    ap.add_argument("--layouts", nargs="*", default=["sim", "mesh"],
                    choices=["sim", "mesh"],
                    help="layout subset (default: both one-process "
                         "layouts)")
    ap.add_argument("--drivers", nargs="*", default=None,
                    choices=["scan", "eager"],
                    help="driver subset (default: both)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report as JSON")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST repo lints")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from .._device import resolve_device
    from ..runtime import init_cluster
    from .verify import DRIVERS, run_analysis
    dev = resolve_device(args.device)
    layouts = tuple(args.layouts)
    with tempfile.TemporaryDirectory(prefix="repro_torch_analysis_") as tmp:
        if "mesh" in layouts:
            init_cluster(f"file://{tmp}/store", 1, 0, device=dev,
                         timeout_s=60)
        try:
            report = run_analysis(
                methods=args.methods, layouts=layouts,
                drivers=tuple(args.drivers) if args.drivers else DRIVERS,
                lint_paths=not args.no_lint, device=dev)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    print(report.render())
    rank = "NCCL" if dev.type == "cuda" else "gloo"
    print(f"cells on {dev}: {', '.join(layouts)} (mesh: one {rank} rank) x "
          f"{', '.join(args.drivers or DRIVERS)}; the 4-rank mesh and "
          f"mesh2d layouts run in tests/test_torch_mesh*.py")
    if args.json:
        report.to_json(args.json)
        print(f"report written to {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
