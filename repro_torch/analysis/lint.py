"""``python -m repro_torch.analysis.lint`` -- sweep the contract registry (twin of ``repro.analysis.lint``).

Runs two rule families and exits nonzero on any violation:

1. import-graph rules (:mod:`repro_torch.analysis.imports`), checked on
   the AST of ``repro_torch/``;
2. op contracts -- every registered entry point called at its
   representative cases (:mod:`repro_torch.analysis.cases`, the
   d % model_axis != 0 remainder meshes included), counted
   (:func:`~repro_torch.analysis.counts.count_ops`) and checked against
   its declared contracts, reporting what tripped each.

On the card (the default) the cases run on ``cuda`` and the contracts
read the kernels' launches, which must equal the wrapper calls; with
``--cpu`` they run on the CPU and read the calls.  A mesh case runs on
every rank of a spawned gloo mesh (all on one card there) and is
checked on each rank; the cases of one mesh shape share one spawn.
"""

from __future__ import annotations

import argparse
import sys

MESH_TIMEOUT = 600  # seconds one spawn may take


def _mesh_counts(names, device: str = "cuda") -> dict:
    """``{(entry, case): [OpCounts a rank]}`` of every mesh case of ``names``: one spawn a
    mesh shape, the spawns side by side (each rank's start-up is most of a spawn's time)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.analysis import cases as cases_mod
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_on_mesh

    by_shape: dict = {}
    for name in names:
        for c in cases_mod.cases_for(name):
            if c.mesh is not None:
                by_shape.setdefault(c.mesh, []).append((c.entry, c.name))
    if not by_shape:
        return {}
    if device == "cuda":
        build.build()  # once, before the spawns: each would build what is missing
    out = {}
    with ThreadPoolExecutor(len(by_shape)) as pool:
        futures = [pool.submit(run_on_mesh, cases_mod.run_mesh_cases, data, model, keys,
                               device=device, backend="gloo", timeout=MESH_TIMEOUT)
                   for (data, model), keys in sorted(by_shape.items())]
        for future in futures:
            out.update(future.result())
    return out


def _violations(contracts, counts, params) -> list:
    """Every rank's violations (one ``counts`` in process), each tagged with its rank."""
    from repro_torch.analysis import contracts as C

    if not isinstance(counts, list):
        return C.run_contracts(contracts, counts, params)
    out = []
    for rank, rank_counts in enumerate(counts):
        out.extend(v._replace(contract=f"rank {rank}: {v.contract}")
                   for v in C.run_contracts(contracts, rank_counts, params))
    return out


def run(entries=None, *, include_imports: bool = True, out=None, device: str = "cuda",
        shapes=None) -> int:
    """Sweep the registry on ``device``; return the number of failures (0 == clean).

    ``shapes``, a ``collections.Counter``, collects every counted kernel call by
    ``(kernel, *shape)``, every rank's.
    """
    from repro_torch.analysis import cases as cases_mod
    from repro_torch.analysis import contracts as C
    from repro_torch.analysis import imports as imports_mod
    from repro_torch.analysis import registry
    from repro_torch.analysis.counts import count_ops
    from repro_torch.device import require_device

    out = out or sys.stdout
    dev = require_device(device)
    failures = 0

    if include_imports:
        violations = imports_mod.structural_violations()
        status = "FAIL" if violations else "ok"
        print(f"[{status}] import-graph rules ({imports_mod.PORT_ROOT / 'repro_torch'})",
              file=out)
        if violations:
            failures += 1
            print(C.render_report(violations), file=out)

    specs = registry.registered()
    names = sorted(entries) if entries else sorted(specs)
    on_mesh = _mesh_counts([n for n in names if n in specs], dev.type)
    for name in names:
        if name not in specs:
            failures += 1
            print(f"[FAIL] {name}: not in the contract registry", file=out)
            continue
        spec = specs[name]
        entry_cases = cases_mod.cases_for(name)
        if not entry_cases:
            failures += 1
            print(f"[FAIL] {name}: no representative cases registered", file=out)
            continue
        print(f"{name} ({len(spec.contracts)} contracts)", file=out)
        for case in entry_cases:
            if case.mesh is None:
                fn, args = case.build(dev)
                _, counts = count_ops(fn, *args)
            else:
                counts = on_mesh[(case.entry, case.name)]
            if shapes is not None:
                for c in counts if isinstance(counts, list) else [counts]:
                    shapes.update(c.call_shapes)
            violations = _violations(spec.contracts, counts, case.params)
            if violations:
                failures += 1
                print(f"  [FAIL] {case.name}", file=out)
                print(C.render_report(violations, indent="    "), file=out)
            else:
                print(f"  [ok] {case.name}", file=out)
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="op-contract lint over the entry-point registry",
    )
    parser.add_argument("--cpu", action="store_true",
                        help="run the cases on the CPU (default: the card)")
    parser.add_argument("--entry", action="append", default=None,
                        help="lint only this entry (repeatable)")
    parser.add_argument("--no-imports", action="store_true",
                        help="skip the import-graph rules")
    parser.add_argument("--list", action="store_true",
                        help="list registered entries and cases, then exit")
    args = parser.parse_args(argv)

    if args.list:
        from repro_torch.analysis import cases as cases_mod
        from repro_torch.analysis import registry

        for name, spec in sorted(registry.registered().items()):
            print(f"{name} ({len(spec.contracts)} contracts)")
            for case in cases_mod.cases_for(name):
                print(f"  {case.name}")
        return 0

    failures = run(args.entry, include_imports=not args.no_imports,
                   device="cpu" if args.cpu else "cuda")
    if failures:
        print(f"\nrepro_torch.analysis.lint: {failures} FAILURE(S)")
        return 1
    print("\nrepro_torch.analysis.lint: all contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
