"""Static analysis of the port: fabric certification (deadlock freedom,
route liveness — ``analysis.fabric``) and the torch hot-path linter
(``analysis.lint_torch``).  Both run from the CLI::

    PYTHONPATH=src python -m repro_torch.analysis.fabric [--device cpu]
    PYTHONPATH=src python -m repro_torch.analysis.lint_torch \\
        src/repro_torch chip_smoke.py

Re-exports are lazy so ``python -m repro_torch.analysis.fabric`` does not
double-import the submodule (runpy warns when the package eagerly loads
the module being executed)."""

_FABRIC_API = ("CertificationError", "FabricCertificate", "PropertyResult",
               "certify", "certify_topology", "dependency_cycle",
               "require_certified", "walk_terminals")
_LINT_API = ("LintFinding", "lint_paths", "lint_source")

__all__ = list(_FABRIC_API + _LINT_API) + ["fabric", "lint_torch"]


def __getattr__(name: str):
    # importlib (not `from ... import`): a from-import re-enters this
    # __getattr__ via _handle_fromlist and would recurse.
    import importlib

    if name in _FABRIC_API or name == "fabric":
        mod = importlib.import_module("repro_torch.analysis.fabric")
        return mod if name == "fabric" else getattr(mod, name)
    if name in _LINT_API or name == "lint_torch":
        mod = importlib.import_module("repro_torch.analysis.lint_torch")
        return mod if name == "lint_torch" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
