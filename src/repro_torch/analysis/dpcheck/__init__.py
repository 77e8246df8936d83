"""dpcheck on the port — DP-invariant static analyzer + runtime sanitizer.

Static half: ``python -m repro_torch.analysis.dpcheck [paths]`` runs the
DPC1xx (PRNG key discipline, the kernel entry points included), DPC2xx
(host syncs in the round loops), DPC3xx (clip-before-noise, masked bank
writes) and DPC4xx (kernel layout) rule families over the port. Runtime
half: ``with dpcheck.sanitize(): ...`` wraps the ``repro_torch.random``
samplers and hears the CUDA kernels' own draws, recording the counters
each key gives out and raising on reuse.
"""
from repro_torch.analysis.dpcheck.core import (RULE_DOCS, Violation, filter_new,
                                               load_baseline, run, write_baseline)

__all__ = ["RULE_DOCS", "Violation", "run", "load_baseline",
           "write_baseline", "filter_new", "sanitize", "KeyReuseError"]


def __getattr__(name):
    # The runtime half imports torch; the static half (and the CLI) need
    # only the standard library. PEP 562 keeps the import lazy.
    if name in ("sanitize", "KeyReuseError"):
        import importlib
        mod = importlib.import_module("repro_torch.analysis.dpcheck._sanitize")
        globals()["sanitize"] = mod.sanitize
        globals()["KeyReuseError"] = mod.KeyReuseError
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
