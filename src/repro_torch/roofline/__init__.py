"""Roofline terms, kernel work formulas and the per-device cost count of
the port (the reference's `roofline/`, on H100 terms). `kernels` is pure
Python and the kernel wrappers import it; `analysis` and `count` load on
first use, so `import repro_torch` never pays for them."""

_LAZY = ("analysis", "count", "kernels")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.roofline.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'repro_torch.roofline' has no attribute {name!r}")


__all__ = list(_LAZY)
