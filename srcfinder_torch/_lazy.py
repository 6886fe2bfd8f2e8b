"""Package names loaded on first use (PEP 562), for the port's subpackages:
a process imports the modules whose names it uses, and torch only where
one of them runs on the device."""

import importlib
import sys


def lazy_names(package: str, names: dict):
    """``(__getattr__, __dir__, __all__)`` for ``package``, whose public
    names live in its modules: ``names`` maps a module to the names it
    gives the package. A name, or a module by its own name, imports its
    module at first use and is then kept in the package's namespace."""
    module_of = {name: mod for mod, ns in names.items() for name in ns}
    namespace = sys.modules[package].__dict__

    def __getattr__(name):
        if name in module_of:
            value = getattr(importlib.import_module(f"{package}.{module_of[name]}"), name)
        elif name in names:
            value = importlib.import_module(f"{package}.{name}")
        else:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(module_of) | set(names))

    return __getattr__, __dir__, list(module_of)
