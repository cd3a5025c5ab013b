"""The program's side of each field model a configuration names: its
``field`` key is the stem of a file here, ``fields/<field>.py``, which
defines ``build_model(cfg)`` (the port's module at the configuration's
widths) and ``macs(cfg)`` (multiply-adds a sample of its matrix products,
what :mod:`nerfbench.roofline` counts).  A new field is a new file."""

import importlib
from pathlib import Path

FIELD_DIR = Path(__file__).resolve().parent


def load(field: str):
    """The module of ``field``; a field with no file raises, naming the
    file it looked for."""
    path = FIELD_DIR / f"{field}.py"
    if not path.is_file():
        raise LookupError(f"no program code for field {field!r}: {path} does not exist")
    return importlib.import_module(f"{__name__}.{field}")
