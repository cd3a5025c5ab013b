"""The reference's side of each field model: ``reference/fields/<field>.py``
defines ``field(params, cfg, x, d, matmul)`` (``(density [N], rgb [N,
3])``, as :func:`~nerfbench.reference.field.ngp_field`) and, where the
model trains on more than the colour's error, ``step_loss`` with the
signature of :func:`~nerfbench.reference.train.step_loss`, which the
reference's train steps then call in its place.  Plain PyTorch: nothing of
the program."""

import functools
import importlib.util
from pathlib import Path

FIELD_DIR = Path(__file__).resolve().parent


def load(field: str):
    """The module of ``field``; a field with no file raises, naming the
    file it looked for."""
    return _load(FIELD_DIR / f"{field}.py")


@functools.lru_cache(maxsize=None)
def _load(path: Path):
    if not path.is_file():
        raise LookupError(f"no reference for field {path.stem!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"{__name__}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
