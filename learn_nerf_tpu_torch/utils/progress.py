"""Progress bars for long host-side loops (the port's own copy of
``learn_nerf_tpu.utils.progress``): tqdm where it is installed, the plain
iterable where it is not."""

from typing import Iterable, Optional


def progress(iterable: Iterable, desc: Optional[str] = None, total=None):
    try:
        from tqdm import tqdm
    except ImportError:  # a plain passthrough keeps the scripts working
        return iterable
    return tqdm(iterable, desc=desc, total=total)
