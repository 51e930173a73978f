"""Small shared utilities (reference: miscellaneous/functions.py)."""
from __future__ import annotations

import contextlib
import os
import tempfile
from collections.abc import Iterable
from typing import Union

import numpy as np


@contextlib.contextmanager
def atomic_write(path: str, mode: str = 'wb'):
    """Open a same-directory temporary file and ``os.replace`` it into
    place only when the ``with`` body completes.

    Every resume decision in the pipeline is "does the product file
    exist" (RT FITS products, pickles, visibility sets) — so a process
    killed mid-write (timeout, OOM) must never leave a truncated file
    under the final name, or
    every later resume silently consumes it.  POSIX rename is atomic
    within a filesystem; the temp file lives next to the target to
    guarantee that.
    """
    d = os.path.dirname(os.path.abspath(path)) or '.'
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + '.',
                               suffix='.tmp')
    try:
        with os.fdopen(fd, mode) as f:
            yield f
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


_FREQ_SUFFIXES = (('Hz', 1.0), ('kHz', 1e3), ('MHz', 1e6), ('GHz', 1e9),
                  ('THz', 1e12), ('PHz', 1e15))


def is_iter(x) -> bool:
    """miscellaneous/functions.py:304-305."""
    return isinstance(x, Iterable)


def is_float(x) -> bool:
    """miscellaneous/functions.py:7-12."""
    try:
        float(x)
        return True
    except (TypeError, ValueError):
        return False


def freq_str(freq: Union[Iterable, float], fmt: str = '.0f'):
    """Human-readable frequency string(s), e.g. 6e9 -> '6GHz'
    (miscellaneous/functions.py:193-233)."""

    def one(f):
        for suffix, fac in reversed(_FREQ_SUFFIXES):
            if f >= fac:
                return f'{{:{fmt}}}{{}}'.format(f / fac, suffix)
        return f'{{:{fmt}}}{{}}'.format(f, 'Hz')

    if not isinstance(freq, Iterable):
        return one(freq)
    return [one(f) for f in freq]


def reorder_axes(data: np.ndarray, ra_axis: int, dec_axis: int,
                 axis3: Union[None, int] = None,
                 axis4: Union[None, int] = None,
                 axis3_type: Union[None, str] = None,
                 axis4_type: Union[None, str] = None) -> np.ndarray:
    """Reorder array axes into FITS order (dec slowest, then ra, with
    optional spectral/stokes axes leading) — the exact contract of
    miscellaneous/functions.py:236-301, implemented as a single transpose.

    Target order: [axis4][axis3] dec, ra  (i.e. for a 2-D image the result
    is data[dec, ra]; a 3-D cube is data[axis3, dec, ra]).
    """
    if axis4 is not None and axis3 is None:
        raise ValueError("axis4 requires axis3 (a 4th axis cannot lead "
                         "a 3-axis order)")
    current = {'ra': ra_axis, 'dec': dec_axis}
    order_back_to_front = ['ra', 'dec']
    if axis3 is not None:
        if axis3_type is None:
            raise ValueError("axis3 requires axis3_type")
        current[axis3_type] = axis3
        order_back_to_front.append(axis3_type)
        if axis4 is not None:
            if axis4_type is None:
                raise ValueError("axis4 requires axis4_type")
            current[axis4_type] = axis4
            order_back_to_front.append(axis4_type)

    # Build permutation: leading extra axes (axis4, axis3), then dec, then ra
    perm = [current[name] for name in reversed(order_back_to_front)]
    return np.transpose(np.asarray(data), perm)


def casa_imfit_file_to_dict(filename: str) -> dict:
    """Parse a CASA-imfit-style summary file into a dict
    (miscellaneous/functions.py:14-43).  Our synthobs.imfit writes the same
    format, so results remain interchangeable with the reference's."""
    data = []
    with open(filename, 'rt') as f:
        for idx, line in enumerate(f.readlines()):
            if idx in (0, 1):
                line = line.strip('#')
            vals = [v.strip() for v in line.split()]
            vals = [float(v) if is_float(v) else v for v in vals]
            if idx == 0:
                vals.insert(0, '')
            data.append(vals)

    return {param: {'units': data[0][i], 'value': data[2][i]}
            for i, param in enumerate(data[1])}
