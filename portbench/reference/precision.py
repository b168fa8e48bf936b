"""The reference's arithmetic precision.  `exact` leaves float64 alone;
`tf32` rounds every value it is given to TF32 (float32's exponent, 10
explicit mantissa bits, round to nearest even): the precision one step
below the configurations' float32 with TF32 off, in which the control of
the output check runs."""
from __future__ import annotations

import numpy as np


def exact(x):
    return x


def tf32(x):
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return tf32(x.real) + 1j * tf32(x.imag)
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


PRECISIONS = {"exact": exact, "tf32": tf32}
