"""The fused tail kernel (`kernels.tail` -> csrc/filterbank.cu
`aacjax_tail`) against its roofline: the least time the card could take
for the calls at the cell's shape (portbench.roofline: bytes over the HBM
rate, or FP32 operations over the FP32 peak, whichever is larger) over
their device time, summed over the calls that ran wholly inside the
traced stretch.  Each call's input and output types come from the
kernel's template arguments as the profiler names it
(`filterbank_kernel<spec_i16, mode>`: f32 spectra after TNS, int16 ones
without; mode 0 int16 PCM, 1 f32).  The operations count the window's
share of eight-short-window frames."""
import re

from portbench import roofline
from portbench.corpus import FLAG_SHORT

_ARGS = re.compile(re.escape(roofline.TAIL_KERNEL)
                   + r"<(true|false|1|0), ?([01])>")


def read(run):
    p = run.profile
    if p is None:
        return None
    C = run.cell.traffic["streams"] * run.cell.config["channels"]
    T = run.cell.traffic["chunk_frames"]
    short = run.frame_share(FLAG_SHORT)
    bound = spent = 0.0
    for name, ds in p.whole.items():
        m = _ARGS.search(name)
        if m is None or not ds:
            continue
        i16, out16 = m[1] in ("true", "1"), m[2] == "0"
        b, _ = roofline.bound_s(roofline.tail_bytes(C, T, i16, out16),
                                roofline.tail_flops(C, T, short, i16))
        bound += b * len(ds)
        spent += sum(ds)
    return 100.0 * bound / spent if spent else None
