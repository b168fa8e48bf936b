"""The yardstick of a kernel's roofline share: the card's published peaks
and the bytes and operations a kernel's call needs, computed from its
shape: a call's bound is max(bytes / HBM bandwidth, FP32 operations / FP32
peak), the tail's bytes and operations counted from C, T and its input
and output types.  It lives with the benchmark so that the program cannot
change the yardstick; the kernel table's timing script
(`scripts/kernel_times.py`) takes its bounds from here."""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, at the 700 W limit): HBM3 bytes/s and FP32
# FLOP/s outside the tensor cores (an FMA counts 2)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

# FP32 operations of one frame through the tail's FFT IMDCT: complex
# multiply 6, an 8-point DFT's butterflies 52.  Long: pre- and post-twiddle
# (512 each), three radix-8 passes of 64 DFTs with 7 twiddles after each of
# the first two.  Short: 8 x 64 pre- and post-twiddles, two passes, one set
# of twiddles.
FFT_FLOPS = {False: 6 * 512 * 2 + 3 * 64 * 52 + 2 * 64 * 7 * 6,
             True: 6 * 512 * 2 + 2 * 64 * 52 + 64 * 7 * 6}

# the tail's constant tables: FFT twiddles [1656, 2], the long and short
# window tables [8, 1024] each, the short rise and fall [2, 128] each, f32
TAIL_TABLE_BYTES = 4 * (1656 * 2 + 2 * 8 * 1024 + 2 * 2 * 128)

# the profiler's name of the tail kernel (csrc/filterbank.cu, entry
# aacjax_tail): the filterbank template <spec_i16, mode> in modes 0 (int16
# PCM) and 1 (f32 PCM); mode 2 is the synthesis kernel
TAIL_KERNEL = "filterbank_kernel"


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the FP32 operations over the FP32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tail_bytes(C: int, T: int, spec_i16: bool, out_int16: bool) -> int:
    """Each byte a tail call reads or writes, counted once: the spectra
    (int16 with a f32 scale per 16 bins, or f32), six int32 [C, T] index
    planes, last_valid, the overlap in and out, the tables, the PCM."""
    n = C * T
    spec = n * 1024 * 2 + n * 64 * 4 if spec_i16 else n * 1024 * 4
    return (spec + 6 * n * 4 + C * 4 + 2 * C * 1024 * 4 + TAIL_TABLE_BYTES
            + n * 1024 * (2 if out_int16 else 4))


def tail_flops(C: int, T: int, short_share: float, spec_i16: bool) -> float:
    """The FFT IMDCT of every frame (`short_share` of them eight short
    windows) and, per output sample, the decompression (int16 input), two
    windows, the add, the keep and the pack."""
    n = C * T
    per_sample = (1 if spec_i16 else 0) + 5
    return (n * ((1.0 - short_share) * FFT_FLOPS[False]
                 + short_share * FFT_FLOPS[True]) + n * 1024 * per_sample)
