"""k1_bound_pct.direct: K1's share of its FP32 bound, in %: the window's useful
K1 work (the program counter ``k1.flop``: 2 * 2 * wh_maxit * nt * nnz(S) a
row, whatever kernel runs) at the H100's FP32 FFMA peak of 67 TFLOP/s, over
the device seconds of the K1 kernels (the names ``k1_device_ms.setup``
matches)."""

from benchmark import spec
from benchmark.program_spans import count

is_k1 = spec.load_module(spec.HERE, "metrics", "k1_device_ms.setup").is_k1

FP32_PEAK = 67e12  # FLOP/s, FFMA outside the tensor cores (H100 SXM data sheet)


def read(run):
    flop = count(run, "k1.flop")
    if not flop:
        return None
    k1_s = run.trace.seconds_in(is_k1)
    return 100.0 * flop / FP32_PEAK / k1_s if k1_s > 0 else None
