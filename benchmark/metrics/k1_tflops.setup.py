"""k1_tflops.setup: the window's useful K1 work (the program counter
``k1.flop``: 2 * 2 * wh_maxit * nt * nnz(S) a row) over the device seconds
of the K1 kernels (the names ``k1_device_ms.setup`` matches), in TFLOP/s."""

from benchmark import spec
from benchmark.program_spans import count

is_k1 = spec.load_module(spec.HERE, "metrics", "k1_device_ms.setup").is_k1


def read(run):
    flop = count(run, "k1.flop")
    if not flop:
        return None
    k1_s = run.trace.seconds_in(is_k1)
    return flop / k1_s / 1e12 if k1_s > 0 else None
