"""k1_window_pct.direct: device seconds of the WaveHoltz cycle kernels (K1:
the names ``k1_device_ms.setup`` matches) in % of the traced window."""

from benchmark import spec

is_k1 = spec.load_module(spec.HERE, "metrics", "k1_device_ms.setup").is_k1


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    k1_s = run.trace.seconds_in(is_k1)
    return 100.0 * k1_s / run.trace.window_s if k1_s > 0 else None
