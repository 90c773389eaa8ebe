"""k1_ms_per_launch.direct: device milliseconds of the WaveHoltz cycle kernels
(K1: the names ``k1_device_ms.setup`` matches) over the window's K1 launches
(the program counters ``k1.launches.<route key>``, summed)."""

from benchmark import spec
from benchmark.program_spans import recording

is_k1 = spec.load_module(spec.HERE, "metrics", "k1_device_ms.setup").is_k1


def read(run):
    rec = recording(run)
    if rec is None:
        return None
    launches = sum(n for name, n in rec.counts.items() if name.startswith("k1.launches."))
    k1_s = run.trace.seconds_in(is_k1)
    return 1e3 * k1_s / launches if launches and k1_s > 0 else None
