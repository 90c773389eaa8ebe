"""k1_device_ms.setup: device milliseconds of the WaveHoltz cycle kernels (K1)
per new model, from the trace.  The kernels are matched by the benchmark's
own list of their names, whichever variant the program picks."""

K1_KERNELS = ("wave_cycle_kernel", "wave_cycle_sparse_kernel", "wave_cycle_mma_kernel",
              "wave_cycle_streamed_kernel")


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_KERNELS)


def read(run):
    if run.trace is None or not run.requests:
        return None
    k1_s = run.trace.seconds_in(is_k1)
    return 1e3 * k1_s / len(run.requests) if k1_s > 0 else None
