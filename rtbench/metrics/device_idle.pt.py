"""Share of a path-tracing sample's time in which no device operation
ran: 100 less the device's busy time a sample in the profiled steps (the
union of the operations' intervals) over the window's wall time a sample
(sample_ms of the same run, taken without the profiler, whose host cost
would lengthen the sample)."""


def read(obs):
    if (not obs.pathtrace or obs.traced is None or obs.traced_samples <= 0
            or obs.window_samples <= 0 or not obs.traced.device_ops):
        return None
    busy = obs.traced.busy_us() / obs.traced_samples
    return 100.0 * (1.0 - busy / (obs.window_s * 1e6 / obs.window_samples))
