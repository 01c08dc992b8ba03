"""Host time of Renderer.render() a path-tracing sample, less its waits
on the card (the sample's host syncs): in the profiled steps, the
harness's span around the program's entry less the CUDA runtime calls
inside it that may wait for the device (trace.WAITS), over the samples
those steps added. The profiler's own cost per operation is in it."""


def read(obs):
    if not obs.pathtrace or obs.traced is None or obs.traced_samples <= 0:
        return None
    length, waiting = obs.traced.span_us("rtbench.render")
    if length <= 0:
        return None
    return (length - waiting) / 1e3 / obs.traced_samples
