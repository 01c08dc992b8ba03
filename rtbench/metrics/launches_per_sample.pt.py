"""Device operations a path-tracing sample (kernels, copies and fills)
in the torch.profiler trace of the traced steps, present included."""


def read(obs):
    if (not obs.pathtrace or obs.traced is None or obs.traced_samples <= 0
            or not obs.traced.device_ops):
        return None
    return len(obs.traced.device_ops) / obs.traced_samples
