"""Synchronizing operations a path-tracing sample, as torch's sync debug
mode reports them over a few steps (the present's own wait for its copy
is an event wait and not one of them)."""


def read(obs):
    if not obs.pathtrace or obs.sync_samples <= 0:
        return None
    return obs.syncs / obs.sync_samples
