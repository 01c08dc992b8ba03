"""Host syncs a path-tracing sample as the program counts them at the
places where it waits on the card (runtime/profiler.wait: the counters
"syncs.<site>", the present's wait for its copy included), over the
samples its path tracer rendered (the counters "pt.compacted" and
"pt.full", one a sample). The counters are always on, so both cover the
whole run, warm-up and traced steps included. Read in a run on the card
(its trace holds device operations): on the CPU a wait waits on
nothing."""

from rtbench.spans import program_counters


def read(obs):
    if (not obs.pathtrace or obs.traced is None
            or not obs.traced.device_ops):
        return None
    counts = program_counters()
    if not counts:
        return None
    samples = counts.get("pt.compacted", 0) + counts.get("pt.full", 0)
    if samples <= 0:
        return None
    return sum(v for k, v in counts.items()
               if k.startswith("syncs.")) / samples
