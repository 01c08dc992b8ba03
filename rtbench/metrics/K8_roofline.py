"""Share of kernel K8's roofline: its least time at the published peaks
(rtbench/roofline/K8.py, rtbench/peaks.json) over its device time in
the trace, per frame or per sample."""

from rtbench.roofline import K8, share


def read(obs):
    return share(obs, K8)
