"""Share of kernel K1's roofline: its least time at the published peaks
(rtbench/roofline/K1.py, rtbench/peaks.json) over its device time in
the trace, per frame or per sample."""

from rtbench.roofline import K1, share


def read(obs):
    return share(obs, K1)
