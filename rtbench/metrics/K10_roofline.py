"""Share of kernel K10's roofline: its least time at the published peaks
(rtbench/roofline/K10.py, rtbench/peaks.json) over its device time in
the trace, per frame or per sample."""

from rtbench.roofline import K10, share


def read(obs):
    return share(obs, K10)
