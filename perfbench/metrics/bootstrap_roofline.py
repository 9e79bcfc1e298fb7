"""Share of its roofline that a gate bootstrap call reaches: the least time
of the call in the int8-limb Toeplitz formulation (`perfbench.roofline`,
from the configuration's shapes, its exact torus32 key and the H100's
published peaks) over its measured device time, the median over the
window's calls, each timed by a CUDA event pair.  Read only where the
traced slice shows a kernel of that formulation: the count is not a bound
on another one."""

import statistics

from perfbench import roofline

LAYER = "bootstrap"
UNIT = "%"
MOVES = "bootstraps_per_s"


def read(r):
    if not r.call_ms or not r.rows or r.trace is None:
        return None
    if not roofline.formulation_ran(r.trace.device_ops):
        return None
    bound_s, _ = roofline.call_bound_s(r.config["tfhe"], r.rows)
    return 100.0 * bound_s * 1e3 / statistics.median(r.call_ms)
