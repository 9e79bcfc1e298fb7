"""Share of the traced slice of a gate chain in which no operation ran on
the device (`torch.profiler`, CPU and CUDA activities)."""

LAYER = "device"
UNIT = "%"
MOVES = "bootstraps_per_s"


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
