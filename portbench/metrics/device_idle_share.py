"""The device's idle share of a plain call, in percent: 1 - busy / call,
busy the union of the device's operation intervals in one profiled call
(recorded with device activity only), call the mean wall time of the
window's plain calls, which no profiler lengthens. The profiled call's own
length, and with it the profiler's overhead, is printed on standard error
and given as the result's `device.window_s`."""


def read(trace):
    profile, window = trace["profile"], trace["window"]
    if profile is None or profile["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / (window["wall_s"] / window["calls"]))
