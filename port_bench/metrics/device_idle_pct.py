"""device_idle_pct: the share of the traced period in which no operation
ran on the device, in percent."""


def read(run):
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
