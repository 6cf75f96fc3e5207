"""Share of the traced window (%) in which no operation ran on the
device, over whole frames from the first one's start to the last one's
end."""


def read(run):
    tr = run.trace
    if (run.kind != "frame" or tr is None or tr.window_us <= 0
            or not tr.device_ops):
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
