"""The shared arithmetic of the kernel rooflines: a kernel's least time a
frame over its device time a frame in the traced sub-window."""


def device_s_per_frame(run, name: str):
    t = run.trace
    if t is None or run.work is None:
        return None
    s = sum(v for k, v in t.kernel_s.items() if name in k)
    return s / t.frames if s > 0 else None


def share(run, name: str, least):
    s = device_s_per_frame(run, name)
    if s is None:
        return None
    return 100.0 * least(run) / s
