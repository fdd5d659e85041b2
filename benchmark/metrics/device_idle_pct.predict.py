"""The share of the measured window's wall time in which the card had no
serving work: the device's busy time a batch in the profiled batches (no
kernel, copy or set running, from the profiler's timeline) times the
window's batches, against the window's wall time on the host clock. The
window runs without the profiler, so its host cost does not count as
idle."""


def read(m):
    if m.profile is None or m.profiled_steps == 0 or m.wall_s <= 0:
        return None
    batches = m.images / m.micro
    busy = m.profile.busy_s / m.profiled_steps * batches
    return 100.0 * (1.0 - busy / m.wall_s)
