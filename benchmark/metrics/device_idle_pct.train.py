"""The share of the measured window's wall time in which the card had no
training work: the device's busy time a step in the profiled steps (no
kernel, copy or set running, from the profiler's timeline) times the
window's steps, against the window's wall time on the host clock. The window
runs without the profiler, so its host cost does not count as idle."""


def read(m):
    if m.profile is None or m.profiled_steps == 0 or m.wall_s <= 0:
        return None
    steps = m.images / (m.micro * m.accum)
    busy = m.profile.busy_s / m.profiled_steps * steps
    return 100.0 * (1.0 - busy / m.wall_s)
