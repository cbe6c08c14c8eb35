"""qps: queries answered inside the window over the window's seconds
(closed loops)."""


def read(run):
    w = run.window
    return w.answered_in_window / (w.t_end - w.t_start)
