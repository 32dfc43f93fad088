"""Percent of the traced sub-window in which no operation ran on the device
(100 less the union of kernels, copies and fills over the window)."""


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
