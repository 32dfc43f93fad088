"""Device milliseconds of the ``sort`` and ``scan`` kernel classes (the
planner's sorts and M-sized scans) per traced block."""


def read(view):
    return view.ms_per_unit("sort", "scan")
