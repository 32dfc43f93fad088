"""Device milliseconds of the ``poseidon`` kernel class per traced block."""


def read(view):
    return view.ms_per_unit("poseidon")
