"""The Poseidon kernels' share of their roofline: the least time of the
permutations the traced blocks need (``reference/work.py``: counted from
the values, at the card's published IMAD peak), over the device time of
the ``poseidon`` kernel class."""

from imtbench.reference.work import least_seconds


def read(view):
    perms = view.counts.get("needed_perms")
    s = view.seconds("poseidon")
    card = view.card
    if not perms or s <= 0 or not card.get("sm_count") \
            or not card.get("clock_mhz"):
        return None
    return 100.0 * least_seconds(perms, card["sm_count"],
                                 card["clock_mhz"]) / s
