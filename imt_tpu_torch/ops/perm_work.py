"""The least work of one Poseidon-BN254 permutation, and the rate it bounds.

What the kernels' bounds count (``chip_smoke.py`` phases 1 and 5) and what
``bench_torch.py``'s headline holds a measured rate against: the least
multiply-adds of a permutation among the schedules in the repo.  On 8 x
32-bit limbs a 256x256-bit product is 64 wide (32x32->64-bit)
multiply-adds, a square 36 (each cross product once, doubled by a shift),
a Montgomery reduction 64 wide and 8 32-bit ones.  An S-box x^5 is two
squares and a product, each reduced; a dot of an MDS row sums its three
products unreduced and reduces once; the 57 partial rounds take
``imt_tpu``'s sparse form with lazy column words (``permute_opt_lazy``,
``imt_tpu/ops/poseidon_opt.py:160``) at the refresh period that needs
least.  Each multiply-add counts as one IMAD at the published rate, so a
rate above ``perm_bound_per_s`` is an impossible reading, not a fast one.
"""

from __future__ import annotations

from .vpu_roofline import peak_per_s

R_F, R_P = 8, 57
PRODUCT, SQUARE, REDC_WIDE, REDC_NARROW = 64, 36, 64, 8


def least_perm_work(g: int) -> tuple:
    """(wide, 32-bit) multiply-adds of one permutation whose partial rounds
    refresh their column words every g rounds."""
    sbox_w, sbox_n = 2 * SQUARE + PRODUCT + 3 * REDC_WIDE, 3 * REDC_NARROW
    wide = R_F * 3 * (sbox_w + 3 * PRODUCT + REDC_WIDE)
    narrow = R_F * 3 * (sbox_n + REDC_NARROW)
    for start in range(0, R_P, g):
        n = min(g, R_P - start)
        # n S-boxes; row 0 at step d sums 3 + d products (m00 s, v.x and
        # the d combined terms) into one reduction; the two columns take
        # n products each and one reduction each at the refresh
        wide += n * sbox_w + sum(3 + d for d in range(n)) * PRODUCT \
            + n * REDC_WIDE + 2 * n * PRODUCT + 2 * REDC_WIDE
        narrow += n * sbox_n + n * REDC_NARROW + 2 * REDC_NARROW
    return wide, narrow


PERM_WORK = min((least_perm_work(g) for g in range(1, 12)), key=sum)


def perm_bound_per_s(sm_count: int, clock_mhz: float) -> float:
    """Permutations per second at the least work, every multiply-add one
    IMAD at the card's published IMAD rate (`sm_count` SMs at `clock_mhz`,
    the maximum SM clock)."""
    return peak_per_s("imad", sm_count, clock_mhz) / sum(PERM_WORK)
