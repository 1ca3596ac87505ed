"""Operations and bytes of the port's kernels, and the card's peaks: the
yardstick of the roofline metrics, copied from ``chip_smoke.py`` so that
no later change to the program moves it."""
