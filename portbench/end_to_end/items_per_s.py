"""items_per_s: every item (here a codeword) decoded in the window over the
window's seconds, host clock, closed loop with one caller."""


def read(w):
    return w.items / w.window_s
