"""The bytes a coset low-degree extension must move: each column of N
64-bit elements read once, each extended column of blowup N written once,
and the coset table shift^i (N elements) read once a call; the columns are
those a call holds, at most the configuration's ``batch_max``."""


def bytes_per_call(config, mix):
    n, b = config["n"], config["blowup"]
    cols = min(mix["batch"], config["batch_max"])
    return cols * (n * 8 + b * n * 8) + n * 8
