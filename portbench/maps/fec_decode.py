"""The bytes a batched decode must move: each received word read once (and
its erasure mask, where the mix has erasures), each decoded message and
its int64 error count written once."""


def bytes_per_call(config, mix):
    b, n, k, sym = mix["batch"], config["n"], config["k"], config["storage_bytes"]
    moved = b * (n * sym + k * sym + 8)
    if "erasures" in mix:
        moved += b * n  # the bool mask
    return moved
