"""``train_tokens_per_s``: the global batch's tokens of every round
completed in the window over the window's wall time.  Every round's
forward and backward process all ``global_batch × seq_len`` tokens,
whatever the participation mask.  The window is whole launches, each
ending in its metric read (host clock)."""


def read(rec):
    if "rounds" not in rec:
        return None
    return rec["rounds"] * rec["global_batch"] * rec["seq_len"] \
        / rec["window_s"]
