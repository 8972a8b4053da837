"""``serve_tokens_per_s``: output tokens delivered to the caller by the
serves of the window, over the window's wall time (host clock)."""


def read(rec):
    if "serves" not in rec:
        return None
    return sum(s["tokens"] for s in rec["serves"]) / rec["window_s"]
