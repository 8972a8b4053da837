"""``idle_share.train``: the share (%) of the window's wall time in which
the device runs nothing: 1 − (device-busy time a round) × rounds / window.
The busy time a round is the union of the device's activity intervals
over the traced launches (``round_device_ms``); the rounds and the wall
time are the untraced window's, since tracing slows the host's side of
the round and would inflate the idle time it measures."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("traced_rounds") or tr.busy_s <= 0:
        return None
    busy = tr.busy_s / rec["traced_rounds"] * rec["rounds"]
    return 100.0 * (1.0 - busy / rec["window_s"])
