"""``idle_share.serve``: the share (%) of the window's wall time in which
the device runs nothing: 1 − (device-busy time a decode step) × decode
steps / window.  The busy time a step is the union of the device's
activity intervals over the traced slice of a serve (decode steps
``traced_steps[0]`` to ``traced_steps[1]``, where the slots are full and
admissions arrive at the traffic's rate: chunks and prefills alike); the
steps and the wall time are the untraced window's, since tracing slows
the host's side and would inflate the idle time it measures.  The slice
holds a little more admission work a step than a whole serve, whose
first and last steps admit less, so the share reads low by a few
points."""


def read(rec):
    tr = rec.get("trace")
    serves = rec.get("serves", ())
    if tr is None or not serves or tr.busy_s <= 0:
        return None
    lo, hi = rec["traffic"]["traced_steps"][:2]
    steps = sum(s["decode_steps"] for s in serves)
    busy = tr.busy_s / (hi - lo) * steps
    return 100.0 * (1.0 - busy / rec["window_s"])
