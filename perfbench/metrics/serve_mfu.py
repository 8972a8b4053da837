"""``serve_mfu``: the model FLOPs of every request the window's serves
finished — its prompt's prefill (last position unembedded) and each
decoded token at its position (``perfbench.costs.flops``) — over the
window's wall time, as a share (%) of the card's bf16 peak.  Slots that
decode nothing are not counted."""
from perfbench.costs import flops, peaks


def read(rec):
    serves = rec.get("serves", ())
    if not serves:
        return None
    r, t = rec["config"]["run"], rec["traffic"]
    P, T = t["prompt_len"], t["max_new"]
    per = flops.sequence_forward(r, P, unembed_all=False) + sum(
        flops.decode_token(r, pos) for pos in range(P, P + T - 1))
    done = sum(s["requests"] - s["failed"] for s in serves)
    return 100.0 * per * done / rec["window_s"] / peaks.BF16_FLOPS
