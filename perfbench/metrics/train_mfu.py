"""``train_mfu``: the configuration's model FLOPs of the window's rounds
(forward and backward of every token, no recompute;
``perfbench.costs.flops.train_round``) over the window's wall time, as a
share (%) of the card's bf16 peak."""
from perfbench.costs import flops, peaks


def read(rec):
    if not rec.get("rounds"):
        return None
    f = flops.train_round(rec["config"]["run"], rec["global_batch"],
                          rec["seq_len"])
    return 100.0 * f * rec["rounds"] / rec["window_s"] / peaks.BF16_FLOPS
