"""``ssd_roofline``: the least time of the traced SSD chunk calls over
their traced device time, in %.  Every call is an admission's prefill
Mamba2 layer at (1, prompt / chunk, chunk, SSM heads, head dim), state N,
bf16 (``perfbench.costs.kernels.ssd_cost``); the calls are the device
kernels named ``ssd_``, a whole number of admissions (one call a Mamba2
layer), or nothing is read."""
from perfbench.costs import flops, kernels, peaks


def read(rec):
    tr = rec.get("trace")
    r = rec["config"]["run"]
    if tr is None or not flops.ssd_layers(r):
        return None
    secs, n = tr.device_seconds(lambda name: "ssd_" in name)
    if not n or secs <= 0 or n % flops.ssd_layers(r):
        return None
    P, c = rec["traffic"]["prompt_len"], r["ssm_chunk"]
    H = r["ssm_expand"] * r["d_model"] // r["ssm_head_dim"]
    f, b = kernels.ssd_cost(1, P // c, c, H, r["ssm_head_dim"],
                            r["ssm_state"])
    return 100.0 * n * peaks.bound_s(f, b) / secs
