"""``flash_roofline``: the least time of the traced flash calls over
their traced device time, in %.  Every call is an admission's prefill
attention block at (1, prompt, prompt, heads, d_head), bf16, causal
(``perfbench.costs.kernels.flash_cost``); the calls are the device
kernels named ``flash_fwd``, a whole number of admissions (one call an
attention block), or nothing is read."""
from perfbench.costs import flops, kernels, peaks


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    secs, n = tr.device_seconds(lambda name: "flash_fwd" in name)
    r, P = rec["config"]["run"], rec["traffic"]["prompt_len"]
    if not n or secs <= 0 or n % flops.attention_blocks(r):
        return None
    f, b = kernels.flash_cost(1, P, P, r["n_heads"], r["n_kv_heads"],
                              r["d_head"])
    return 100.0 * n * peaks.bound_s(f, b) / secs
