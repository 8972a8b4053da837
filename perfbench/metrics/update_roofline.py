"""``update_roofline``: the pooled ``fused_adam_delayed`` launches' least
time (their bytes at the HBM rate: every element of a dtype's pool moves
``update_bytes_per_elem`` bytes) over their traced device time, in %.
The launches are the device kernels named ``adam_kernel``, one per dtype
pool a round."""
from perfbench.costs import kernels, peaks

_SIZE = {"bfloat16": 2, "float32": 4}


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    secs, n = tr.device_seconds(lambda name: "adam_kernel" in name)
    pools = rec["pool_elements"]
    if not n or secs <= 0 or n % len(pools):
        return None
    nbytes = sum(e * kernels.update_bytes_per_elem(
        "fused_adam_delayed", _SIZE[dk], _SIZE[dk]) for dk, e in pools.items())
    rounds = n // len(pools)
    return 100.0 * rounds * nbytes / peaks.HBM_BYTES_PER_S / secs
