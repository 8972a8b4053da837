"""``round_device_ms``: device-busy milliseconds a training round — the
union of the device's activity intervals (kernels, copies, memsets) over
the traced launches, from ``torch.profiler``, over their rounds."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("traced_rounds") or tr.busy_s <= 0:
        return None
    return tr.busy_s * 1e3 / rec["traced_rounds"]
