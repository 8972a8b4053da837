"""``decode_device_ms_per_step``: device milliseconds a decode step —
the program's own CUDA-event span around each chunk replay
(``ServeResult.chunk_device_ms``), summed over the window's serves, over
their decode steps."""


def read(rec):
    serves = rec.get("serves", ())
    if not serves or any(s["chunk_device_ms"] is None for s in serves):
        return None
    steps = sum(s["decode_steps"] for s in serves)
    return sum(s["chunk_device_ms"] for s in serves) / steps if steps \
        else None
