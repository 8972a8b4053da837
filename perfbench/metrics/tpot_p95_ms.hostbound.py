"""``tpot_p95_ms.hostbound``: the 95th percentile, over every request of
the window's serves, of (last streamed token − first streamed token) /
(streamed tokens − 1), on the host clock of the ``on_token`` folds.

It is read beside the end-to-end metrics and not judged, for the reason
``ttft_p95_ms.hostbound.py`` gives."""
from perfbench.stats import request_p95_ms


def read(rec):
    return request_p95_ms(rec, "tpot_s")
