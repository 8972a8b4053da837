"""``ttft_p95_ms.hostbound``: the 95th percentile, over every request of
the window's serves, of the time to the first streamed token.

Both ends are host times observed through the serve's own ``on_token``
stream, which the program calls as it folds each decode chunk's tokens.
The request's start is the moment the serve's decode-step clock reached
its arrival step: the first fold of the last decode step before the
arrival step (the step before it has been observed done), or the serve's
start when no step before it was folded.  Its end is the fold of its
first streamed token.  The prefill's own first token is not streamed by
the program, so the first streamed token is the first decoded one.

It is read beside the end-to-end metrics and not judged: in the cells
that report it the host paces the serve's admissions (the device idles
more than half of a traced window), and the tail swings with the host's
load by more than half of any bound that could show a gain."""
from perfbench.stats import request_p95_ms


def read(rec):
    return request_p95_ms(rec, "ttft_s")
