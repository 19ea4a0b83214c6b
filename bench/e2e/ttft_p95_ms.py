"""95th percentile, over every request of the window, of the time from the
call that serves the request's batch to its first token on the host.  Only
where a batch serves one token each: then the call's end is the first
token's arrival."""
import numpy as np


def value(run):
    if any(b.new != 1 for b in run.batches):
        return None
    per_request = np.repeat([(b.end_s - b.start_s) * 1e3 for b in run.batches],
                            [b.batch for b in run.batches])
    return float(np.percentile(per_request, 95))
