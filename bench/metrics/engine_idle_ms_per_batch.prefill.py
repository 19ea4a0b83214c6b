"""Device idle a batch, in ms, in the gaps whose middle the host spent in
the serving engine's own code (inside ``serve/generate``, outside
``serve/prefill``: cache allocation, the waits, the greedy pick, the copy
out), over the traced window's batches (``spans.METRICS``)."""
from bench.harness.spans import read_metric


def read(run):
    return read_metric("engine_idle_ms_per_batch.prefill", run)
