"""Device idle a batch, in ms, in the gaps whose middle the host spent
inside the model's prefill (``serve/prefill``: the host dispatch of the
layers), over the traced window's batches (``spans.METRICS``)."""
from bench.harness.spans import read_metric


def read(run):
    return read_metric("model_idle_ms_per_batch.prefill", run)
