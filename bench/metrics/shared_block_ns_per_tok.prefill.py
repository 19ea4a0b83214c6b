"""Device time of the kernels launched inside the span ``shared/block`` (a
zamba2 site's shared transformer block: the concatenation with the
embedding, both norms, attention, the MLP with the site's adapter, the
site's linear), in ns a prompt token of the traced window; nothing where
the run was not traced or no such span ran."""
from bench.harness.spans import ns_per_token

_READ = ns_per_token("shared/block")


def read(run):
    return None if run.spans is None else _READ(run.spans, run.counters)
