"""Per-layer metrics, one file each, read from a traced run (``read(run)``)."""
