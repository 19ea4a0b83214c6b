"""End-to-end metrics, one file each (``value(run)``), on the host clock."""
