"""Per-layer and end-to-end metric readers, one file per metric name."""
