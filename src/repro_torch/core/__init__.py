"""FlexBlock specs and FullBlock pruning of the port."""
