"""FlexBlock pruning and compression of live parameters."""
