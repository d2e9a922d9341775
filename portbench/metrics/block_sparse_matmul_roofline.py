"""block_sparse_matmul_roofline: the block_sparse_matmul kernel's share of its roofline over the
traced window: Σ least time of its calls (``portbench/work/block_sparse_matmul.py``,
against the published peaks) over Σ the device time of the work launched
inside them, in %."""

KERNEL = "block_sparse_matmul"


def read(run):
    return run.roofline(KERNEL)
