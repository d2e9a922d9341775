"""intrablock_matmul_roofline: the intrablock_matmul kernel's share of its roofline over the
traced window: Σ least time of its calls (``portbench/work/intrablock_matmul.py``,
against the published peaks) over Σ the device time of the work launched
inside them, in %."""

KERNEL = "intrablock_matmul"


def read(run):
    return run.roofline(KERNEL)
