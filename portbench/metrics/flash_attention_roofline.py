"""flash_attention_roofline: the flash_attention kernel's share of its roofline over the
traced window: Σ least time of its calls (``portbench/work/flash_attention.py``,
against the published peaks) over Σ the device time of the work launched
inside them, in %."""

KERNEL = "flash_attention"


def read(run):
    return run.roofline(KERNEL)
