"""Launch layer of the port (counterpart of ``repro.launch``) for one card:
:mod:`.counting` (the ATen-level cost and memory analysis), :mod:`.dryrun`
(every arch x cell counted on the ``meta`` device, optionally executed),
:mod:`.roofline` (the dry-run ledger against a calibration profile) and
:mod:`.hlo_histogram` (the counted ops ranked by result bytes)."""
