"""Calibration of the port: the sample format of
``repro.calibrate.harvest`` with kernel microbenchmarks on the card
(:mod:`.harvest`), and copies of the reference's profile schema
(:mod:`.profile`) and roofline fit (:mod:`.fit`), so that a profile
fitted from the card's samples prices the port's cost model."""
