"""Measurement tools of the port: the float64 oracle of the reference chain
(``oracle``) and the per-stage SNR ladder against it (``snr_ladder``)."""
